"""Faithful batched LUT-based GEMV (SAIL Sec. II-C / III; port of
``repro.core.lut_gemv`` as plain PyTorch).

The paper's algorithm with *exact integer semantics*: lookup tables of
weight subset-sums are built per NBW-sized group of the reduction
dimension, and activation bits are processed LSB->MSB, each bit-plane's
NBW-bit pattern indexing the LUT, with shift-and-add accumulation (Fig. 2
of the paper).  The result is bit-exact equal to the integer matmul
``x_q @ w_q`` — the oracle property the tests assert.  The serving kernel
(``repro_torch.kernels.lut_gemv``) implements the hardware-adapted
variant; this module is the algorithmic reference and the workload
generator for the SAIL cost model (``core/pattern.py`` streams its
``activation_patterns`` through the PRT simulator).

Conventions (following Fig. 2):
  * A group holds ``nbw`` consecutive reduction-dim elements.
  * LUT has ``2**nbw`` entries; bit ``j`` (LSB=j=0) of the entry index
    selects weight ``nbw-1-j`` of the group, i.e. pattern ``0b001`` selects
    the *last* weight of the group.
  * Activations may be signed (two's complement): the MSB plane carries
    weight ``-2**(abits-1)``.

Sums run in int64 and are returned as int32, the reference's type; they
agree wherever the reference's int32 sums do not overflow.
"""
from __future__ import annotations

import torch


def _pad_k(t: torch.Tensor, nbw: int, dim: int) -> torch.Tensor:
    """Zero-pad ``dim`` to a multiple of ``nbw`` (zero weights and zero
    pattern bits contribute nothing)."""
    rem = t.shape[dim] % nbw
    if rem == 0:
        return t
    shape = list(t.shape)
    shape[dim] = nbw - rem
    return torch.cat([t, torch.zeros(shape, dtype=t.dtype,
                                     device=t.device)], dim=dim)


def build_luts(w_q: torch.Tensor, nbw: int) -> torch.Tensor:
    """Weight subset-sum LUTs.

    w_q : int [K, N] quantized weights (signed codes).
    Returns int32 [K // nbw, 2**nbw, N] where
      lut[g, p, n] = sum_{j : bit_j(p) = 1} w_q[g * nbw + (nbw - 1 - j), n].
    """
    w_q = _pad_k(w_q.to(torch.int64), nbw, 0)
    k, n = w_q.shape
    groups = w_q.reshape(k // nbw, nbw, n)
    patterns = torch.arange(1 << nbw, device=w_q.device)
    # sel[p, i] = bit (nbw-1-i) of p  -> weight i of the group
    sel = (patterns[:, None] >> (nbw - 1 - torch.arange(nbw,
                                                        device=w_q.device))) & 1
    luts = (sel[None, :, :, None] * groups[:, None, :, :]).sum(dim=2)
    return luts.to(torch.int32)


def activation_patterns(x_q: torch.Tensor, nbw: int,
                        abits: int) -> torch.Tensor:
    """Decompose activations into per-bit-plane LUT indices.

    x_q : int [B, K] (signed, two's complement within ``abits``).
    Returns int32 [B, abits, K // nbw]: the NBW-bit index the DFM
    broadcasts for (batch b, bit-plane t, group g).
    """
    x_q = _pad_k(torch.as_tensor(x_q).to(torch.int64), nbw, 1)
    b, k = x_q.shape
    ux = x_q & ((1 << abits) - 1)
    planes = torch.arange(abits, device=x_q.device)
    bits = (ux[:, None, :] >> planes[None, :, None]) & 1       # [B, abits, K]
    bits = bits.reshape(b, abits, k // nbw, nbw)
    weights = 1 << (nbw - 1 - torch.arange(nbw, device=x_q.device))
    return (bits * weights).sum(dim=-1).to(torch.int32)


def _plane_shifts(abits: int, signed: bool, device) -> torch.Tensor:
    shifts = 1 << torch.arange(abits, device=device)
    if signed:
        # two's complement: MSB plane has weight -2^(abits-1)
        shifts[abits - 1] = -(1 << (abits - 1))
    return shifts


def _fetch(luts: torch.Tensor, pats: torch.Tensor) -> torch.Tensor:
    """out[b, t, g, n] = luts[g, pats[b, t, g], n] (int64)."""
    g_idx = torch.arange(luts.shape[0], device=luts.device)
    return luts.to(torch.int64)[g_idx[None, None, :], pats.to(torch.int64)]


def lut_gemv(x_q: torch.Tensor, w_q: torch.Tensor, nbw: int, abits: int = 8,
             signed: bool = True) -> torch.Tensor:
    """Batched LUT-GEMV: exact int32 ``x_q @ w_q`` via LUT + shift-add.

    x_q : int [B, K] activations, |x| < 2**(abits-1) if signed.
    w_q : int [K, N] weights.
    Returns int32 [B, N].
    """
    luts = build_luts(w_q, nbw)                        # [G, 2^nbw, N]
    pats = activation_patterns(x_q, nbw, abits)        # [B, abits, G]
    planes = _fetch(luts, pats).sum(dim=2)             # [B, abits, N]
    shifts = _plane_shifts(abits, signed, planes.device)
    return (planes * shifts[None, :, None]).sum(dim=1).to(torch.int32)


def lut_gemv_quantized(x: torch.Tensor, w_q: torch.Tensor,
                       w_scales: torch.Tensor, nbw: int, abits: int = 8,
                       group_size: int = 128) -> torch.Tensor:
    """End-to-end quantized GEMV: fp activations -> int LUT-GEMV -> dequant.

    Activations are quantized per token, the integer GEMV runs via LUTs
    with per-group partial sums, and dequantization applies
    ``scale_x * scale_w[group]`` per group before the final reduction
    (paper Fig. 3, step "CPU de-/quant").

    x        : f32 [B, K]
    w_q      : int [K, N] signed codes
    w_scales : f32 [K // group_size, N]
    Returns f32 [B, N] ~= x @ (w_q * scales-expanded).
    """
    from repro_torch.core.quant import quantize_activations
    b = x.shape[0]
    xq, xscale = quantize_activations(x, abits)
    luts = build_luts(w_q, nbw)                         # [G, 2^nbw, N]
    pats = activation_patterns(xq, nbw, abits)          # [B, abits, G]
    shifts = _plane_shifts(abits, True, luts.device)
    psums = (_fetch(luts, pats) * shifts[None, :, None, None]).sum(dim=1)
    psums = psums.to(torch.int32)                       # [B, K/nbw, N]
    # fold LUT groups into quant groups
    per_q = group_size // nbw
    gq = psums.shape[1] // per_q
    psums = psums.reshape(b, gq, per_q, -1).sum(dim=2, dtype=torch.int32)
    return torch.einsum("bgn,gn->bn", psums.to(torch.float32),
                        w_scales) * xscale


def reference_int_gemv(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Plain integer matmul oracle."""
    return (x_q.to(torch.int64)[:, :, None]
            * w_q.to(torch.int64)[None]).sum(dim=1).to(torch.int32)


# ---------------------------------------------------------------------------
# Workload statistics consumed by the cost model (cycle accounting inputs)
# ---------------------------------------------------------------------------

def lut_gemv_op_counts(batch: int, k: int, n: int, nbw: int, abits: int = 8):
    """Count the abstract operations of one batched LUT-GEMV.

    Returns a dict the cost model converts to C-SRAM cycles:
      lut_builds   : number of (group) LUT constructions  = K/nbw per N-tile
      lut_entries  : entries per LUT                       = 2^nbw
      lookups      : total LUT reads = B * abits * K/nbw
      shift_adds   : accumulations   = lookups
    """
    groups = k // nbw
    return dict(
        lut_builds=groups,
        lut_entries=1 << nbw,
        lookups=batch * abits * groups,
        shift_adds=batch * abits * groups,
        n_cols=n,
    )
