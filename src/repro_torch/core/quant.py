"""Group-wise low-bit quantization (port of ``repro.core.quant``).

Same storage format as the reference, bit for bit:

  * ``pack_bits`` / ``unpack_bits`` — field packing, ``32 // b`` codes per
    word (``values_per_word``), K zero-padded to a whole word;
  * ``pack_grouped`` / ``unpack_grouped`` — bit-contiguous group packing,
    ``ceil(b*G/32)`` words per group, codes may straddle word boundaries;
  * ``QTensor`` — packed codes + group scales + codebook, the format the
    LUT-GEMV kernel streams from device memory;
  * ``quantize`` / ``dequantize``, ``quantize_activations`` (per-token
    codes for the integer LUT-GEMV path), ``quantize_kv`` (int8 KV).

Packed words are carried as ``torch.int32`` bit patterns: PyTorch on the
CPU has no shifts on ``torch.uint32``, so shifts run on int64 copies
masked to 32 bits, and the CUDA kernels reinterpret the same words as
``uint32_t``.

Every divisor on the way to codes, scales and codebooks is a tensor on
the operand's device: torch's CUDA division by a Python scalar multiplies
by the scalar's reciprocal, one rounding off the true quotient that XLA
and torch on the CPU compute.  The divisor is filled on the device
(``new_full``), not copied from the host, so a decode step that
quantizes still captures as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.dist.sharding import tp_axis_max
from repro_torch.tree import register_dataclass

SUPPORTED_BITS = (2, 3, 4, 5, 6, 8)

# 1-bit (sign) weights are a kernel-level capability; the policy grammar
# keeps the paper's 2..8-bit ``ql`` range.
KERNEL_BITS = (1,) + SUPPORTED_BITS

# Activation precisions of the integer LUT-GEMV path (None = f32).
SUPPORTED_ABITS = (4, 6, 8)

_MASK32 = 0xFFFFFFFF


def words_per_group(bits: int, group_size: int) -> int:
    """uint32 words holding one quantization group's codes."""
    if bits not in KERNEL_BITS:
        raise ValueError(f"bits must be one of {KERNEL_BITS}, got {bits}")
    return -(-(bits * group_size) // 32)


def values_per_word(bits: int) -> int:
    """Number of b-bit codes fully contained per uint32 word."""
    if bits not in KERNEL_BITS:
        raise ValueError(f"bits must be one of {KERNEL_BITS}, got {bits}")
    return 32 // bits


def pack_bits(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned b-bit ``codes`` [K, ...] along axis 0: code j of a
    word sits at bits ``[j*b, (j+1)*b)``, K zero-padded to a multiple of
    ``values_per_word(bits)``.  Returns int32 bit patterns [ceil(K/vpw),
    ...]."""
    vpw = values_per_word(bits)
    codes = codes.to(torch.int64)
    k = codes.shape[0]
    if k % vpw != 0:
        pad = vpw - k % vpw
        codes = torch.cat([codes, codes.new_zeros((pad,) + codes.shape[1:])])
        k = codes.shape[0]
    grouped = codes.reshape((k // vpw, vpw) + codes.shape[1:]) & _MASK32
    shifts = (torch.arange(vpw, device=codes.device) * bits).reshape(
        (1, vpw) + (1,) * (codes.ndim - 1))
    # the fields are disjoint, so their sum is their bitwise or
    return _to_int32_bits((grouped << shifts).sum(dim=1) & _MASK32)


def unpack_bits(packed: torch.Tensor, bits: int,
                k: Optional[int] = None) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> int32 codes [K, ...]."""
    vpw = values_per_word(bits)
    words = packed.to(torch.int64) & _MASK32
    shifts = (torch.arange(vpw, device=packed.device) * bits).reshape(
        (1, vpw) + (1,) * (packed.ndim - 1))
    codes = (words[:, None] >> shifts) & ((1 << bits) - 1)
    out = codes.reshape((packed.shape[0] * vpw,) + tuple(packed.shape[1:]))
    if k is not None:
        out = out[:k]
    return out.to(torch.int32)


def _to_int32_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 with the same bit pattern."""
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def pack_grouped(codes: torch.Tensor, bits: int,
                 group_size: int) -> torch.Tensor:
    """Group-aligned, bit-contiguous packing.

    codes: integer [K, ...] in [0, 2**bits).  Code ``v`` of a group
    occupies stream bits ``[v*bits, (v+1)*bits)``; trailing bits are zero.
    Returns int32 bit patterns [(K//G)*wpg, ...].
    """
    k = codes.shape[0]
    if k % group_size != 0:
        raise ValueError(f"K={k} not a multiple of group_size={group_size}")
    wpg = words_per_group(bits, group_size)
    g = k // group_size
    rest = codes.shape[1:]
    grouped = codes.to(torch.int64).reshape((g, group_size) + rest)
    t = torch.arange(wpg * 32, device=codes.device)
    src, sh = t // bits, t % bits
    valid = src < group_size                   # stream bits past the last code
    src = src.clamp(max=group_size - 1)
    shape = (1, wpg * 32) + (1,) * len(rest)
    stream = (grouped[:, src] >> sh.reshape(shape)) & 1
    stream = stream * valid.reshape(shape)
    stream = stream.reshape((g, wpg, 32) + rest)
    wshifts = torch.arange(32, device=codes.device).reshape(
        (1, 1, 32) + (1,) * len(rest))
    words = (stream << wshifts).sum(dim=2)
    return _to_int32_bits(words.reshape((g * wpg,) + rest))


def unpack_grouped(packed: torch.Tensor, bits: int, group_size: int,
                   k: int) -> torch.Tensor:
    """Inverse of :func:`pack_grouped` -> int64 codes [K, ...].

    Each code is read from its word (and the next one when it straddles
    the boundary) — the same decode the CUDA kernel performs."""
    wpg = words_per_group(bits, group_size)
    g = k // group_size
    rest = packed.shape[1:]
    words = packed.to(torch.int64).reshape((g, wpg) + rest) & _MASK32
    off = torch.arange(group_size, device=packed.device) * bits
    lo_idx, sh = off // 32, off % 32
    hi_idx = torch.clamp(lo_idx + 1, max=wpg - 1)
    shape = (1, group_size) + (1,) * len(rest)
    lo = words[:, lo_idx] >> sh.reshape(shape)
    straddle = (sh + bits > 32).reshape(shape)
    hi = (words[:, hi_idx] << (32 - sh).reshape(shape)) * straddle
    codes = (lo | hi) & ((1 << bits) - 1)
    return codes.reshape((k,) + rest)


@dataclasses.dataclass(frozen=True)
class QTensor:
    """SAIL-quantized weight ``W[K, N]`` (reduction dim first).

      packed   : int32 bit patterns [(K//G)*wpg, N]
      scales   : f32 [K // G, N]
      codebook : f32 [2**bits]
      bits, group_size, k : static metadata
      abits    : activation precision this matmul serves at (None = f32)
    """
    packed: torch.Tensor
    scales: torch.Tensor
    codebook: torch.Tensor
    bits: int
    group_size: int
    k: int
    abits: Optional[int] = None

    @property
    def n(self) -> int:
        return self.packed.shape[-1]

    def nbytes(self) -> int:
        return 4 * (self.packed.numel() + self.scales.numel()
                    + self.codebook.numel())


# a tree node, as the reference's ``jax.tree_util.register_dataclass``
register_dataclass(QTensor, ("packed", "scales", "codebook"))


def _uniform_codebook(bits: int, device=None) -> torch.Tensor:
    """Symmetric uniform codebook: code q -> q - 2^(b-1), max |entry| 1."""
    if bits == 1:
        return torch.tensor([-1.0, 1.0], dtype=torch.float32, device=device)
    qmax = (1 << (bits - 1)) - 1
    grid = (torch.arange(1 << bits, dtype=torch.float32, device=device)
            - float(1 << (bits - 1)))
    return grid / grid.new_full((), float(max(qmax, 1)))


def nf_codebook(bits: int, device=None) -> torch.Tensor:
    """'NormalFloat'-style codebook: normal quantiles scaled to [-1, 1]."""
    levels = 1 << bits
    p = (np.arange(levels) + 0.5) / levels
    q = np.sqrt(2.0) * _erfinv(2 * p - 1)
    q = q / np.abs(q).max()
    return torch.tensor(q, dtype=torch.float32, device=device)


def _erfinv(x):
    """Vectorised inverse error function (Winitzki approximation, <2e-3)."""
    x = np.clip(x, -0.999999, 0.999999)
    a = 0.147
    ln1mx2 = np.log(1 - x * x)
    t1 = 2 / (np.pi * a) + ln1mx2 / 2
    return np.sign(x) * np.sqrt(np.sqrt(t1 * t1 - ln1mx2 / a) - t1)


# Elements of the [K/G, G, n, levels] distance tensor per argmin pass (an
# unsorted codebook); the columns are cut so scratch stays near 256 MB
# whatever N is (lm_head has N = 32005).  The argmin is per element, so the
# cut changes no code.
_ARGMIN_CHUNK = 1 << 26


def _nearest_codes(normed: torch.Tensor, codebook: torch.Tensor):
    """Index of the codebook entry nearest each element, the first on ties
    (the reference's argmin).  For a strictly increasing codebook (the
    uniform and NF ones) only the two entries around an element's
    insertion point can be nearest, so a binary search and one comparison
    of the same f32 distances replace the full argmin; other codebooks
    take the argmin in column chunks."""
    levels = codebook.numel()
    if levels > 1 and bool((codebook[1:] > codebook[:-1]).all()):
        i = torch.searchsorted(codebook, normed.contiguous()).clamp_(
            1, levels - 1)
        lo, hi = codebook[i - 1], codebook[i]
        return torch.where((normed - lo).abs() <= (normed - hi).abs(),
                           i - 1, i)
    k = normed.shape[0] * normed.shape[1]
    cols = max(1, _ARGMIN_CHUNK // (k * levels))
    return torch.cat([
        (normed[:, :, j:j + cols, None] - codebook).abs().argmin(dim=-1)
        for j in range(0, normed.shape[2], cols)], dim=2)


def quantize(w: torch.Tensor, bits: int, group_size: int = 128,
             codebook: Optional[torch.Tensor] = None) -> QTensor:
    """Group-wise quantization of ``w[K, N]`` along K: per-group absmax
    scale, nearest codebook entry (first index on ties)."""
    codes, scale, codebook = _group_codes(w, bits, group_size, codebook)
    return QTensor(packed=pack_grouped(codes, bits, group_size),
                   scales=scale, codebook=codebook, bits=bits,
                   group_size=group_size, k=w.shape[0])


def _group_codes(w: torch.Tensor, bits: int, group_size: int,
                 codebook: Optional[torch.Tensor]):
    """(codes [K, N], group scales [K/G, N], codebook) of ``quantize``."""
    if w.ndim != 2:
        raise ValueError(f"expected W[K, N], got shape {tuple(w.shape)}")
    k, n = w.shape
    if k % group_size != 0:
        raise ValueError(f"K={k} not a multiple of group_size={group_size}")
    if codebook is None:
        codebook = _uniform_codebook(bits, device=w.device)
    codebook = codebook.to(device=w.device, dtype=torch.float32)
    wg = w.to(torch.float32).reshape(k // group_size, group_size, n)
    scale = wg.abs().amax(dim=1)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    normed = wg / scale[:, None, :]
    return _nearest_codes(normed, codebook).reshape(k, n), scale, codebook


def fake_quantize(w: torch.Tensor, bits: int, group_size: int = 128,
                  codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``dequantize(quantize(w, ...))`` bit for bit, without packing the
    codes (the Planner's probes run it per unit and candidate)."""
    codes, scale, codebook = _group_codes(w, bits, group_size, codebook)
    k, n = codes.shape
    return _scale_codes(codebook[codes], scale, group_size, k, n)


def _scale_codes(vals: torch.Tensor, scales: torch.Tensor, group_size: int,
                 k: int, n: int) -> torch.Tensor:
    vals = vals.reshape(k // group_size, group_size, n)
    return (vals * scales[:, None, :]).reshape(k, n)


def dequantize(qt: QTensor) -> torch.Tensor:
    """Reconstruct f32 ``W[K, N]`` — the plain version every kernel is
    held against."""
    codes = unpack_grouped(qt.packed, qt.bits, qt.group_size, qt.k)
    return _scale_codes(qt.codebook[codes], qt.scales, qt.group_size, qt.k,
                        qt.n)


def quantize_int(w: torch.Tensor, bits: int, group_size: int = 128):
    """Integer-domain group-wise quantization of the bit-serial LUT-GEMV:
    (w_q int32 [K, N] signed codes in [-2^(b-1), 2^(b-1) - 1], scales f32
    [K/G, N]) with w ~= scales[g] * w_q."""
    k, n = w.shape
    qmax = (1 << (bits - 1)) - 1
    wg = w.to(torch.float32).reshape(k // group_size, group_size, n)
    absmax = wg.abs().amax(dim=1)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = absmax / absmax.new_full((), float(qmax))
    wq = torch.clamp(torch.round(wg / scale[:, None, :]), -qmax - 1, qmax)
    return wq.reshape(k, n).to(torch.int32), scale


def quantize_activations(x: torch.Tensor, bits: int = 8,
                         k_sharded: bool = False):
    """Per-token (row) symmetric activation quantization.

    x[B, K] -> (x_q int32 in [-2^(b-1)+1, 2^(b-1)-1], scale f32 [B, 1]).

    ``k_sharded``: ``x`` is this rank's K-slice of a row-parallel matmul's
    input, so under a tensor-parallel ``tp_context`` the absmax is maxed
    over the group (``dist.sharding.tp_axis_max``) and the codes and scale
    are the unsharded computation's bit for bit.  The reference maxes
    every input under TP; on a replicated input that max changes no bit,
    so the port skips its collective there."""
    qmax = (1 << (bits - 1)) - 1
    absmax = x.abs().amax(dim=-1, keepdim=True)
    if k_sharded:
        absmax = tp_axis_max(absmax)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = absmax / absmax.new_full((), float(qmax))
    xq = torch.clamp(torch.round(x / scale), -qmax, qmax).to(torch.int32)
    return xq, scale


def quantize_kv(x: torch.Tensor, axis: int = -1):
    """int8 symmetric quantization for the KV cache (per-head-dim absmax).
    Returns (int8 codes, f32 scales broadcastable against codes)."""
    absmax = x.abs().amax(dim=axis, keepdim=True)
    absmax = torch.where(absmax == 0, torch.ones_like(absmax), absmax)
    scale = absmax / absmax.new_full((), 127.0)
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale.to(torch.float32)


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    return (codes.to(torch.float32) * scale).to(dtype)
