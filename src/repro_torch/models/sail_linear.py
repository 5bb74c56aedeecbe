"""SailLinear: quantized-weight matmul dispatch (port of
``repro.models.sail_linear``).

Every weight matmul goes through ``mm(x, w)``: a plain tensor takes
``x @ w``; a ``QTensor`` takes the LUT-GEMV (the CUDA kernel for CUDA
tensors, its plain version for CPU tensors; with ``abits`` set, the
integer-activation path).  ``quantize_params`` converts a parameter tree
to the serving format; embeddings and 1-D parameters stay f32.

Single-segment policies only: one ``bits`` / ``act_bits`` for every leaf.
Per-path ``rules`` / ``allocation`` / ``act_rules`` wait for the planning
slice (ROADMAP) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.quant import (SUPPORTED_ABITS, SUPPORTED_BITS, QTensor,
                                    _uniform_codebook, nf_codebook, quantize)

__all__ = ["QTensor", "QuantPolicy", "StackedQTensor", "mm", "nf_codebook",
           "quantize_params", "map_tensors"]


def mm(x: torch.Tensor, w: Any) -> torch.Tensor:
    """x [..., K] @ w [K, N] with QTensor dispatch."""
    if isinstance(w, QTensor):
        from repro_torch.kernels.lut_gemv.ops import lut_matmul
        lead = x.shape[:-1]
        y = lut_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
        return y.reshape(*lead, w.n)
    return x @ w


@dataclasses.dataclass(frozen=True)
class StackedQTensor:
    """QTensor stacked along a leading layer axis."""
    packed: torch.Tensor      # [L, (K//G)*wpg, N] int32 bit patterns
    scales: torch.Tensor      # [L, K//G, N]
    codebook: torch.Tensor    # [L, 2**bits] (or [2**bits])
    bits: int
    group_size: int
    k: int
    abits: Optional[int] = None

    def __getitem__(self, i) -> QTensor:
        cb = self.codebook if self.codebook.ndim == 1 else self.codebook[i]
        return QTensor(packed=self.packed[i], scales=self.scales[i],
                       codebook=cb, bits=self.bits,
                       group_size=self.group_size, k=self.k,
                       abits=self.abits)

    @property
    def n(self) -> int:
        return self.packed.shape[-1]


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    bits: int = 4                  # uniform precision
    group_size: int = 128
    min_size: int = 65536          # don't quantize small tensors
    skip_embed: bool = True        # gathers can't stream through LUT-GEMV
    # None | tensor [2**bits] | callable bits -> tensor (e.g. nf_codebook)
    codebook: Optional[Any] = None
    act_bits: Optional[int] = None  # None = f32 activations
    # per-path precision (mixed policies): not ported yet
    rules: Tuple[Tuple[str, int], ...] = ()
    allocation: Optional[Any] = None
    act_rules: Tuple[Tuple[str, int], ...] = ()

    def check(self) -> None:
        if self.rules or self.allocation is not None or self.act_rules:
            raise NotImplementedError(
                "per-path rules / allocation / act_rules (mixed-precision "
                "policies) are not ported yet: ROADMAP, the planning slice")
        if isinstance(self.bits, (tuple, list)):
            raise NotImplementedError(
                "per-layer bit tuples (segmented stacks) are not ported yet: "
                "ROADMAP, the planning slice")
        if self.bits not in SUPPORTED_BITS:
            raise ValueError(f"bits must be one of {SUPPORTED_BITS}, got "
                             f"{self.bits}")
        if self.act_bits is not None and self.act_bits not in SUPPORTED_ABITS:
            raise ValueError(f"activation bits must be one of "
                             f"{SUPPORTED_ABITS} or None, got {self.act_bits}")

    def codebook_for(self, device) -> torch.Tensor:
        cb = self.codebook
        if cb is None:
            return _uniform_codebook(self.bits, device=device)
        if callable(cb):
            cb = cb(self.bits)
        if cb.shape[-1] != (1 << self.bits):
            raise ValueError(f"codebook has {cb.shape[-1]} entries, "
                             f"{1 << self.bits} needed")
        return cb.to(device=device, dtype=torch.float32)


def _should_quantize(path: str, w, policy: QuantPolicy) -> bool:
    return (isinstance(w, torch.Tensor) and w.ndim == 2
            and w.numel() >= policy.min_size
            and not (policy.skip_embed and "embed" in path)
            and w.shape[0] % policy.group_size == 0)


def _should_quantize_stacked(path: str, w, policy: QuantPolicy) -> bool:
    """Layer-stacked [L, K, N] weights."""
    return (isinstance(w, torch.Tensor) and w.ndim == 3
            and "embed" not in path
            and w.shape[-2] % policy.group_size == 0
            and w.shape[-2] * w.shape[-1] >= policy.min_size)


def _quantize_stacked(w: torch.Tensor, policy: QuantPolicy) -> StackedQTensor:
    """Quantize a stacked weight one layer at a time (bounded scratch);
    the codebook is tiled along the layer axis as the reference does."""
    codebook = policy.codebook_for(w.device)
    packed, scales = [], []
    for layer in w:
        qt = quantize(layer, policy.bits, policy.group_size, codebook)
        packed.append(qt.packed)
        scales.append(qt.scales)
    return StackedQTensor(
        packed=torch.stack(packed), scales=torch.stack(scales),
        codebook=codebook[None].repeat(w.shape[0], 1), bits=policy.bits,
        group_size=policy.group_size, k=w.shape[-2], abits=policy.act_bits)


def _walk(tree, fn: Callable[[str, Any], Any], path: str = ""):
    """Map ``fn(path, leaf)`` over a dict/list tree; paths use the
    reference's ``keystr`` form (``['blocks']['attn']['wq']``)."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, f"{path}[{k!r}]") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, f"{path}[{i}]")
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_tensors(tree, fn: Callable[[torch.Tensor], torch.Tensor]):
    """Apply ``fn`` to every tensor of a tree, QTensor fields included
    (e.g. ``map_tensors(params, lambda t: t.to("cpu"))``)."""
    def leaf(_, x):
        if isinstance(x, (QTensor, StackedQTensor)):
            return dataclasses.replace(x, packed=fn(x.packed),
                                       scales=fn(x.scales),
                                       codebook=fn(x.codebook))
        return fn(x) if isinstance(x, torch.Tensor) else x
    return _walk(tree, leaf)


def quantize_params(params, policy: QuantPolicy = QuantPolicy()):
    """Convert a parameter tree to the SAIL serving format.

    Returns (quantized tree, bytes_before, bytes_after)."""
    policy.check()
    sizes = [0, 0]

    def leaf(path, w):
        sizes[0] += w.numel() * w.element_size()
        if _should_quantize(path, w, policy):
            qt = quantize(w, policy.bits, policy.group_size,
                          codebook=policy.codebook_for(w.device))
            qt = dataclasses.replace(qt, abits=policy.act_bits)
            sizes[1] += qt.nbytes()
            return qt
        if _should_quantize_stacked(path, w, policy):
            st = _quantize_stacked(w, policy)
            sizes[1] += 4 * (st.packed.numel() + st.scales.numel())
            return st
        sizes[1] += w.numel() * w.element_size()
        return w

    out = _walk(params, leaf)
    return out, sizes[0], sizes[1]
