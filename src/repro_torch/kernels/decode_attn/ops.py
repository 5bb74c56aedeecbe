"""Public wrappers for decode attention: the CUDA kernel for CUDA tensors,
the plain version for CPU tensors.  No padding: the kernel masks the
ragged S edge."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels._build import route
from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
from repro_torch.kernels.decode_attn.ref import decode_attention_paged_ref, \
    decode_attention_ref, decode_attention_ring_ref


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None,
                     window: Optional[int] = None) -> torch.Tensor:
    """Decode-step attention over the first ``lengths[b]`` cache slots
    (the reference kernel's contract).  See ref.py."""
    if route(q) == "cuda":
        return decode_attention_cuda(q, k, v, lengths, k_scale, v_scale,
                                     window, ring=False)
    return decode_attention_ref(q, k, v, lengths, k_scale, v_scale, window)


def decode_attention_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          position: torch.Tensor, window: int,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Decode-step attention over a ring cache, slot validity from each
    lane's absolute ``position`` (the reference decode step's contract)."""
    if route(q) == "cuda":
        return decode_attention_cuda(q, k, v, position, k_scale, v_scale,
                                     window, ring=True)
    return decode_attention_ring_ref(q, k, v, position, window, k_scale,
                                     v_scale)


def decode_attention_paged(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           position: torch.Tensor, tables: torch.Tensor,
                           window: int,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Decode-step attention over a paged block pool [NB, BS, KV, D], each
    lane read through its block table [B, mbs] (the kernel's table mode):
    ring validity over the lane's mbs * BS logical slots (the reference's
    paged decode step's contract)."""
    if route(q) == "cuda":
        return decode_attention_cuda(q, k, v, position, k_scale, v_scale,
                                     window, ring=True, tables=tables)
    return decode_attention_paged_ref(q, k, v, position, tables, window,
                                      k_scale, v_scale)
