"""Plain PyTorch versions of the decode-attention kernel.

``decode_attention_ref`` is the ``lengths`` contract of the reference
oracle (``repro.kernels.decode_attn.ref``); ``decode_attention_ring_ref``
is the ring-slot contract of the reference decode step
(``repro.models.blocks._decode_attend``), with int8 K/V dequantised first
as the reference does; ``decode_attention_paged_ref`` is the paged decode
step's: the reference's gather of each lane's blocks into a contiguous
view (``repro.models.blocks``, paged branch of ``block_apply_decode``),
then the ring contract over it."""
from __future__ import annotations

import math
from typing import Optional

import torch


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None,
                         window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode attention.

    q [B, H, D]; k, v [B, S, KV, D] (f32, or int8 with scales
    [B, S, KV, 1]); lengths [B] valid cache length; window: attend to the
    last ``window`` positions only.  Returns [B, H, D].
    """
    b, h, d = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k_scale is not None:
        k = k.to(torch.float32) * k_scale
    if v_scale is not None:
        v = v.to(torch.float32) * v_scale
    k = k.to(torch.float32)
    v = v.to(torch.float32)
    qg = q.reshape(b, kv, h // kv, d).to(torch.float32)
    scores = torch.einsum("bgid,bsgd->bgis", qg, k) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)[None, :]
    lengths = lengths.to(q.device)
    valid = pos < lengths[:, None]
    if window is not None:
        valid &= pos >= (lengths[:, None] - window)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgis,bsgd->bgid", p, v)
    return out.reshape(b, h, d)


def ring_valid(position: torch.Tensor, s: int, window: int) -> torch.Tensor:
    """[B, S] bool: slot i holds absolute position ``p - ((p % S - i) % S)``
    and is valid iff that is >= 0 and inside the window."""
    slots = torch.arange(s, device=position.device)[None, :]
    pos = position.to(torch.int64)[:, None]
    age = torch.remainder(torch.remainder(pos, s) - slots, s)
    held = pos - age
    return (held >= 0) & (held > pos - window)


def decode_attention_ring_ref(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, position: torch.Tensor,
                              window: int,
                              k_scale: Optional[torch.Tensor] = None,
                              v_scale: Optional[torch.Tensor] = None
                              ) -> torch.Tensor:
    """Attention of one query token per lane over the ring cache.

    q [B, H, D]; k, v [B, S, KV, D] (int8 with scales, or f32);
    position [B] absolute position of the token; window the effective
    window (the model's, else the ring size).  Returns [B, H, D] f32."""
    b, hh, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    if k_scale is not None:
        k = k.to(torch.float32) * k_scale
        v = v.to(torch.float32) * v_scale
    qg = q.reshape(b, kv, hh // kv, dh).to(torch.float32)
    scores = torch.einsum("bghd,bsgd->bghs", qg, k.to(torch.float32))
    scores = scores / math.sqrt(dh)
    valid = ring_valid(position, s, window)
    scores = scores.masked_fill(~valid[:, None, None, :], float("-inf"))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bghs,bsgd->bghd", p, v.to(torch.float32))
    return out.reshape(b, hh, dh)


def gather_blocks(pool: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """A lane's logical [B, mbs * BS, ...] view of a block pool
    [NB, BS, ...] through its block table [B, mbs] (the reference's
    ``pool[block_tables].reshape(...)``).  A table on the CPU is checked:
    an entry outside [0, NB) raises ``ValueError`` (the kernel never reads
    past the pool; on the card the check would cost a sync, and a CUDA
    graph could not hold it)."""
    nb, bs = pool.shape[:2]
    if tables.device.type == "cpu" and tables.numel() and not bool(
            ((tables >= 0) & (tables < nb)).all()):
        raise ValueError(f"block table entries must lie in [0, {nb})")
    tables = tables.to(device=pool.device, dtype=torch.int64)
    b, mbs = tables.shape
    return pool[tables].reshape((b, mbs * bs) + tuple(pool.shape[2:]))


def decode_attention_paged_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, position: torch.Tensor,
                               tables: torch.Tensor, window: int,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Attention of one query token per lane over a paged block pool.

    q [B, H, D]; k, v [NB, BS, KV, D] (int8 with scales [NB, BS, KV, 1], or
    f32); tables int32 [B, mbs] each lane's physical blocks; position [B];
    window the effective window (the model's, else mbs * BS).  Each lane's
    blocks are gathered into a contiguous view and attended over with ring
    validity (a paged lane never wraps).  Returns [B, H, D] f32."""
    g = lambda a: None if a is None else gather_blocks(a, tables)
    return decode_attention_ring_ref(q, g(k), g(v), position, window,
                                     g(k_scale), g(v_scale))
