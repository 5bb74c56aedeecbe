"""Dense decoder block (port of ``repro.models.blocks``, dense family,
ring and paged KV pools).

Layers are applied by a Python loop in ``lm``; parameters stay stacked
along a leading layer axis like the reference trees, and one layer's
slice is taken per step.  The decode step writes its token's K/V in place
(the reference's donated scatter): into the ring cache at ``position %
S``, or, in paged mode, through the lane's block table into a shared
block pool.  It then calls the decode-attention kernel at the place of the
reference's jnp ``_decode_attend`` (``blocks.py:236``): in ring mode, or
in table mode, which reads each lane's blocks through its table where the
reference gathers them into a contiguous view first (``blocks.py:191-216``).
So the f32 K/V view of an int8 cache is never built on the card.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quant import quantize_kv
from repro_torch.kernels.decode_attn.ops import decode_attention_paged, \
    decode_attention_ring
from repro_torch.kernels.decode_attn.ref import decode_attention_ring_ref
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_attention, apply_mlp, apply_norm,
                                       apply_rope, attention_init, mlp_init,
                                       norm_init)
from repro_torch.models.sail_linear import mm


def check_supported(cfg: ModelConfig) -> None:
    """The port serves tinymistral's architecture so far: a dense GQA
    decoder with RoPE, RMSNorm, SwiGLU and an untied head."""
    if (cfg.family, cfg.pos, cfg.norm, cfg.act) != (
            "dense", "rope", "rmsnorm", "swiglu") or cfg.qk_norm \
            or cfg.attention_bias or cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: only dense RoPE/RMSNorm/SwiGLU models without "
            "qk-norm, attention bias or tied embeddings are ported (ROADMAP, "
            "other families)")


def block_init(generator: torch.Generator, cfg: ModelConfig, n_layers: int,
               device=None) -> Dict[str, Any]:
    """All layers' params, stacked on a leading [n_layers] axis."""
    check_supported(cfg)
    lead = (n_layers,)
    return {"attn_norm": norm_init(cfg, lead=lead, device=device),
            "attn": attention_init(generator, cfg, lead=lead, device=device),
            "mlp_norm": norm_init(cfg, lead=lead, device=device),
            "mlp": mlp_init(generator, cfg, lead=lead, device=device)}


def block_apply_seq(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, collect_cache: bool = False):
    """Full-sequence block.  Returns (x, cache_entries)."""
    in_dtype = x.dtype
    cache = {}
    h = apply_norm(p["attn_norm"], x, cfg)
    attn_out = apply_attention(p["attn"], h, cfg, positions=positions)
    if collect_cache:
        cache["kv"] = _kv_from_seq(p["attn"], h, cfg, positions)
    x = (x + attn_out).to(in_dtype)
    h = apply_norm(p["mlp_norm"], x, cfg)
    x = (x + apply_mlp(p["mlp"], h, cfg)).to(in_dtype)
    return x, cache


def _kv_from_seq(attn_p, h: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """Recompute K/V for the prefill cache (keys stored post-RoPE)."""
    b, t, _ = h.shape
    k = mm(h, attn_p["wk"]).reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = mm(h, attn_p["wv"]).reshape(b, t, cfg.n_kv, cfg.head_dim)
    return {"k": apply_rope(k, positions, cfg), "v": v}


def block_apply_decode(p, x: torch.Tensor, cfg: ModelConfig,
                       layer_cache: Dict[str, torch.Tensor],
                       position: torch.Tensor, cache_len: int,
                       quant_kv: bool = False,
                       block_tables: Optional[torch.Tensor] = None,
                       write_at: Optional[Tuple[torch.Tensor,
                                               torch.Tensor]] = None
                       ) -> torch.Tensor:
    """One-token decode.  x [B, 1, D]; position [B] absolute positions.

    Writes this token's K/V into ``layer_cache`` (ring of ``cache_len``
    slots, updated in place) and returns x.

    ``block_tables`` [B, mbs] int32: paged mode, where ``layer_cache``'s
    K/V is a block pool [NB, BS, KV, Dh] and ``cache_len == mbs * BS``.
    The write goes through the table; attention reads through it with the
    ring validity rule (a paged lane never wraps, so slot j is valid iff
    ``max(0, p + 1 - w) <= j <= p``).  ``write_at`` goes with it:
    ``paged_slot(block_tables, position, BS)``, the same for every layer
    of a step, so the decode step computes it once."""
    in_dtype = x.dtype
    b = x.shape[0]
    h = apply_norm(p["attn_norm"], x, cfg)
    q = mm(h, p["attn"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = mm(h, p["attn"]["wk"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
    v = mm(h, p["attn"]["wv"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
    q = apply_rope(q, position[:, None], cfg)
    k = apply_rope(k, position[:, None], cfg)

    if block_tables is None:
        slot = torch.remainder(position, cache_len)
        write = lambda cache, val: _ring_write(cache, val, slot)
    else:
        phys, off = write_at
        write = lambda cache, val: _paged_write(cache, val, phys, off)
    if quant_kv:
        kq, ks = quantize_kv(k)
        vq, vs = quantize_kv(v)
        write(layer_cache["k"], kq)
        write(layer_cache["v"], vq)
        write(layer_cache["k_scale"], ks)
        write(layer_cache["v_scale"], vs)
        scales = (layer_cache["k_scale"], layer_cache["v_scale"])
    else:
        write(layer_cache["k"], k)
        write(layer_cache["v"], v)
        scales = (None, None)

    window = cfg.window if cfg.window is not None else cache_len
    qh = q.reshape(b, cfg.n_heads, cfg.head_dim).contiguous()
    if block_tables is None:
        attn = decode_attention_ring(qh, layer_cache["k"], layer_cache["v"],
                                     position.to(torch.int32), window,
                                     *scales)
    else:
        attn = decode_attention_paged(qh, layer_cache["k"], layer_cache["v"],
                                      position.to(torch.int32), block_tables,
                                      window, *scales)
    attn_out = mm(attn.reshape(b, 1, cfg.q_dim), p["attn"]["wo"])
    x = (x + attn_out).to(in_dtype)
    h = apply_norm(p["mlp_norm"], x, cfg)
    return (x + apply_mlp(p["mlp"], h, cfg)).to(in_dtype)


def _ring_write(cache: torch.Tensor, val: torch.Tensor,
                slot: torch.Tensor) -> None:
    """Write one token per lane into the ring cache, in place.

    cache [B, S, KV, D(or 1)], val [B, 1, KV, D], slot [B]: only the
    written slots are touched."""
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device), slot] = \
        val[:, 0].to(cache.dtype)


def paged_slot(block_tables: torch.Tensor, position: torch.Tensor,
               block_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(physical block, row in it) [B] of each lane's token at
    ``position`` through its block table; the logical block is clipped to
    the table, as the reference clips it."""
    logical = torch.clamp(torch.div(position, block_size,
                                    rounding_mode="floor"),
                          0, block_tables.shape[1] - 1)
    phys = torch.gather(block_tables, 1, logical[:, None].to(torch.int64))
    return phys[:, 0], torch.remainder(position, block_size)


def _paged_write(pool: torch.Tensor, val: torch.Tensor, phys: torch.Tensor,
                 off: torch.Tensor) -> None:
    """Write one token per lane into the paged block pool, in place.

    pool [NB, BS, KV, D(or 1)], val [B, 1, KV, D], phys/off [B].  Retired
    and masked lanes all point at the trash block, so destinations repeat;
    which of their values lands is unspecified on CUDA, and harmless: the
    trash block is never read through a live table.  A live lane's row is
    its own, so no live row is written twice."""
    pool[phys, off] = val[:, 0].to(pool.dtype)


def _decode_attend(q, k, v, position, cfg: ModelConfig, cache_len: int):
    """Plain version with the reference's signature: q [B, 1, H, Dh];
    k, v [B, S, KV, Dh] f32; returns [B, 1, H, Dh]."""
    b, _, hh, dh = q.shape
    window = cfg.window if cfg.window is not None else cache_len
    out = decode_attention_ring_ref(q.reshape(b, hh, dh), k, v, position,
                                    window)
    return out.reshape(b, 1, hh, dh).to(q.dtype)
