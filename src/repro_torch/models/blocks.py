"""Decoder blocks of every decoder family (port of ``repro.models.blocks``,
ring and paged KV pools): dense and MoE, hymba's hybrid block (attention
and the SSM branch in parallel, ``x + 0.5 * (attn + ssm)``) and xlstm's
super-block of ``slstm_every`` recurrent sub-layers (mLSTMs, then one
sLSTM).  Recurrent state lives in the decode cache beside the KV pool and
is updated in place; the paged pool and speculative verify are for the
attention families only, as in the reference.

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

Speculative verify (``block_apply_verify``) feeds T tokens per lane through
a layer at once: every weight matmul is one LUT-GEMV call over the B x T
rows, split as the decode step's B-row call is split, and the rest runs as
the decode step runs it, token by token (the RMSNorm's row reduction and
decode attention at ``position + t``).  So a verified row equals the decode
step's on the same cache bit for bit, and greedy speculation commits the
tokens plain decoding does.  The reference's chunk-causal composite
(``_verify_attend``) is kept as the plain version that attention is held
to.

As in the reference, only the full-sequence attention adds the attention
biases: the decode and verify steps and the prefill cache's K/V
(``_kv_from_seq``) leave them out, so the cache holds unbiased K/V while
prefill's last-token logits are biased (ROADMAP, Queue 3).  MoE layers take
``moe.apply_moe`` in place of the MLP: ``moe_mode="dense"`` in decode and
verify, the caller's mode in the full sequence.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.quant import quantize_kv
from repro_torch.dist.sharding import tp_all_reduce
from repro_torch.kernels.decode_attn.ops import decode_attention_paged, \
    decode_attention_ring
from repro_torch.kernels.decode_attn.ref import decode_attention_ring_ref
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import (apply_attention, apply_mlp, apply_norm,
                                       apply_rope, attention_init, mlp_init,
                                       norm_init, qk_norm, qk_rope)
from repro_torch.models.sail_linear import mm


def check_supported(cfg: ModelConfig) -> None:
    """The decoders this module serves: dense and MoE (RoPE, RMSNorm or
    LayerNorm, SwiGLU / GeGLU / GELU, with or without qk-norm, attention
    biases and a tied head, and a vision prefix), hymba's hybrid blocks
    and xlstm's recurrent ones (no positions).  Whisper's encoder-decoder
    goes through ``models.encdec``; the reference's learned positions are
    on no config and not ported."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: family='encdec' is served by models/encdec.py "
            "(serve_prefill, serve_decode_step), not by the decoder stack")
    pos_ok = cfg.pos == ("none" if cfg.family == "ssm" else "rope")
    if cfg.family not in ("dense", "moe", "hybrid", "ssm") or not pos_ok \
            or cfg.frontend not in (None, "vision"):
        raise NotImplementedError(
            f"{cfg.name}: family={cfg.family!r}, pos={cfg.pos!r}, "
            f"frontend={cfg.frontend!r}: not a decoder the port serves")


def block_init(generator: torch.Generator, cfg: ModelConfig, n_blocks: int,
               device=None) -> Dict[str, Any]:
    """All blocks' params, stacked on a leading [n_blocks] axis (xlstm: a
    block is a super-block whose ``subs`` list holds its sub-layers)."""
    check_supported(cfg)
    lead = (n_blocks,)
    if cfg.family == "ssm":
        subs = []
        for i in range(cfg.slstm_every):
            kind, init = (("slstm", xlstm_lib.slstm_init)
                          if i == cfg.slstm_every - 1
                          else ("mlstm", xlstm_lib.mlstm_init))
            subs.append({"norm": norm_init(cfg, lead=lead, device=device),
                         kind: init(generator, cfg, lead=lead,
                                    device=device)})
        return {"subs": subs}
    p = {"attn_norm": norm_init(cfg, lead=lead, device=device),
         "attn": attention_init(generator, cfg, lead=lead, device=device),
         "mlp_norm": norm_init(cfg, lead=lead, device=device)}
    if cfg.family == "moe":
        p["moe"] = moe_lib.moe_init(generator, cfg, lead=lead, device=device)
    else:
        p["mlp"] = mlp_init(generator, cfg, lead=lead, device=device)
    if cfg.family == "hybrid":
        p["ssm_norm"] = norm_init(cfg, lead=lead, device=device)
        p["ssm"] = ssm_lib.ssm_init(generator, cfg, lead=lead, device=device)
    return p


def _recurrent_subs(p, x: torch.Tensor, cfg: ModelConfig,
                    states: Optional[Dict[str, Any]] = None,
                    collect: bool = False):
    """xlstm's super-block: each sub-layer ``x + cell(norm(x))`` in turn.
    ``states`` (decode: this block's cache entries, ``mlstm_<i>`` /
    ``slstm_<i>``) start the recurrences; with ``collect`` or ``states``
    the final states are returned by the same names."""
    in_dtype = x.dtype
    out = {}
    for i, sub in enumerate(p["subs"]):
        kind = "slstm" if "slstm" in sub else "mlstm"
        apply = (xlstm_lib.apply_slstm if kind == "slstm"
                 else xlstm_lib.apply_mlstm)
        h = apply_norm(sub["norm"], x, cfg)
        name = f"{kind}_{i}"
        if collect or states is not None:
            y, out[name] = apply(sub[kind], h, cfg,
                                 state=None if states is None
                                 else states[name], return_state=True)
        else:
            y = apply(sub[kind], h, cfg)
        x = (x + y).to(in_dtype)
    return x, out


def _store_state(dst, src) -> None:
    """Write a recurrent state (a NamedTuple of tensors) into the cache's
    views in place."""
    for d, s in zip(dst, src):
        d.copy_(s)


def _ffn(p, h: torch.Tensor, cfg: ModelConfig, moe_mode: str = "dense",
         plan_rows: Optional[int] = None):
    """The MLP, or the MoE layer in ``moe_mode``: (y, aux loss)."""
    if cfg.family == "moe":
        return moe_lib.apply_moe(p["moe"], h, cfg, mode=moe_mode)
    return apply_mlp(p["mlp"], h, cfg, plan_rows=plan_rows), 0.0


def block_apply_seq(p, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, moe_mode: str = "dispatch",
                    collect_cache: bool = False,
                    chunked_attn: bool = False):
    """Full-sequence block.  Returns (x, aux loss, cache_entries): the
    K/V under ``"kv"``, hymba's SSM state under ``"ssm"``, xlstm's states
    by sub-layer.  ``chunked_attn``: attention in the reference's chunked
    form (the training loss's)."""
    if cfg.family == "ssm":
        x, cache = _recurrent_subs(p, x, cfg, collect=collect_cache)
        return x, 0.0, cache
    in_dtype = x.dtype
    cache = {}
    h = apply_norm(p["attn_norm"], x, cfg)
    attn_out = apply_attention(p["attn"], h, cfg, positions=positions,
                               window=cfg.window, chunked=chunked_attn)
    if collect_cache:
        cache["kv"] = _kv_from_seq(p["attn"], h, cfg, positions)
    if cfg.family == "hybrid":
        hs = apply_norm(p["ssm_norm"], x, cfg)
        if collect_cache:
            ssm_out, cache["ssm"] = ssm_lib.apply_ssm(p["ssm"], hs, cfg,
                                                      return_state=True)
        else:
            ssm_out = ssm_lib.apply_ssm(p["ssm"], hs, cfg)
        x = (x + 0.5 * (attn_out + ssm_out)).to(in_dtype)
    else:
        x = (x + attn_out).to(in_dtype)
    h = apply_norm(p["mlp_norm"], x, cfg)
    y, aux = _ffn(p, h, cfg, moe_mode)
    return (x + y).to(in_dtype), aux, cache


def _kv_from_seq(attn_p, h: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    """Recompute K/V for the prefill cache (keys stored post-qk-norm and
    post-RoPE; no biases, as the reference's)."""
    b, t, _ = h.shape
    k = mm(h, attn_p["wk"]).reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = mm(h, attn_p["wv"]).reshape(b, t, cfg.n_kv, cfg.head_dim)
    if cfg.qk_norm:
        k = qk_norm(k, attn_p["k_norm"]["scale"], cfg.norm_eps)
    if cfg.pos == "rope":
        k = apply_rope(k, positions, cfg)
    return {"k": k, "v": v}


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
    of a step, so the decode step computes it once.

    Recurrent state (hymba's ``"ssm"``, xlstm's sub-layers') is read from
    ``layer_cache`` and its update written back in place, on every lane:
    a retired lane's state advances too, and a new request's prefill
    replaces it, as in the reference."""
    in_dtype = x.dtype
    b = x.shape[0]
    if cfg.family == "ssm":
        x, states = _recurrent_subs(p, x, cfg, states=layer_cache)
        for name, st in states.items():
            _store_state(layer_cache[name], st)
        return x
    h = apply_norm(p["attn_norm"], x, cfg)
    q = mm(h, p["attn"]["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
    k = mm(h, p["attn"]["wk"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
    v = mm(h, p["attn"]["wv"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
    q, k = qk_rope(p["attn"], q, k, position[:, None], cfg)

    window = cfg.window if cfg.window is not None else cache_len
    attn = write_and_attend(layer_cache, q, k, v, position, cache_len,
                            window, quant_kv, block_tables, write_at)
    attn_out = tp_all_reduce(mm(attn.reshape(b, 1, cfg.q_dim),
                                p["attn"]["wo"], k_sharded=True))
    if cfg.family == "hybrid":
        hs = apply_norm(p["ssm_norm"], x, cfg)
        ssm_out, st = ssm_lib.apply_ssm(p["ssm"], hs, cfg,
                                        state=layer_cache["ssm"],
                                        return_state=True)
        _store_state(layer_cache["ssm"], st)
        x = (x + 0.5 * (attn_out + ssm_out)).to(in_dtype)
    else:
        x = (x + attn_out).to(in_dtype)
    h = apply_norm(p["mlp_norm"], x, cfg)
    return (x + _ffn(p, h, cfg)[0]).to(in_dtype)


def write_and_attend(layer_cache: Dict[str, torch.Tensor], q: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, position: torch.Tensor,
                     cache_len: int, window: int, quant_kv: bool = False,
                     block_tables: Optional[torch.Tensor] = None,
                     write_at: Optional[Tuple[torch.Tensor,
                                             torch.Tensor]] = None
                     ) -> torch.Tensor:
    """A decode step's self-attention over one layer's cache: the token's
    K/V [B, 1, KV, Dh] (int8 codes and scales when ``quant_kv``) written in
    place at ``position % cache_len`` of the ring, or through the block
    tables at ``write_at``, then q [B, 1, H, Dh] attends over the ring (or
    the lane's blocks) through the decode-attention kernel: [B, H, Dh]."""
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
    qh = q[:, 0].contiguous()
    pos = position.to(torch.int32)
    if block_tables is None:
        return decode_attention_ring(qh, layer_cache["k"], layer_cache["v"],
                                     pos, window, *scales)
    return decode_attention_paged(qh, layer_cache["k"], layer_cache["v"],
                                  pos, block_tables, window, *scales)


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


# ---------------------------------------------------------------------------
# speculative verify (multi-token decode, cache update)
# ---------------------------------------------------------------------------

def per_token(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` on each token's [B, 1, ...] slice of x [B, T, ...], as the
    decode step calls it (a row reduction's result depends on how many
    rows one call reduces), concatenated back along T."""
    return torch.cat([fn(x[:, t:t + 1].contiguous())
                      for t in range(x.shape[1])], dim=1)


def block_apply_verify(p, x: torch.Tensor, cfg: ModelConfig,
                       layer_cache: Dict[str, torch.Tensor],
                       position: torch.Tensor, cache_len: int,
                       quant_kv: bool = False,
                       block_tables: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Multi-token decode for speculative verification.

    x [B, T, D]: the pending token and the drafts, at absolute positions
    ``position + t`` (position [B] the first one's).  Writes KV for all T
    positions into ``layer_cache`` in place, over whatever the draft left
    there, then attends chunk-causally: query t sees every cached position
    ``<= position + t`` inside the window, the tokens written by this call
    included, never the later ones.  Query t goes through decode attention
    at position ``position + t``: the ring (or the lane's table) holds no
    position past the frontier, because lanes never wrap (the engine's
    ``submit`` reserves the lookahead), so the later tokens of the chunk
    are invalid there.  Returns x.

    ``block_tables``: paged mode, as in :func:`block_apply_decode`.
    Attention families only: recurrent state cannot be rolled back to an
    accepted frontier (the engine refuses speculation for them)."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"speculative verify requires a pure-attention family, "
            f"got {cfg.family!r}")
    in_dtype = x.dtype
    b, t, _ = x.shape
    norm = lambda name, v: per_token(
        lambda r: apply_norm(p[name], r, cfg), v)
    h = norm("attn_norm", x)
    q = mm(h, p["attn"]["wq"], b).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = mm(h, p["attn"]["wk"], b).reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = mm(h, p["attn"]["wv"], b).reshape(b, t, cfg.n_kv, cfg.head_dim)
    qpos = position[:, None] + torch.arange(t, device=x.device)[None, :]
    q, k = qk_rope(p["attn"], q, k, qpos, cfg)

    if block_tables is None:
        slot = torch.remainder(qpos, cache_len)
        write = lambda cache, val: _ring_write_multi(cache, val, slot)
    else:
        bs = layer_cache["k"].shape[1]
        logical = torch.clamp(torch.div(qpos, bs, rounding_mode="floor"),
                              0, block_tables.shape[1] - 1)
        phys = torch.gather(block_tables, 1, logical.to(torch.int64))
        off = torch.remainder(qpos, bs)
        write = lambda cache, val: _paged_write_multi(cache, val, phys, off)
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
    pos = position.to(torch.int32)
    outs = []
    for j in range(t):
        qj = q[:, j].contiguous()
        if block_tables is None:
            outs.append(decode_attention_ring(
                qj, layer_cache["k"], layer_cache["v"], pos + j, window,
                *scales))
        else:
            outs.append(decode_attention_paged(
                qj, layer_cache["k"], layer_cache["v"], pos + j,
                block_tables, window, *scales))
    attn = torch.stack(outs, dim=1)
    attn_out = tp_all_reduce(mm(attn.reshape(b, t, cfg.q_dim),
                                p["attn"]["wo"], b, k_sharded=True))
    x = (x + attn_out).to(in_dtype)
    h = norm("mlp_norm", x)
    return (x + _ffn(p, h, cfg, plan_rows=b)[0]).to(in_dtype)


def _ring_write_multi(cache: torch.Tensor, val: torch.Tensor,
                      slot: torch.Tensor) -> None:
    """Write T consecutive tokens per lane into the ring cache, in place.

    cache [B, S, KV, D(or 1)], val [B, T, KV, D], slot [B, T]: distinct
    within a lane whenever T <= S (speculative lanes never wrap)."""
    b = cache.shape[0]
    cache[torch.arange(b, device=cache.device)[:, None], slot] = \
        val.to(cache.dtype)


def _paged_write_multi(pool: torch.Tensor, val: torch.Tensor,
                       phys: torch.Tensor, off: torch.Tensor) -> None:
    """Write T tokens per lane through the block tables, in place.

    pool [NB, BS, KV, D(or 1)], val [B, T, KV, D], phys/off [B, T].
    Masked lanes' tables point at the trash block, so destinations repeat
    there (which value lands is unspecified on CUDA and never read); a
    live lane's T rows were granted to it alone."""
    b, t = phys.shape
    flat = val.reshape((b * t,) + tuple(val.shape[2:]))
    pool[phys.reshape(-1), off.reshape(-1)] = flat.to(pool.dtype)


def _verify_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   position: torch.Tensor, cfg: ModelConfig,
                   cache_len: int) -> torch.Tensor:
    """The reference's chunk-causal attention of T query tokens over the
    ring cache (``blocks.py:397-428``), in plain PyTorch: the plain
    version :func:`block_apply_verify`'s per-token attention is held to.

    q [B, T, H, Dh]; k, v [B, S, KV, Dh] f32, all T tokens' KV written, so
    slot contents correspond to ``final = position + T - 1``; query t at
    ``qpos = position + t`` admits slots whose held position is in
    ``(qpos - window, qpos]``."""
    b, t, hh, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = hh // kv
    dev = q.device
    qg = q.reshape(b, t, kv, g, dh).to(torch.float32)
    scores = torch.einsum("btkgd,bskd->bkgts", qg, k.to(torch.float32))
    scores = scores / torch.sqrt(torch.tensor(float(dh)))
    slots = torch.arange(s, device=dev)[None, :]
    final = (position.to(torch.int64) + t - 1)[:, None]
    age = torch.remainder(torch.remainder(final, s) - slots, s)
    held = final - age                                   # [B, S] absolute
    qpos = position.to(torch.int64)[:, None] + torch.arange(t, device=dev)
    window = cfg.window if cfg.window is not None else cache_len
    valid = ((held[:, None, :] >= 0)
             & (held[:, None, :] <= qpos[:, :, None])
             & (held[:, None, :] > qpos[:, :, None] - window))  # [B, T, S]
    scores = scores.masked_fill(~valid[:, None, None], float("-inf"))
    prob = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bskd->btkgd", prob, v.to(torch.float32))
    return out.reshape(b, t, hh, dh).to(q.dtype)
