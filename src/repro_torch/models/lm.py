"""Causal language model (port of ``repro.models.lm``, ring and paged KV
pools): init, the full-sequence forward, the training loss
(``loss_fn``, ``chunked_nll``), prefill, decode, and speculative
decoding's k-step draft and multi-token verify.

Every decoder family: dense, MoE, hymba's hybrid blocks (a KV pool plus
per-lane SSM state) and xlstm's recurrent super-blocks (state only; the
cache has no KV, ``n_scan_blocks`` super-blocks of ``slstm_every``
layers).  Recurrent state sits in the cache as the reference's NamedTuples
of stacked ``[L, B, ...]`` tensors.  Phi-3-vision's prefix embeddings (the
stubbed CLIP patches) go ahead of the prompt's token embeddings in
``prefill`` / ``forward`` (``prefix_embeds``).

A tied head (``cfg.tie_embeddings``) has no ``lm_head``: the logits are
``x @ embed.T``, a plain product as in the reference (the embedding is
never quantized).  MoE layers run ``moe_mode="dense"`` in prefill, decode
and verify, and the forward's ``moe_mode`` (``"dispatch"`` by default,
whose aux loss it returns).

A Python loop over layers replaces the reference's ``lax.scan``; in
training each layer runs under ``remat`` when ``cfg.remat`` (the scan
body's ``jax.checkpoint``), and so does each chunk of ``chunked_nll``; the
loss's attention takes the reference's chunked form, where the serving
paths and ``forward`` take one pass over all keys.  The
parameter tree keeps the reference's layout (``blocks`` leaves stacked
on a leading layer axis, quantized leaves as ``StackedQTensor``).  A
mixed-precision tree carries ``blocks`` as a list of stacked segments
(``sail_linear.quantize_params``); ``iter_layers`` walks them back to back
and gives each layer its absolute index, which is the layer of the KV
pool it reads and writes.  The KV pool is updated in place where the
reference donates its buffers.

Entry points take ``device=`` (default ``"cuda"``) and raise when CUDA is
missing; tests pass ``device="cpu"``.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.core.quant import quantize_kv
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import dp_sum
from repro_torch.models import blocks as blk
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import xlstm as xlstm_lib
from repro_torch.models.common import ModelConfig, promote
from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.models.remat import remat
from repro_torch.models.sail_linear import mm


def n_scan_blocks(cfg: ModelConfig) -> int:
    """Blocks of the stack: xlstm's super-blocks, else one per layer."""
    if cfg.family == "ssm":
        assert cfg.n_layers % cfg.slstm_every == 0
        return cfg.n_layers // cfg.slstm_every
    return cfg.n_layers


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's distributions (truncated
    normal on +-2 sigma, 1/sqrt(fan_in), embedding scaled by
    sqrt(d_model)).  ``generator`` must live on ``device``; the numbers
    differ from the reference's ``jax.random`` ones."""
    dev = resolve_device(device)
    p = {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model),
                            fan_in=cfg.vocab, device=dev)
        * cfg.d_model ** 0.5,
        "blocks": blk.block_init(generator, cfg, n_scan_blocks(cfg),
                                 device=dev),
        "final_norm": norm_init(cfg, device=dev),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, (cfg.d_model, cfg.vocab),
                                  device=dev)
    return p


def layer_params(blocks: Dict[str, Any], i: int):
    """Layer ``i`` of one stacked block tree (QTensor for quantized
    leaves)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    if isinstance(blocks, list):
        return [layer_params(v, i) for v in blocks]
    return blocks[i]


def block_segments(params) -> List[Dict[str, Any]]:
    """params["blocks"] as a list of stacked segment trees."""
    blocks = params["blocks"]
    if isinstance(blocks, (list, tuple)):
        return list(blocks)
    return [blocks]


def _segment_len(segment) -> int:
    """Number of blocks in one stacked segment tree (its first norm's
    leading size; an xlstm super-block's norms are its sub-layers')."""
    norm = (segment["subs"][0]["norm"] if "subs" in segment
            else segment["attn_norm"])
    return norm["scale"].shape[0]


def iter_layers(params) -> Iterator[Tuple[int, Dict[str, Any]]]:
    """(absolute layer index, that layer's params) across the segments,
    in order: a segment's layer ``i`` is layer ``offset + i`` of the
    model and of its KV pool."""
    offset = 0
    for seg in block_segments(params):
        n = _segment_len(seg)
        for i in range(n):
            yield offset + i, layer_params(seg, i)
        offset += n


def n_layers(params) -> int:
    return sum(_segment_len(seg) for seg in block_segments(params))


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig,
                 prefix_embeds: Optional[torch.Tensor] = None):
    """Token embeddings [B, T, D], after ``prefix_embeds`` [B, P, D] when
    given (the vision frontend's patches): [B, P + T, D]."""
    blk.check_supported(cfg)
    x = params["embed"][tokens]
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(device=x.device, dtype=x.dtype), x],
                      dim=1)
    return x


def lm_logits(params, x: torch.Tensor, cfg: ModelConfig,
              plan_rows: Optional[int] = None) -> torch.Tensor:
    if cfg.tie_embeddings:
        x, embed = promote(x, params["embed"])
        return x @ embed.T
    return mm(x, params["lm_head"], plan_rows)


def forward(params, tokens, cfg: ModelConfig, device="cuda",
            moe_mode: str = "dispatch", prefix_embeds=None):
    """tokens [B, T] -> (logits [B, (P +) T, V], aux): the full-sequence
    causal forward with no cache (the Planner's probes run it); ``aux`` is
    the MoE layers' summed load-balancing loss (0 for a dense model)."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    x = embed_tokens(params, tokens, cfg, prefix_embeds)
    x, aux = _stack_seq(params, x, cfg, moe_mode)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, x, cfg), aux


def _stack_seq(params, x: torch.Tensor, cfg: ModelConfig, moe_mode: str,
               chunked_attn: bool = False):
    """Every block over the full sequence x [B, T, D] -> (x, summed aux
    loss); each block under ``remat`` when ``cfg.remat``.
    ``chunked_attn``: attention in the reference's chunked form."""
    b, t, _ = x.shape
    positions = torch.arange(t, device=x.device).expand(b, t)

    def body(p_l, x):
        y, a, _ = blk.block_apply_seq(p_l, x, cfg, positions,
                                      moe_mode=moe_mode,
                                      chunked_attn=chunked_attn)
        return y, a

    aux = 0.0
    for _, p_l in iter_layers(params):
        x, a = remat(body, p_l, x, on=cfg.remat)
        aux = aux + a
    return x, aux


def chunked_nll(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor, chunk: int = 1024,
                transpose_head: bool = False) -> torch.Tensor:
    """Mean cross entropy without the full [B, T, V] logits: per T-chunk
    (sum nll, count), each chunk under ``remat`` so the backward pass
    recomputes its logits.  One dense pass when T <= chunk or chunk does
    not divide T.  Under a ``dp_context`` the count is the whole data
    axis's (``dp_sum``), so each rank returns its share of the global
    batch's mean and the shares sum to it."""
    b, t, d = x.shape
    if t % chunk or t <= chunk:
        s, c = _nll_dense(x, head, targets, mask, transpose_head,
                          reduce_mean=False)
        return s / torch.clamp(dp_sum(c), min=1.0)
    s = torch.zeros((), device=x.device)
    c = torch.zeros((), device=x.device)
    for i in range(0, t, chunk):
        si, ci = remat(
            lambda xi, hd, ti, mi: _nll_dense(xi, hd, ti, mi, transpose_head,
                                              reduce_mean=False),
            x[:, i:i + chunk], head, targets[:, i:i + chunk],
            mask[:, i:i + chunk])
        s, c = s + si, c + ci
    return s / torch.clamp(dp_sum(c), min=1.0)


def _nll_dense(x: torch.Tensor, head: torch.Tensor, targets: torch.Tensor,
               mask: torch.Tensor, transpose_head: bool,
               reduce_mean: bool = True):
    if transpose_head:
        x, head = promote(x, head)
    logits = (x @ head.T if transpose_head else mm(x, head)).to(
        torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None])[..., 0]
    s = torch.sum((logz - gold) * mask)
    c = torch.sum(mask)
    if reduce_mean:
        return s / torch.clamp(c, min=1.0)
    return s, c


def _batch_tensor(a, device, dtype=None) -> torch.Tensor:
    """A batch entry (tensor or numpy array) on ``device``, as ``dtype``
    when given."""
    if not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return a.to(device=device, dtype=dtype)


def loss_fn(params, batch, cfg: ModelConfig, moe_mode: str = "dispatch",
            aux_weight: float = 0.01, device="cuda"):
    """Next-token cross entropy plus ``aux_weight`` times the MoE layers'
    load-balancing loss.  batch: ``tokens`` [B, T + 1], optionally
    ``prefix_embeds`` [B, P, D] (whose rows the loss drops) and ``mask``
    [B, T].  Attention takes the reference's chunked form
    (``layers.chunked_attention``).  Returns (loss, {"nll", "aux"})."""
    dev = resolve_device(device)
    tokens = _tokens(batch["tokens"], dev)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    prefix = batch.get("prefix_embeds")
    if prefix is not None:
        prefix = _batch_tensor(prefix, dev)
    x = embed_tokens(params, inputs, cfg, prefix)
    x, aux = _stack_seq(params, x, cfg, moe_mode, chunked_attn=True)
    x = apply_norm(params["final_norm"], x, cfg)
    npfx = x.shape[1] - targets.shape[1]
    if npfx:
        x = x[:, npfx:]
    mask = batch.get("mask")
    mask = (torch.ones(targets.shape, device=dev) if mask is None
            else _batch_tensor(mask, dev, torch.float32))
    if cfg.tie_embeddings:
        nll = chunked_nll(x, params["embed"], targets, mask,
                          transpose_head=True)
    else:
        nll = chunked_nll(x, params["lm_head"], targets, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    return nll + aux_weight * aux, {"nll": nll, "aux": aux}


def _tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.array(tokens, dtype=np.int64)).to(device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               quant_kv: bool = False, device="cuda") -> Dict[str, Any]:
    """The stacked per-layer decode cache: the engine's fixed slot pool
    ``[L, batch, cache_len, KV, Dh]`` (int8 codes + f32 scales when
    ``quant_kv``), plus per-lane ``length``.  Hymba's adds its SSM state
    (``"ssm"``: conv window and h, ``[L, batch, ...]``); xlstm's holds only
    its super-blocks' states (``"mlstm_<i>"`` / ``"slstm_<i>"``, ``m`` at
    -inf), and no KV."""
    dev = resolve_device(device)
    nb = n_scan_blocks(cfg)
    if cfg.family == "ssm":
        layers = {}
        for i in range(cfg.slstm_every):
            if i == cfg.slstm_every - 1:
                layers[f"slstm_{i}"] = xlstm_lib.init_slstm_state(
                    cfg, batch, lead=(nb,), device=dev)
            else:
                layers[f"mlstm_{i}"] = xlstm_lib.init_mlstm_state(
                    cfg, batch, lead=(nb,), device=dev)
        return {"length": torch.zeros((batch,), dtype=torch.int32,
                                      device=dev), "layers": layers}
    cache = _kv_pool((nb, batch, cache_len, cfg.n_kv, cfg.head_dim),
                     batch, quant_kv, dev)
    if cfg.family == "hybrid":
        cache["layers"]["ssm"] = ssm_lib.init_ssm_state(cfg, batch,
                                                        lead=(nb,), device=dev)
    return cache


def _map_layers(fn, layers: Dict[str, Any], *others) -> Dict[str, Any]:
    """``fn`` over every tensor of a cache's ``layers`` (a recurrent state's
    fields one by one), with the matching entries of ``others``."""
    out = {}
    for name, a in layers.items():
        if isinstance(a, tuple):
            out[name] = type(a)(*(fn(*f) for f in
                                  zip(a, *(o[name] for o in others))))
        else:
            out[name] = fn(a, *(o[name] for o in others))
    return out


def _kv_pool(kv_shape, batch: int, quant_kv: bool,
             dev: torch.device) -> Dict[str, Any]:
    """Zeroed K/V of ``kv_shape`` (int8 codes + f32 scales ``[..., 1]``
    when ``quant_kv``) and a per-lane ``length`` [batch]."""
    kv_dtype = torch.int8 if quant_kv else torch.float32
    layers = {"k": torch.zeros(kv_shape, dtype=kv_dtype, device=dev),
              "v": torch.zeros(kv_shape, dtype=kv_dtype, device=dev)}
    if quant_kv:
        layers["k_scale"] = torch.zeros(kv_shape[:-1] + (1,), device=dev)
        layers["v_scale"] = torch.zeros(kv_shape[:-1] + (1,), device=dev)
    return {"length": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "layers": layers}


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, quant_kv: bool = False,
                     device="cuda") -> Dict[str, Any]:
    """A paged KV block pool: ``[L, num_blocks, block_size, KV, Dh]`` K/V
    (int8 codes + f32 scales ``[..., 1]`` when ``quant_kv``) shared by
    every request, plus per-lane ``length`` [batch].  Which block holds
    which request's tokens is decided per step by ``decode_step``'s
    ``block_tables``; callers reserve the last physical block as the trash
    block that retired lanes and masked writes point at.  Attention
    families only: recurrent state is O(1) per lane and gains nothing from
    paging."""
    if cfg.family in ("ssm", "hybrid"):
        raise ValueError(
            f"paged KV cache requires an attention family, got {cfg.family!r}")
    return _kv_pool((cfg.n_layers, num_blocks, block_size, cfg.n_kv,
                     cfg.head_dim), batch, quant_kv, resolve_device(device))


def prefill(params, tokens, cfg: ModelConfig, cache_len: int,
            quant_kv: bool = False, lengths=None, device="cuda",
            moe_mode: str = "dense", prefix_embeds=None):
    """Process right-padded prompts [B, T], after ``prefix_embeds`` [B, P,
    D] when given; build their decode cache (K/V and recurrent state) and
    return the logits at each prompt's last token ([B, V], cache).  The
    cache's ``length`` counts the prefix: ``lengths + P``."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    lengths = (torch.full((b,), t, dtype=torch.int32, device=dev)
               if lengths is None
               else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
    x = embed_tokens(params, tokens, cfg, prefix_embeds)
    tt = x.shape[1]
    positions = torch.arange(tt, device=dev).expand(b, tt)
    parts = []
    for _, p_l in iter_layers(params):
        x, _, cache = blk.block_apply_seq(p_l, x, cfg, positions,
                                          moe_mode=moe_mode,
                                          collect_cache=True)
        parts.append(cache)
    x = apply_norm(params["final_norm"], x, cfg)
    last = x[torch.arange(b, device=dev), (lengths - 1 + (tt - t)).long()]
    logits = lm_logits(params, last[:, None], cfg)[:, 0]
    length = lengths + (tt - t)

    # the recurrent states, stacked over the layers
    layers = {name: type(st)(*(torch.stack(f) for f in
                               zip(*(c[name] for c in parts))))
              for name, st in parts[0].items() if name != "kv"}
    if cfg.family == "ssm":
        return logits, {"length": length, "layers": layers}

    # assemble the ring cache from the collected per-layer K/V
    k_new = torch.stack([c["kv"]["k"] for c in parts])  # [L, B, T, KV, Dh]
    v_new = torch.stack([c["kv"]["v"] for c in parts])
    pad = cache_len - tt
    if pad >= 0:
        padkv = lambda a: torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
        k_new, v_new = padkv(k_new), padkv(v_new)
    else:
        # the reference keeps the last cache_len positions in slots
        # 0..cache_len-1 (lm.py:362-364), which disagrees with the
        # position % S layout decode assumes; reproduced as it is
        k_new, v_new = k_new[:, :, -cache_len:], v_new[:, :, -cache_len:]
    if quant_kv:
        kq, ksc = quantize_kv(k_new)
        vq, vsc = quantize_kv(v_new)
        layers.update(k=kq, v=vq, k_scale=ksc, v_scale=vsc)
    else:
        layers.update(k=k_new.contiguous(), v=v_new.contiguous())
    return logits, {"length": length, "layers": layers}


def _scatter_slots(pool: Dict[str, Any], fresh: Dict[str, Any],
                   slots: torch.Tensor) -> Dict[str, Any]:
    """Write a freshly prefilled batch-b cache into pool rows ``slots``,
    in place (recurrent states field by field); untouched slots keep their
    contents bit for bit."""
    def put(dst, src):
        dst[:, slots] = src.to(dst.dtype)
    _map_layers(put, pool["layers"], fresh["layers"])
    pool["length"][slots] = fresh["length"]
    return pool


def prefill_into_slot(params, tokens, cache, slot, cfg: ModelConfig,
                      quant_kv: bool = False, lengths=None, device="cuda",
                      prefix_embeds=None):
    """Prefill request(s) and write their KV and recurrent state into rows
    ``slot`` (int or [b]) of the engine's pool.  Returns (last-token logits
    [b, V], pool)."""
    dev = resolve_device(device)
    slots = torch.atleast_1d(torch.as_tensor(slot, dtype=torch.int64,
                                             device=dev))
    cache_len = 0 if cfg.family == "ssm" else cache["layers"]["k"].shape[2]
    logits, fresh = prefill(params, tokens, cfg, cache_len=cache_len,
                            quant_kv=quant_kv, lengths=lengths, device=dev,
                            prefix_embeds=prefix_embeds)
    return logits, _scatter_slots(cache, fresh, slots)


def _scatter_blocks(pool: Dict[str, Any], fresh: Dict[str, Any],
                    slots: torch.Tensor, phys: torch.Tensor,
                    offs: torch.Tensor) -> Dict[str, Any]:
    """Write a freshly prefilled batch-b cache into pool blocks, in place.

    fresh layers are ``[L, b, T, ...]``; ``phys``/``offs`` are flat
    ``[b*T]`` (physical block, in-block offset) destinations of its token
    rows.  The caller sends padding rows and rows of SHARED prefix blocks
    to the trash block, so shared blocks are never rewritten and repeated
    destinations only ever carry dead values (which of them lands is
    unspecified on CUDA, and never read)."""
    for name, dst in pool["layers"].items():
        src = fresh["layers"][name]
        flat = src.reshape((src.shape[0], -1) + tuple(src.shape[3:]))
        dst[:, phys, offs] = flat.to(dst.dtype)
    pool["length"][slots] = fresh["length"]
    return pool


def _copy_blocks(layers: Dict[str, Any], src: torch.Tensor,
                 dst: torch.Tensor) -> Dict[str, Any]:
    """Copy-on-write: duplicate pool blocks ``src`` into free blocks
    ``dst``, in place.  ``a[:, src]`` gathers every source before any
    destination is written."""
    for a in layers.values():
        a[:, dst] = a[:, src]
    return layers


def prefill_into_blocks(params, tokens, cache, slots, phys, offs,
                        cfg: ModelConfig, quant_kv: bool = False,
                        lengths=None, device="cuda"):
    """Prefill request(s) and scatter their KV into a paged block pool.

    tokens [b, T] right-padded prompts; cache a pool from
    ``init_paged_cache``; slots [b] decode lanes (for ``length``);
    phys/offs flat [b*T] block destinations, trash-redirected where a row
    must not be written (padding, shared prefix blocks).  Returns
    (last-token logits [b, V], pool)."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    slots = torch.atleast_1d(torch.as_tensor(slots, dtype=torch.int64,
                                             device=dev))
    logits, fresh = prefill(params, tokens, cfg, cache_len=tokens.shape[1],
                            quant_kv=quant_kv, lengths=lengths, device=dev)
    return logits, _scatter_blocks(cache, fresh, slots, _tokens(phys, dev),
                                   _tokens(offs, dev))


def decode_step(params, tokens, cache, cfg: ModelConfig,
                quant_kv: bool = False, active_mask=None, device="cuda",
                block_tables: Optional[torch.Tensor] = None,
                capture_layer_inputs: bool = False):
    """One decode step: tokens [B, 1] -> (logits [B, V], cache).

    The cache is updated in place.  ``active_mask`` [B] bool: retired
    lanes still flow through the matmuls but their ``length`` does not
    advance.

    ``block_tables`` [B, mbs] int32 on ``device``: paged mode over a pool
    from ``init_paged_cache``; lane i's logical block j lives in physical
    block ``block_tables[i, j]``, and the lane's logical ``cache_len`` is
    ``mbs * block_size``.  Paged lanes never wrap (the engine refuses
    requests longer than that), so the ring validity rule holds; retired
    lanes' rows point at the trash block.

    ``capture_layer_inputs``: also return each layer's block input
    ([n_layers, B, 1, D], a third result), the vectors the DFM's Pattern
    Reuse Table would see; the engine feeds them to an ``ActivationTap``."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    position = cache["length"]
    x = embed_tokens(params, tokens, cfg)
    cache_len = 0 if cfg.family == "ssm" else cache["layers"]["k"].shape[2]
    write_at = None
    if block_tables is not None:
        # shape[2] of a [L, NB, BS, KV, Dh] pool is the block size
        write_at = blk.paged_slot(block_tables, position, cache_len)
        cache_len = block_tables.shape[1] * cache_len
    captured = []
    for i, p_l in iter_layers(params):
        if capture_layer_inputs:
            captured.append(x)
        layer_cache = _map_layers(lambda a: a[i], cache["layers"])
        x = blk.block_apply_decode(p_l, x, cfg,
                                   layer_cache, position, cache_len,
                                   quant_kv=quant_kv,
                                   block_tables=block_tables,
                                   write_at=write_at)
    x = apply_norm(params["final_norm"], x, cfg)
    logits = lm_logits(params, x, cfg)[:, 0]
    if active_mask is None:
        cache["length"] = position + 1
    else:
        mask = torch.as_tensor(active_mask, device=dev).to(torch.int32)
        cache["length"] = position + mask
    if capture_layer_inputs:
        return logits, cache, torch.stack(captured)
    return logits, cache


# ---------------------------------------------------------------------------
# speculative decoding: the k-step draft and the multi-token verify
# ---------------------------------------------------------------------------

# Stream salts keep the speculative draws (draft sampling, acceptance coin
# flips, residual resampling, bonus draws) on key streams of their own,
# apart from the committed-token sampler's, all folded from the same
# (seed, uid, per-request sample index) triple, so the draws do not depend
# on the pool layout or on preemption (the reference's values).
DRAFT_SALT = 0x0D_0A_F7
ACCEPT_SALT = 0x0A_CC_E7
RESAMPLE_SALT = 0x0E_55_1D
BONUS_SALT = 0x0B_00_05


def verify_step(params, tokens, cache, cfg: ModelConfig,
                quant_kv: bool = False, active_mask=None, device="cuda",
                block_tables: Optional[torch.Tensor] = None):
    """Multi-token decode for speculative verification.

    tokens [B, T] occupy absolute positions ``cache["length"] + t``.
    Returns ``(logits [B, T, V], cache)``: row i is the next-token
    distribution after ``tokens[:, :i+1]`` on top of the cache.  KV is
    written in place for all T positions (over whatever the draft left
    there), and ``length`` advances by T on active lanes; the engine then
    sets it to the accepted frontier, which is the whole rollback on the
    ring (slots past the frontier are invalid until rewritten in order).
    Each row's weight matmuls split as the decode step's B-row call does
    and the rest runs token by token as ``decode_step`` does, so a row's
    logits are the decode step's on the same cache, bit for bit on the
    card.  ``block_tables``: paged mode, as in :func:`decode_step`."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    position = cache["length"]
    x = embed_tokens(params, tokens, cfg)
    cache_len = cache["layers"]["k"].shape[2]
    if block_tables is not None:
        cache_len = block_tables.shape[1] * cache_len
    for i, p_l in iter_layers(params):
        layer_cache = {name: a[i] for name, a in cache["layers"].items()}
        x = blk.block_apply_verify(p_l, x, cfg, layer_cache, position,
                                   cache_len, quant_kv=quant_kv,
                                   block_tables=block_tables)
    x = blk.per_token(lambda r: apply_norm(params["final_norm"], r, cfg), x)
    logits = lm_logits(params, x, cfg, plan_rows=b)         # [B, T, V]
    if active_mask is None:
        cache["length"] = position + t
    else:
        mask = torch.as_tensor(active_mask, device=dev).to(torch.int32)
        cache["length"] = position + t * mask
    return logits, cache


def draft_tokens(params, tokens, cache, cfg: ModelConfig, k: int,
                 quant_kv: bool = False, active_mask=None, device="cuda",
                 block_tables: Optional[torch.Tensor] = None,
                 temperature: float = 0.0, seed: int = 0, uids=None,
                 indices=None):
    """Draft ``k`` tokens per lane: k :func:`decode_step` calls under the
    draft weight tree, sampling between them: argmax at ``temperature``
    0, else ``categorical(key, row / T)`` under ``key =
    fold_in(fold_in(fold_in(PRNGKey(seed), uid), index + i), DRAFT_SALT)``
    (``prng.draw_with_keys``; the keys of all k steps are made on the
    host at once).

    tokens [B, 1]: the pending token.  Returns ``(draft [B, k] int64,
    draft_logits [B, k, V], cache)``.  The draft's KV lands at positions
    ``length .. length + k - 1`` at draft precision; verify overwrites
    every one of those slots."""
    dev = resolve_device(device)
    tok = _tokens(tokens, dev)
    keys = None
    if temperature > 0.0:
        idx = np.asarray(indices, np.int64)
        keys = torch.from_numpy(np.stack([
            np.stack(prng.row_keys(seed, uids, idx + i, salt=DRAFT_SALT), 1)
            for i in range(k)]).view(np.int32)).to(dev)     # [k, B, 2]
    drafted, qlogits = [], []
    for i in range(k):
        logits, cache = decode_step(params, tok, cache, cfg,
                                    quant_kv=quant_kv,
                                    active_mask=active_mask, device=dev,
                                    block_tables=block_tables)
        if keys is None:
            nxt = torch.argmax(logits, dim=-1)
        else:
            nxt = prng.draw_with_keys(logits, keys[i], temperature).tokens
        drafted.append(nxt)
        qlogits.append(logits)
        tok = nxt[:, None]
    return torch.stack(drafted, 1), torch.stack(qlogits, 1), cache


def greedy_generate(params, prompt, cfg: ModelConfig, max_new: int,
                    cache_len: Optional[int] = None, quant_kv: bool = False,
                    device="cuda") -> torch.Tensor:
    """Reference generation loop (the serving engine uses its own)."""
    dev = resolve_device(device)
    prompt = _tokens(prompt, dev)
    b, t = prompt.shape
    cache_len = cache_len or (t + max_new)
    if cfg.window is not None:
        cache_len = min(cache_len, cfg.window)
    logits, cache = prefill(params, prompt, cfg, cache_len, quant_kv,
                            device=dev)
    out = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(max_new):
        out.append(tok)
        logits, cache = decode_step(params, tok, cache, cfg, quant_kv,
                                    device=dev)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(out, dim=1)

