"""Causal language model serving path (port of ``repro.models.lm``,
dense family, ring and paged KV pools): init, the full-sequence forward,
prefill, decode.

A Python loop over layers replaces the reference's ``lax.scan``; the
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

from repro_torch.core.quant import quantize_kv
from repro_torch.device import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import apply_norm, dense_init, norm_init
from repro_torch.models.sail_linear import mm


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's distributions (truncated
    normal on +-2 sigma, 1/sqrt(fan_in), embedding scaled by
    sqrt(d_model)).  ``generator`` must live on ``device``; the numbers
    differ from the reference's ``jax.random`` ones."""
    dev = resolve_device(device)
    return {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model),
                            fan_in=cfg.vocab, device=dev)
        * cfg.d_model ** 0.5,
        "blocks": blk.block_init(generator, cfg, cfg.n_layers, device=dev),
        "final_norm": norm_init(cfg, device=dev),
        "lm_head": dense_init(generator, (cfg.d_model, cfg.vocab), device=dev),
    }


def layer_params(blocks: Dict[str, Any], i: int):
    """Layer ``i`` of one stacked block tree (QTensor for quantized
    leaves)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


def block_segments(params) -> List[Dict[str, Any]]:
    """params["blocks"] as a list of stacked segment trees."""
    blocks = params["blocks"]
    if isinstance(blocks, (list, tuple)):
        return list(blocks)
    return [blocks]


def _segment_len(segment) -> int:
    """Number of layers in one stacked segment tree."""
    return segment["attn_norm"]["scale"].shape[0]


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


def embed_tokens(params, tokens: torch.Tensor, cfg: ModelConfig):
    blk.check_supported(cfg)
    return params["embed"][tokens]


def lm_logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return mm(x, params["lm_head"])


def forward(params, tokens, cfg: ModelConfig, device="cuda"):
    """tokens [B, T] -> (logits [B, T, V], aux): the full-sequence causal
    forward with no cache (the Planner's probes run it).  Dense family
    only, so ``aux`` (the reference's MoE loss) is 0."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    x = embed_tokens(params, tokens, cfg)
    b, t, _ = x.shape
    positions = torch.arange(t, device=dev).expand(b, t)
    for _, p_l in iter_layers(params):
        x, _ = blk.block_apply_seq(p_l, x, cfg, positions)
    x = apply_norm(params["final_norm"], x, cfg)
    return lm_logits(params, x, cfg), 0.0


def _tokens(tokens, device) -> torch.Tensor:
    if isinstance(tokens, torch.Tensor):
        return tokens.to(device=device, dtype=torch.int64)
    return torch.from_numpy(np.array(tokens, dtype=np.int64)).to(device)


def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               quant_kv: bool = False, device="cuda") -> Dict[str, Any]:
    """The stacked per-layer decode cache: the engine's fixed slot pool
    ``[L, batch, cache_len, KV, Dh]`` (int8 codes + f32 scales when
    ``quant_kv``), plus per-lane ``length``."""
    return _kv_pool((cfg.n_layers, batch, cache_len, cfg.n_kv, cfg.head_dim),
                    batch, quant_kv, resolve_device(device))


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
    block that retired lanes and masked writes point at."""
    return _kv_pool((cfg.n_layers, num_blocks, block_size, cfg.n_kv,
                     cfg.head_dim), batch, quant_kv, resolve_device(device))


def prefill(params, tokens, cfg: ModelConfig, cache_len: int,
            quant_kv: bool = False, lengths=None, device="cuda"):
    """Process right-padded prompts [B, T]; build their decode cache and
    return the logits at each prompt's last token ([B, V], cache)."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    lengths = (torch.full((b,), t, dtype=torch.int32, device=dev)
               if lengths is None
               else torch.as_tensor(lengths, dtype=torch.int32, device=dev))
    x = embed_tokens(params, tokens, cfg)
    positions = torch.arange(t, device=dev).expand(b, t)
    ks, vs = [], []
    for _, p_l in iter_layers(params):
        x, cache = blk.block_apply_seq(p_l, x, cfg, positions,
                                       collect_cache=True)
        ks.append(cache["kv"]["k"])
        vs.append(cache["kv"]["v"])
    x = apply_norm(params["final_norm"], x, cfg)
    last = x[torch.arange(b, device=dev), (lengths - 1).long()][:, None]
    logits = lm_logits(params, last, cfg)[:, 0]

    # assemble the ring cache from the collected per-layer K/V
    k_new, v_new = torch.stack(ks), torch.stack(vs)    # [L, B, T, KV, Dh]
    pad = cache_len - t
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
        layers = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    else:
        layers = {"k": k_new.contiguous(), "v": v_new.contiguous()}
    return logits, {"length": lengths, "layers": layers}


def _scatter_slots(pool: Dict[str, Any], fresh: Dict[str, Any],
                   slots: torch.Tensor) -> Dict[str, Any]:
    """Write a freshly prefilled batch-b cache into pool rows ``slots``,
    in place; untouched slots keep their contents bit for bit."""
    for name, dst in pool["layers"].items():
        dst[:, slots] = fresh["layers"][name].to(dst.dtype)
    pool["length"][slots] = fresh["length"]
    return pool


def prefill_into_slot(params, tokens, cache, slot, cfg: ModelConfig,
                      quant_kv: bool = False, lengths=None, device="cuda"):
    """Prefill request(s) and write their KV into rows ``slot`` (int or
    [b]) of the engine's pool.  Returns (last-token logits [b, V], pool)."""
    dev = resolve_device(device)
    slots = torch.atleast_1d(torch.as_tensor(slot, dtype=torch.int64,
                                             device=dev))
    cache_len = cache["layers"]["k"].shape[2]
    logits, fresh = prefill(params, tokens, cfg, cache_len=cache_len,
                            quant_kv=quant_kv, lengths=lengths, device=dev)
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
    cache_len = cache["layers"]["k"].shape[2]
    write_at = None
    if block_tables is not None:
        # shape[2] of a [L, NB, BS, KV, Dh] pool is the block size
        write_at = blk.paged_slot(block_tables, position, cache_len)
        cache_len = block_tables.shape[1] * cache_len
    captured = []
    for i, p_l in iter_layers(params):
        if capture_layer_inputs:
            captured.append(x)
        layer_cache = {name: a[i] for name, a in cache["layers"].items()}
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

