"""Encoder-decoder model, whisper-large-v3's backbone (port of
``repro.models.encdec``, serving).

The audio conv frontend is a stub, as in the reference: the caller gives
the frame embeddings [B, S_enc, D] the two conv layers and GELU would
produce.  Encoder: bidirectional attention over sinusoidal positions.
Decoder: causal self-attention over a ring KV cache, cross-attention to
the encoder memory (its K/V computed once, at prefill), a GELU MLP;
LayerNorm and attention biases throughout; the head is tied to the
embedding (``x @ embed.T``, a plain product: the embedding is never
quantized).

The decode step copies where the reference adds biases and where it does
not (``encdec.py:162-223``): the self-attention adds none of ``bq bk bv
bo``, the cross K/V carry ``bk`` / ``bv`` (``_cross_kv``), and the cross
query and output add none.  Its attentions go through the decode-attention
kernel: the self-attention in ring mode, the cross-attention in lengths
mode over the f32 cross K/V with every one of the ``enc_seq`` slots valid
(the reference's einsum softmax, ``encdec.py:199-207``).  The decode
position's sinusoidal row is computed alone, equal to the table's row.

Training: ``loss_fn``, whisper's teacher-forced loss through
``lm.chunked_nll`` with the tied head and the reference's chunked
attention (``layers.chunked_attention``); each encoder and decoder layer
runs under ``remat`` when ``cfg.remat``.  Entry points take
``device=`` (default ``"cuda"``) and raise when CUDA is missing.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attn.ops import decode_attention
from repro_torch.models.blocks import write_and_attend
from repro_torch.models.common import ModelConfig, promote
from repro_torch.models.lm import _kv_pool, _tokens, chunked_nll, \
    layer_params
from repro_torch.models.layers import (apply_attention, apply_mlp, apply_norm,
                                       attention_init, dense_init, mlp_init,
                                       norm_init, sinusoidal_positions,
                                       sinusoidal_rows)
from repro_torch.models.remat import remat
from repro_torch.models.sail_linear import mm


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Dict[str, Any]:
    """Random weights with the reference's distributions and tree layout
    (``enc_blocks`` / ``dec_blocks`` stacked on a leading layer axis);
    ``generator`` must live on ``device``."""
    dev = resolve_device(device)
    le, ld = (cfg.n_enc_layers,), (cfg.n_layers,)
    enc = {"attn_norm": norm_init(cfg, lead=le, device=dev),
           "attn": attention_init(generator, cfg, lead=le, device=dev),
           "mlp_norm": norm_init(cfg, lead=le, device=dev),
           "mlp": mlp_init(generator, cfg, lead=le, device=dev)}
    dec = {"self_norm": norm_init(cfg, lead=ld, device=dev),
           "self_attn": attention_init(generator, cfg, lead=ld, device=dev),
           "cross_norm": norm_init(cfg, lead=ld, device=dev),
           "cross_attn": attention_init(generator, cfg, lead=ld, device=dev),
           "mlp_norm": norm_init(cfg, lead=ld, device=dev),
           "mlp": mlp_init(generator, cfg, lead=ld, device=dev)}
    return {
        "embed": dense_init(generator, (cfg.vocab, cfg.d_model),
                            fan_in=cfg.vocab, device=dev)
        * cfg.d_model ** 0.5,
        "enc_blocks": enc,
        "enc_norm": norm_init(cfg, device=dev),
        "dec_blocks": dec,
        "dec_norm": norm_init(cfg, device=dev),
    }


def _layers(blocks: Dict[str, Any]):
    """Each layer's params of a stacked block tree, in order."""
    n = blocks["mlp_norm"]["scale"].shape[0]
    return [layer_params(blocks, i) for i in range(n)]


def _frames(frames, dev) -> torch.Tensor:
    if isinstance(frames, torch.Tensor):
        return frames.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.asarray(frames, np.float32)).to(dev)


def encode(params, frames, cfg: ModelConfig, device="cuda",
           chunked_attn: bool = False) -> torch.Tensor:
    """frames [B, S_enc, D] (the stubbed frontend's output) -> memory.
    ``chunked_attn``: attention in the reference's chunked form (the
    training loss's)."""
    dev = resolve_device(device)
    x = _frames(frames, dev)
    b, s, _ = x.shape
    x = x + sinusoidal_positions(s, cfg.d_model, device=dev)[None]
    positions = torch.arange(s, device=dev).expand(b, s)

    def body(p_l, x):
        h = apply_norm(p_l["attn_norm"], x, cfg)
        x = x + apply_attention(p_l["attn"], h, cfg, positions=positions,
                                causal=False, chunked=chunked_attn)
        h = apply_norm(p_l["mlp_norm"], x, cfg)
        return x + apply_mlp(p_l["mlp"], h, cfg)

    for p_l in _layers(params["enc_blocks"]):
        x = remat(body, p_l, x, on=cfg.remat)
    return apply_norm(params["enc_norm"], x, cfg)


def _cross_kv(p_l, memory: torch.Tensor, cfg: ModelConfig):
    """One decoder layer's cross K/V [B, S, KV, Dh] of the memory, with
    ``bk`` / ``bv``."""
    b, s, _ = memory.shape
    k = mm(memory, p_l["cross_attn"]["wk"]).reshape(b, s, cfg.n_kv,
                                                    cfg.head_dim)
    v = mm(memory, p_l["cross_attn"]["wv"]).reshape(b, s, cfg.n_kv,
                                                    cfg.head_dim)
    if cfg.attention_bias:
        k = k + p_l["cross_attn"]["bk"].reshape(cfg.n_kv, cfg.head_dim)
        v = v + p_l["cross_attn"]["bv"].reshape(cfg.n_kv, cfg.head_dim)
    return k, v


def decode_forward(params, tokens, memory: torch.Tensor, cfg: ModelConfig,
                   device="cuda", return_hidden: bool = False,
                   chunked_attn: bool = False) -> torch.Tensor:
    """Teacher-forced decoder pass: tokens [B, T] -> logits [B, T, V], or
    the final hidden states [B, T, D] with ``return_hidden``;
    ``chunked_attn`` as in ``encode``."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    b, t = tokens.shape
    x = params["embed"][tokens]
    x = x + sinusoidal_positions(t, cfg.d_model, device=dev)[None]
    positions = torch.arange(t, device=dev).expand(b, t)

    def body(p_l, x, memory):
        h = apply_norm(p_l["self_norm"], x, cfg)
        x = x + apply_attention(p_l["self_attn"], h, cfg,
                                positions=positions, causal=True,
                                chunked=chunked_attn)
        h = apply_norm(p_l["cross_norm"], x, cfg)
        x = x + apply_attention(p_l["cross_attn"], h, cfg,
                                positions=positions, kv_x=memory,
                                chunked=chunked_attn)
        h = apply_norm(p_l["mlp_norm"], x, cfg)
        return x + apply_mlp(p_l["mlp"], h, cfg)

    for p_l in _layers(params["dec_blocks"]):
        x = remat(body, p_l, x, memory, on=cfg.remat)
    x = apply_norm(params["dec_norm"], x, cfg)
    if return_hidden:
        return x
    x, embed = promote(x, params["embed"])
    return x @ embed.T


def loss_fn(params, batch, cfg: ModelConfig, device="cuda"):
    """Teacher-forced cross entropy.  batch: ``frames`` [B, S, D] and
    ``tokens`` [B, T + 1]; the head is tied to the embedding; attention in
    the reference's chunked form.  Returns (nll, {"nll"})."""
    dev = resolve_device(device)
    tokens = _tokens(batch["tokens"], dev)
    memory = encode(params, batch["frames"], cfg, device=dev,
                    chunked_attn=True)
    x = decode_forward(params, tokens[:, :-1], memory, cfg, device=dev,
                       return_hidden=True, chunked_attn=True)
    targets = tokens[:, 1:]
    mask = torch.ones(targets.shape, device=dev)
    nll = chunked_nll(x, params["embed"], targets, mask, transpose_head=True)
    return nll, {"nll": nll}


def init_dec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   enc_seq: int, quant_kv: bool = False,
                   device="cuda") -> Dict[str, Any]:
    """The decoder's cache: a self-attention ring ``[L, B, cache_len, KV,
    Dh]`` (int8 codes + f32 scales when ``quant_kv``), the f32 cross K/V
    ``ck`` / ``cv`` ``[L, B, enc_seq, KV, Dh]`` and per-lane ``length``."""
    dev = resolve_device(device)
    l, shape = cfg.n_layers, (cfg.n_kv, cfg.head_dim)
    cache = _kv_pool((l, batch, cache_len) + shape, batch, quant_kv, dev)
    for name in ("ck", "cv"):
        cache["layers"][name] = torch.zeros((l, batch, enc_seq) + shape,
                                            device=dev)
    return cache


def serve_prefill(params, frames, cfg: ModelConfig, cache_len: int,
                  quant_kv: bool = False, device="cuda") -> Dict[str, Any]:
    """Encode the frames, compute every decoder layer's cross K/V, and
    return the decode-ready cache (an empty self-attention ring)."""
    dev = resolve_device(device)
    memory = encode(params, frames, cfg, device=dev)
    b = memory.shape[0]
    cache = init_dec_cache(cfg, b, cache_len, memory.shape[1], quant_kv,
                           device=dev)
    for i, p_l in enumerate(_layers(params["dec_blocks"])):
        ck, cv = _cross_kv(p_l, memory, cfg)
        cache["layers"]["ck"][i] = ck
        cache["layers"]["cv"][i] = cv
    return cache


def cross_attend(q: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor) -> torch.Tensor:
    """One query per lane over every slot of the f32 cross K/V: q [B, H,
    Dh], ck / cv [B, S, KV, Dh] -> [B, H, Dh] (decode attention's lengths
    mode, ``lengths = S``)."""
    lengths = torch.full((q.shape[0],), ck.shape[1], dtype=torch.int32,
                         device=q.device)
    return decode_attention(q, ck, cv, lengths)


def serve_decode_step(params, tokens, cache, cfg: ModelConfig,
                      quant_kv: bool = False, device="cuda"):
    """One decoder token per lane: tokens [B, 1] -> (logits [B, V], cache),
    the self-attention's K/V written into the ring in place."""
    dev = resolve_device(device)
    tokens = _tokens(tokens, dev)
    b = tokens.shape[0]
    position = cache["length"]
    layers = cache["layers"]
    cache_len = layers["k"].shape[2]
    x = params["embed"][tokens]
    row = torch.clamp(position, max=cfg.max_seq - 1)
    x = x + sinusoidal_rows(row, cfg.d_model)[:, None]
    for i, p_l in enumerate(_layers(params["dec_blocks"])):
        h = apply_norm(p_l["self_norm"], x, cfg)
        sa = p_l["self_attn"]
        q = mm(h, sa["wq"]).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = mm(h, sa["wk"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
        v = mm(h, sa["wv"]).reshape(b, 1, cfg.n_kv, cfg.head_dim)
        self_cache = {name: a[i] for name, a in layers.items()
                      if name not in ("ck", "cv")}
        att = write_and_attend(self_cache, q, k, v, position, cache_len,
                               cache_len, quant_kv)
        x = x + mm(att.reshape(b, 1, cfg.q_dim), sa["wo"])

        h = apply_norm(p_l["cross_norm"], x, cfg)
        cq = mm(h, p_l["cross_attn"]["wq"]).reshape(b, cfg.n_heads,
                                                    cfg.head_dim)
        cro = cross_attend(cq.contiguous(), layers["ck"][i], layers["cv"][i])
        x = x + mm(cro.reshape(b, 1, cfg.q_dim).to(x.dtype),
                   p_l["cross_attn"]["wo"])

        h = apply_norm(p_l["mlp_norm"], x, cfg)
        x = x + apply_mlp(p_l["mlp"], h, cfg)
    x = apply_norm(params["dec_norm"], x, cfg)
    logits = (x @ params["embed"].T)[:, 0]
    cache["length"] = position + 1
    return logits, cache
