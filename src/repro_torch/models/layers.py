"""Core transformer layers (port of ``repro.models.layers``): RMSNorm and
LayerNorm, RoPE and sinusoidal positions, GQA full-sequence attention
(causal or bidirectional, self or cross, with optional qk-norm and
biases), SwiGLU, GeGLU and GELU MLPs.  Parameters are plain dicts of
tensors mirroring the reference trees; weight matmuls go through
``sail_linear.mm``.  Full-sequence attention is plain PyTorch (einsum and
a masked softmax), as the reference's is plain jnp.  GELU is the tanh
approximation, ``jax.nn.gelu``'s default."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import tp_all_reduce, tp_copy
from repro_torch.models.common import ModelConfig
from repro_torch.models.sail_linear import mm


def dense_init(generator: torch.Generator, shape, fan_in=None,
               device=None) -> torch.Tensor:
    """Truncated normal on [-2, 2] scaled by 1/sqrt(fan_in) (fan_in
    defaults to the second-to-last dim, i.e. K of a [.., K, N] weight)."""
    fan_in = fan_in if fan_in is not None else shape[-2]
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return t * (1.0 / math.sqrt(fan_in))


def norm_init(cfg: ModelConfig, lead=(), device=None):
    shape = tuple(lead) + (cfg.d_model,)
    p = {"scale": torch.ones(shape, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, device=device)
    return p


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm, or LayerNorm written as the reference writes it (mean,
    variance, rsqrt)."""
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        return (y * p["scale"] + p["bias"]).to(x.dtype)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]).to(x.dtype)


def qk_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over a head's width (qwen3's q_norm / k_norm), before RoPE.
    Under tensor parallelism ``x`` holds this rank's heads only, so the
    replicated ``scale`` passes ``tp_copy``: its gradient sums the ranks'
    heads."""
    scale = tp_copy(scale)
    var = (x.to(torch.float32) ** 2).mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    d = cfg.head_dim
    exps = torch.arange(0, d, 2, dtype=torch.float32, device=device) / d
    return 1.0 / (cfg.rope_theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x [B, T, H, Dh]; positions [B, T] absolute.  Split-halves layout
    (reference ``layers.py:69-72``)."""
    inv = rope_freqs(cfg, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv       # [B, T, Dh/2]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def qk_rope(attn_p, q: torch.Tensor, k: torch.Tensor,
            positions: torch.Tensor, cfg: ModelConfig):
    """qk-norm (where the config has it), then RoPE (where the config's
    positions are rotary), of q and k."""
    if cfg.qk_norm:
        q = qk_norm(q, attn_p["q_norm"]["scale"], cfg.norm_eps)
        k = qk_norm(k, attn_p["k_norm"]["scale"], cfg.norm_eps)
    if cfg.pos != "rope":
        return q, k
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg)


def sinusoidal_angles(pos: torch.Tensor, d: int) -> torch.Tensor:
    """[P, d/2] f32 angles ``pos / 10000 ** (dim / d)`` of positions
    ``pos`` [P] (the reference's expression, ``layers.py:75-82``).  The
    power is taken in f64 and rounded, which is the reference's f32 power
    bit for bit; the division is f32's."""
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=pos.device)
    denom = (10000.0 ** (dim / d).to(torch.float64)).to(torch.float32)
    return pos.to(torch.float32)[:, None] / denom[None, :]


def sinusoidal_rows(pos: torch.Tensor, d: int) -> torch.Tensor:
    """Rows ``pos`` [P] of the sinusoidal table: [P, d], sin at even and
    cos at odd columns.  Sine and cosine are taken in f64 and rounded, so
    each entry is the correctly rounded f32 value (the reference's f32
    sin / cos on the CPU part from it by one ulp on ~1% of entries); a row
    is the table's row bit for bit on one device."""
    ang = sinusoidal_angles(pos, d).to(torch.float64)
    pe = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    return pe.reshape(pos.shape[0], d).to(torch.float32)


def sinusoidal_positions(seq: int, d: int, device=None) -> torch.Tensor:
    """[seq, d] sinusoidal position table (reference ``layers.py:75``)."""
    return sinusoidal_rows(torch.arange(seq, device=device), d)


def attention_init(generator, cfg: ModelConfig, lead=(), device=None):
    d, lead = cfg.d_model, tuple(lead)
    p = {
        "wq": dense_init(generator, lead + (d, cfg.q_dim), device=device),
        "wk": dense_init(generator, lead + (d, cfg.kv_dim), device=device),
        "wv": dense_init(generator, lead + (d, cfg.kv_dim), device=device),
        "wo": dense_init(generator, lead + (cfg.q_dim, d), device=device),
    }
    zeros = lambda n: torch.zeros(lead + (n,), device=device)
    if cfg.attention_bias:
        p.update(bq=zeros(cfg.q_dim), bk=zeros(cfg.kv_dim),
                 bv=zeros(cfg.kv_dim), bo=zeros(d))
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones(lead + (cfg.head_dim,),
                                           device=device)}
        p["k_norm"] = {"scale": torch.ones(lead + (cfg.head_dim,),
                                           device=device)}
    return p


def flash_attention(q, k, v, *, window: Optional[int],
                    causal: bool = True) -> torch.Tensor:
    """Masked-softmax attention in plain PyTorch, one pass over all keys
    (query t sits at position t; ``causal=False``: every key is valid but
    for the window, as in the encoder and in cross-attention).

    q [B, T, H, Dh]; k, v [B, S, KV, Dh]; GQA by head grouping.  Computes
    what the reference's chunked online softmax computes:
    ``exp(s - max) @ v / max(sum, 1e-30)`` over the valid keys."""
    b, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, t, kv, g, dh).to(torch.float32)
    scores = torch.einsum("btghd,bsgd->btghs", qg,
                          k.to(torch.float32)) * (1.0 / math.sqrt(dh))
    q_pos = torch.arange(t, device=q.device)[:, None]
    kv_pos = torch.arange(s, device=q.device)[None, :]
    valid = (kv_pos <= q_pos if causal
             else torch.ones((t, s), dtype=torch.bool, device=q.device))
    if window is not None:
        valid &= kv_pos > q_pos - window
    valid = valid[None, :, None, None, :]
    scores = scores.masked_fill(~valid, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m).masked_fill(~valid, 0.0)
    acc = torch.einsum("btghs,bsgd->btghd", p, v.to(torch.float32))
    out = acc / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return out.reshape(b, t, h, dh).to(q.dtype)


def apply_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Full-sequence (prefill) attention: self-attention, or cross-attention
    to ``kv_x`` [B, S, D] (never causal, no RoPE).  Only this path adds
    the attention biases: the decode and verify steps and the prefill
    cache's K/V leave them out, as the reference's do."""
    b, t, _ = x.shape
    x = tp_copy(x)
    src = tp_copy(kv_x) if kv_x is not None else x
    q, k, v = mm(x, p["wq"]), mm(src, p["wk"]), mm(src, p["wv"])
    if cfg.attention_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, src.shape[1], cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, src.shape[1], cfg.n_kv, cfg.head_dim)
    if kv_x is None:
        q, k = qk_rope(p, q, k, positions, cfg)
    elif cfg.qk_norm:
        q = qk_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = qk_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    out = flash_attention(q, k, v, window=window,
                          causal=causal and kv_x is None)
    out = tp_all_reduce(mm(out.reshape(b, t, cfg.q_dim), p["wo"],
                           k_sharded=True))
    return out + p["bo"] if cfg.attention_bias else out


def mlp_init(generator, cfg: ModelConfig, lead=(), device=None):
    """SwiGLU and GeGLU: ``w_gate``, ``w_up``, ``w_down``; GELU: ``w_up``
    and ``w_down``."""
    d, f, lead = cfg.d_model, cfg.d_ff, tuple(lead)
    p = {}
    if cfg.act in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(generator, lead + (d, f), device=device)
    p["w_up"] = dense_init(generator, lead + (d, f), device=device)
    p["w_down"] = dense_init(generator, lead + (f, d), device=device)
    return p


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig,
              plan_rows: Optional[int] = None) -> torch.Tensor:
    """SwiGLU, GeGLU or GELU (``plan_rows``: see ``sail_linear.mm``).
    ``w_down`` is row-parallel under tensor parallelism: its partial sums
    are summed over the group (``dist.sharding.tp_all_reduce``), as
    ``wo``'s are; ``x`` enters the column-parallel ``w_gate`` / ``w_up``
    through ``tp_copy``, as attention's input enters ``wq / wk / wv``."""
    x = tp_copy(x)
    if cfg.act == "swiglu":
        h = F.silu(mm(x, p["w_gate"], plan_rows)) * mm(x, p["w_up"],
                                                       plan_rows)
    elif cfg.act == "geglu":
        h = gelu(mm(x, p["w_gate"], plan_rows)) * mm(x, p["w_up"], plan_rows)
    else:
        h = gelu(mm(x, p["w_up"], plan_rows))
    return tp_all_reduce(mm(h, p["w_down"], plan_rows, k_sharded=True))
