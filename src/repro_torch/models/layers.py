"""Core transformer layers (port of ``repro.models.layers``, what the
dense and MoE decoders take: RMSNorm and LayerNorm, RoPE, GQA prefill
attention with optional qk-norm and biases, SwiGLU, GeGLU and GELU MLPs).
Parameters are plain dicts of tensors mirroring the reference trees;
weight matmuls go through ``sail_linear.mm``.  Prefill attention is plain
PyTorch (einsum and a masked softmax), as the reference's is plain jnp.
GELU is the tanh approximation, ``jax.nn.gelu``'s default."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import tp_all_reduce
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
    """RMSNorm over a head's width (qwen3's q_norm / k_norm), before RoPE."""
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
    """qk-norm (where the config has it), then RoPE, of q and k."""
    if cfg.qk_norm:
        q = qk_norm(q, attn_p["q_norm"]["scale"], cfg.norm_eps)
        k = qk_norm(k, attn_p["k_norm"]["scale"], cfg.norm_eps)
    return apply_rope(q, positions, cfg), apply_rope(k, positions, cfg)


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


def flash_attention(q, k, v, *, window: Optional[int]) -> torch.Tensor:
    """Causal masked-softmax attention in plain PyTorch, one pass over all
    keys (prefill: query t sits at position t).

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
    valid = kv_pos <= q_pos
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
                    positions: torch.Tensor) -> torch.Tensor:
    """Full-sequence (prefill) causal self-attention.  Only this path adds
    the attention biases: the decode and verify steps and the prefill
    cache's K/V leave them out, as the reference's do."""
    b, t, _ = x.shape
    q, k, v = mm(x, p["wq"]), mm(x, p["wk"]), mm(x, p["wv"])
    if cfg.attention_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv, cfg.head_dim)
    q, k = qk_rope(p, q, k, positions, cfg)
    out = flash_attention(q, k, v, window=cfg.window)
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
    ``wo``'s are."""
    if cfg.act == "swiglu":
        h = F.silu(mm(x, p["w_gate"], plan_rows)) * mm(x, p["w_up"],
                                                       plan_rows)
    elif cfg.act == "geglu":
        h = gelu(mm(x, p["w_gate"], plan_rows)) * mm(x, p["w_up"], plan_rows)
    else:
        h = gelu(mm(x, p["w_up"], plan_rows))
    return tp_all_reduce(mm(h, p["w_down"], plan_rows, k_sharded=True))
