"""Core transformer layers (port of ``repro.models.layers``, the dense
path tinymistral takes: RMSNorm, RoPE, GQA prefill attention, SwiGLU).
Parameters are plain dicts of tensors mirroring the reference trees;
weight matmuls go through ``sail_linear.mm``.  Prefill attention is plain PyTorch (einsum and a
masked softmax), as the reference's is plain jnp."""
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
    return {"scale": torch.ones(tuple(lead) + (cfg.d_model,), device=device)}


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]).to(x.dtype)


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


def attention_init(generator, cfg: ModelConfig, lead=(), device=None):
    d, lead = cfg.d_model, tuple(lead)
    return {
        "wq": dense_init(generator, lead + (d, cfg.q_dim), device=device),
        "wk": dense_init(generator, lead + (d, cfg.kv_dim), device=device),
        "wv": dense_init(generator, lead + (d, cfg.kv_dim), device=device),
        "wo": dense_init(generator, lead + (cfg.q_dim, d), device=device),
    }


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
    """Full-sequence (prefill) causal self-attention."""
    b, t, _ = x.shape
    q = mm(x, p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = mm(x, p["wk"]).reshape(b, t, cfg.n_kv, cfg.head_dim)
    v = mm(x, p["wv"]).reshape(b, t, cfg.n_kv, cfg.head_dim)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    out = flash_attention(q, k, v, window=cfg.window)
    return tp_all_reduce(mm(out.reshape(b, t, cfg.q_dim), p["wo"],
                            k_sharded=True))


def mlp_init(generator, cfg: ModelConfig, lead=(), device=None):
    d, f, lead = cfg.d_model, cfg.d_ff, tuple(lead)
    return {"w_gate": dense_init(generator, lead + (d, f), device=device),
            "w_up": dense_init(generator, lead + (d, f), device=device),
            "w_down": dense_init(generator, lead + (f, d), device=device)}


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig,
              plan_rows: Optional[int] = None) -> torch.Tensor:
    """SwiGLU (``plan_rows``: see ``sail_linear.mm``).  ``w_down`` is
    row-parallel under tensor parallelism: its partial sums are summed over
    the group (``dist.sharding.tp_all_reduce``), as ``wo``'s are."""
    h = F.silu(mm(x, p["w_gate"], plan_rows)) * mm(x, p["w_up"], plan_rows)
    return tp_all_reduce(mm(h, p["w_down"], plan_rows, k_sharded=True))
