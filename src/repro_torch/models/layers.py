"""Core transformer layers (port of ``repro.models.layers``): RMSNorm and
LayerNorm, RoPE and sinusoidal positions, GQA full-sequence attention
(causal or bidirectional, self or cross, with optional qk-norm and
biases), SwiGLU, GeGLU and GELU MLPs.  Parameters are plain dicts of
tensors mirroring the reference trees; weight matmuls go through
``sail_linear.mm``.  GELU is the tanh approximation, ``jax.nn.gelu``'s
default.

Full-sequence attention is plain PyTorch, as the reference's is plain
jnp, in two forms that compute the same function: one pass over all keys
(``flash_attention``), which the serving prefills run, and the
reference's chunked online softmax (``chunked_attention``), which the
training losses run, so that T 4096 fits the card."""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.dist.sharding import tp_all_reduce, tp_copy
from repro_torch.models.common import ModelConfig
from repro_torch.models.remat import grad_needed
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


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int],
                      chunk: int, q_chunk: int = 512) -> torch.Tensor:
    """The reference's chunked online-softmax attention
    (``repro.models.layers.flash_attention``), for the training losses:
    memory O(q_chunk x chunk) per head where ``flash_attention`` holds all
    T x S scores.

    q [B, T, H, Dh]; k, v [B, S, KV, Dh]; GQA by head grouping.  Queries
    go in blocks of ``q_chunk`` rows (the largest divisor of T up to
    ``q_chunk`` where it does not divide T), each block under
    ``torch.utils.checkpoint``; where the window is narrow
    (``S > 2 * (window + q_chunk)``) a block reads only the band of keys
    it may see.  Within a block, keys go in chunks of ``chunk``, each
    under checkpoint, with a running (max, sum, accumulator).  A chunk
    that no query of the block may see is skipped: it would add exactly
    zero to the sum and the accumulator.  Self-attention from position 0
    or cross-attention (``causal=False``): q[0] and k[0] are aligned."""
    b, t = q.shape[:2]
    if t > q_chunk and t % q_chunk:
        # the largest divisor of t up to q_chunk (vision prefixes give
        # T = 4672 and the like)
        q_chunk = next(d for d in range(q_chunk, 0, -1) if t % d == 0)
    if t <= q_chunk:
        return _attend_block(q, k, v, causal, window, chunk, 0)
    s_full = k.shape[1]
    band = None
    if window is not None and causal and s_full > 2 * (window + q_chunk):
        band = -(-(window + q_chunk) // chunk) * chunk
    outs = []
    for i in range(t // q_chunk):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        off = i * q_chunk
        if band is None:
            ki, vi = k, v
        else:
            lo = min(max(off + q_chunk - band, 0), s_full - band)
            ki, vi, off = k[:, lo:lo + band], v[:, lo:lo + band], off - lo
        args = (qi, ki, vi, causal, window, chunk, off)
        outs.append(checkpoint(_attend_block, *args, use_reentrant=False,
                               preserve_rng_state=False)
                    if grad_needed(qi, ki, vi) else _attend_block(*args))
    return torch.cat(outs, dim=1)


def _attend_block(q, k, v, causal: bool, window: Optional[int], chunk: int,
                  q_offset: int) -> torch.Tensor:
    """One block of queries over every key chunk; laid out [B, KV, T x G,
    .] so that each chunk's two products are batched matmuls."""
    b, t, h, dh = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
    qh = q.reshape(b, t, kv, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, kv, t * g, dh).to(torch.float32)
    # [B, KV, S, Dh]
    kh = k.permute(0, 2, 1, 3).to(torch.float32).contiguous()
    vh = v.permute(0, 2, 1, 3).to(torch.float32).contiguous()
    # the (query row, key) pairs no query may attend, for every key of
    # the block, rows in (t, g) order
    q_pos = torch.arange(t, device=q.device).repeat_interleave(g)[:, None] \
        + q_offset
    kv_pos = torch.arange(n_chunks * chunk, device=q.device)[None, :]
    masked = kv_pos >= s
    if causal:
        masked = masked | (kv_pos > q_pos)
    if window is not None:
        masked = masked | (kv_pos <= q_pos - window)
    m = torch.full((b, kv, t * g), float("-inf"), device=q.device)
    l = torch.zeros((b, kv, t * g), device=q.device)
    acc = torch.zeros((b, kv, t * g, dh), device=q.device)
    scale = 1.0 / math.sqrt(dh)
    tracked = grad_needed(qh, kh, vh)
    for ci in range(n_chunks):
        lo, hi = ci * chunk, (ci + 1) * chunk
        if (lo >= s or (causal and lo > q_offset + t - 1)
                or (window is not None and hi - 1 <= q_offset - window)):
            continue
        args = (m, l, acc, qh, kh[:, :, lo:hi], vh[:, :, lo:hi],
                masked[:, lo:hi], scale)
        if tracked:
            m, l, acc = _ChunkStep.apply(*args)
        else:
            m, l, acc = _online_step(*args)[:3]
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, kv, t, g, dh).permute(0, 2, 1, 3, 4).reshape(
        b, t, h, dh).to(q.dtype)


def _online_step(m, l, acc, qh, kb, vb, masked, scale: float):
    """One key chunk of the online softmax: (max, sum, accumulator) after
    it, and the shift and rescale it used.  The reference's guards for
    rows that have seen no valid key (``-inf`` max) hold without its
    ``where``s: the shift ``m_safe`` is always finite, so ``exp(m -
    m_safe)`` is 0 where ``m`` is ``-inf`` and ``exp(scores - m_safe)``
    is 0 at every masked key."""
    scores = torch.matmul(qh, kb.transpose(-1, -2)).mul_(scale)
    scores = scores.masked_fill_(masked, float("-inf"))
    m_new = torch.maximum(m, scores.amax(dim=-1))
    m_safe = torch.nan_to_num(m_new, neginf=0.0)
    alpha = torch.exp(m - m_safe)
    p = (scores - m_safe[..., None]).exp_()
    l_new = l * alpha + p.sum(-1)
    acc_new = (acc * alpha[..., None]).add_(torch.matmul(p, vb))
    return m_new, l_new, acc_new, m_safe, alpha


class _ChunkStep(torch.autograd.Function):
    """One key chunk's step under a checkpoint of its own: the forward
    pass keeps its inputs and the (small) shift and rescale, and the
    backward pass recomputes the chunk's probabilities and applies the
    step's gradients by hand, as ``torch.utils.checkpoint`` would have
    autograd do at several times the cost on the host, over hundreds of
    chunks a layer.  The running max is a constant to it: the attention's
    output does not depend on the shift, so its gradient through the max
    is zero (exactly; autograd's is rounding noise)."""

    @staticmethod
    def forward(ctx, m, l, acc, qh, kb, vb, masked, scale):
        m_new, l_new, acc_new, m_safe, alpha = _online_step(
            m, l, acc, qh, kb, vb, masked, scale)
        ctx.scale = scale
        ctx.save_for_backward(qh, kb, vb, masked, m_safe, alpha)
        ctx.mark_non_differentiable(m_new)
        return m_new, l_new, acc_new

    @staticmethod
    def backward(ctx, _, g_l, g_acc):
        qh, kb, vb, masked, m_safe, alpha = ctx.saved_tensors
        need = ctx.needs_input_grad
        scores = torch.matmul(qh, kb.transpose(-1, -2)).mul_(ctx.scale)
        p = (scores.masked_fill_(masked, float("-inf"))
             - m_safe[..., None]).exp_()
        # d(scores) = p * (dL/dp), dL/dp = g_acc @ v^T + g_l; then the scale
        ds = torch.matmul(g_acc, vb.transpose(-1, -2)).add_(
            g_l[..., None]).mul_(p).mul_(ctx.scale)
        return (None,
                g_l * alpha if need[1] else None,
                g_acc * alpha[..., None] if need[2] else None,
                torch.matmul(ds, kb) if need[3] else None,
                torch.matmul(ds.transpose(-1, -2), qh) if need[4] else None,
                torch.matmul(p.transpose(-1, -2), g_acc) if need[5] else None,
                None, None)


def apply_attention(p, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    kv_x: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    chunked: bool = False) -> torch.Tensor:
    """Full-sequence attention: self-attention, or cross-attention to
    ``kv_x`` [B, S, D] (never causal, no RoPE).  ``chunked``: the
    reference's chunked form (``chunked_attention``, the training
    losses'), else one pass over all keys (``flash_attention``, the
    serving prefills').  Only this path adds the attention biases: the
    decode and verify steps and the prefill cache's K/V leave them out,
    as the reference's do."""
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
    causal = causal and kv_x is None
    if chunked:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                chunk=cfg.attn_chunk)
    else:
        out = flash_attention(q, k, v, window=window, causal=causal)
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
