"""xLSTM blocks: mLSTM (matrix memory) and sLSTM (port of
``repro.models.xlstm``).

xlstm-350m stacks super-blocks of ``cfg.slstm_every`` layers, mLSTMs then
one sLSTM.  Both are O(1)-state recurrences: decode carries (C, n, m) per
lane.

mLSTM: per head, matrix memory ``C_t = f_t C_{t-1} + i_t v_t k_t^T`` with
exponential gates stabilised by the max-tracker ``m_t``; output ``h_t =
(C_t q_t) / max(|n_t . q_t|, 1)``.  sLSTM: a scalar memory per channel with
the same gating.  ``m`` starts at ``-inf``, and the reference's
``isfinite`` guards (``xlstm.py:101-114, 156-166``) are kept as they are:
the first step's forget term is ``exp(-inf) = 0``.

The reference scans over T; here a loop over T computes the same
recurrence in the same order.  In training ``_chunked_scan`` cuts it into
rematerialised chunks of 128 steps, as the reference's does, which bounds
memory and changes no value.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.common import ModelConfig, promote
from repro_torch.models.layers import dense_init
from repro_torch.models.remat import grad_needed
from repro_torch.models.sail_linear import mm

_NEG_INF = float("-inf")
CHUNK = 128                 # time steps per rematerialised chunk


class MLSTMState(NamedTuple):
    c: torch.Tensor   # [B, H, Dh, Dh]
    n: torch.Tensor   # [B, H, Dh]
    m: torch.Tensor   # [B, H]


class SLSTMState(NamedTuple):
    c: torch.Tensor   # [B, D]
    n: torch.Tensor   # [B, D]
    m: torch.Tensor   # [B, D]


def mlstm_init(generator: torch.Generator, cfg: ModelConfig, lead=(),
               device=None):
    d, lead = cfg.d_model, tuple(lead)
    inner = int(cfg.ssm_expand * d)
    h = cfg.n_heads
    w = lambda k, n, **kw: dense_init(generator, lead + (k, n),
                                      device=device, **kw)
    return {"w_up": w(d, 2 * inner), "w_q": w(inner, inner),
            "w_k": w(inner, inner), "w_v": w(inner, inner),
            "w_if": w(inner, 2 * h), "w_down": w(inner, d, fan_in=inner)}


def slstm_init(generator: torch.Generator, cfg: ModelConfig, lead=(),
               device=None):
    d, lead = cfg.d_model, tuple(lead)
    return {name: dense_init(generator, lead + (d, d), device=device)
            for name in ("w_z", "w_i", "w_f", "w_o", "w_down")}


def _gates(logf_in: torch.Tensor, i: torch.Tensor, m: torch.Tensor):
    """The stabilised exponential gates of one step: (forget factor,
    input factor, new m), with the reference's ``isfinite`` guards."""
    logf = F.logsigmoid(logf_in)
    m_new = torch.maximum(logf + m, i)
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    m_fin = torch.where(torch.isfinite(m), m, torch.full_like(m, _NEG_INF))
    return torch.exp(logf + m_fin - m_safe), torch.exp(i - m_safe), m_new


def mlstm_step(c: torch.Tensor, n: torch.Tensor, m: torch.Tensor,
               qt: torch.Tensor, kt: torch.Tensor, vt: torch.Tensor,
               it: torch.Tensor, ft: torch.Tensor):
    """One token of the mLSTM recurrence: the state (C [B, H, Dh, Dh],
    n [B, H, Dh], m [B, H]) updated by q / k / v [B, H, Dh] and the gate
    logits [B, H].  Returns (C, n, m, h [B, H, Dh])."""
    fda, ida, m = _gates(ft, it, m)
    c = fda[..., None, None] * c + ida[..., None, None] * (
        vt[..., :, None] * kt[..., None, :])
    n = fda[..., None] * n + ida[..., None] * kt
    hn = torch.einsum("bhij,bhj->bhi", *promote(c, qt))
    denom = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh",
                                               *promote(n, qt))),
                        min=1.0)
    return c, n, m, hn / denom[..., None]


def _scan(step, carry, xs, lo: int, hi: int):
    """``step`` over time steps [lo, hi) of ``xs`` (tensors [B, T, ...]):
    (final carry, outputs [B, hi - lo, ...])."""
    outs = []
    for s in range(lo, hi):
        carry, out = step(carry, *(a[:, s] for a in xs))
        outs.append(out)
    return carry, torch.stack(outs, dim=1)


def _chunked_scan(step, carry, xs, chunk: int = CHUNK):
    """The recurrence over T, rematerialised in chunks of ``chunk`` steps
    when autograd records it (reference ``xlstm.py:56-75``): only the
    carries at chunk boundaries are kept, and the backward pass recomputes
    each chunk's steps.  Without it training would keep mLSTM's
    [B, H, Dh, Dh] memory at every step.  One plain loop when T <= chunk,
    when chunk does not divide T, or when no gradient is needed."""
    t = xs[0].shape[1]
    if t <= chunk or t % chunk or not grad_needed(carry, xs):
        return _scan(step, carry, xs, 0, t)
    k = len(carry)

    def run(lo, *flat):
        c, y = _scan(step, tuple(flat[:k]), flat[k:], lo, lo + chunk)
        return (*c, y)

    outs = []
    for lo in range(0, t, chunk):
        res = checkpoint(run, lo, *carry, *xs, use_reentrant=False)
        carry = tuple(res[:k])
        outs.append(res[k])
    return carry, torch.cat(outs, dim=1)


def apply_mlstm(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[MLSTMState] = None,
                return_state: bool = False):
    """x [B, T, D] -> [B, T, D] (and the updated ``MLSTMState``)."""
    b, t, _ = x.shape
    h = cfg.n_heads
    up = mm(x, p["w_up"])
    xs, z = torch.chunk(up, 2, dim=-1)
    inner = xs.shape[-1]
    dh = inner // h
    q = mm(xs, p["w_q"]).reshape(b, t, h, dh) / (dh ** 0.5)
    k = mm(xs, p["w_k"]).reshape(b, t, h, dh) / (dh ** 0.5)
    v = mm(xs, p["w_v"]).reshape(b, t, h, dh)
    ig, fg = torch.chunk(mm(xs, p["w_if"]), 2, dim=-1)    # log-space gates

    if state is None:
        c = torch.zeros((b, h, dh, dh), device=x.device)
        n = torch.zeros((b, h, dh), device=x.device)
        m = torch.full((b, h), _NEG_INF, device=x.device)
    else:
        c, n, m = state

    def step(carry, qt, kt, vt, it, ft):
        c, n, m, out = mlstm_step(*carry, qt, kt, vt, it, ft)
        return (c, n, m), out

    (c, n, m), y = _chunked_scan(step, (c, n, m), (q, k, v, ig, fg))
    y = y.reshape(b, t, inner)
    out = mm(y * F.silu(z), p["w_down"])
    if return_state:
        return out, MLSTMState(c=c, n=n, m=m)
    return out


def apply_slstm(p, x: torch.Tensor, cfg: ModelConfig,
                state: Optional[SLSTMState] = None,
                return_state: bool = False):
    """x [B, T, D] -> [B, T, D] (and the updated ``SLSTMState``)."""
    b, t, d = x.shape
    zt = torch.tanh(mm(x, p["w_z"]))
    it = mm(x, p["w_i"])
    ft = mm(x, p["w_f"])
    ot = torch.sigmoid(mm(x, p["w_o"]))
    if state is None:
        c = torch.zeros((b, d), device=x.device)
        n = torch.zeros((b, d), device=x.device)
        m = torch.full((b, d), _NEG_INF, device=x.device)
    else:
        c, n, m = state

    def step(carry, z_, i_, f_, o_):
        c, n, m = carry
        fda, ida, m = _gates(f_, i_, m)
        c = fda * c + ida * z_
        n = fda * n + ida
        return (c, n, m), o_ * c / torch.clamp(n, min=1.0)

    (c, n, m), outs = _chunked_scan(step, (c, n, m), (zt, it, ft, ot))
    y = mm(outs, p["w_down"])
    if return_state:
        return y, SLSTMState(c=c, n=n, m=m)
    return y


def init_mlstm_state(cfg: ModelConfig, batch: int, lead=(),
                     device=None) -> MLSTMState:
    """Zero memory and ``m = -inf`` for ``batch`` lanes, per leading
    index."""
    inner = int(cfg.ssm_expand * cfg.d_model)
    dh, h, lead = inner // cfg.n_heads, cfg.n_heads, tuple(lead)
    return MLSTMState(
        c=torch.zeros(lead + (batch, h, dh, dh), device=device),
        n=torch.zeros(lead + (batch, h, dh), device=device),
        m=torch.full(lead + (batch, h), _NEG_INF, device=device))


def init_slstm_state(cfg: ModelConfig, batch: int, lead=(),
                     device=None) -> SLSTMState:
    shape = tuple(lead) + (batch, cfg.d_model)
    return SLSTMState(c=torch.zeros(shape, device=device),
                      n=torch.zeros(shape, device=device),
                      m=torch.full(shape, _NEG_INF, device=device))
