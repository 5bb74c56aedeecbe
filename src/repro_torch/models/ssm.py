"""Selective SSM (Mamba-style) branch of the hymba hybrid architecture
(port of ``repro.models.ssm``).

Hymba runs attention heads and mamba heads in parallel within each block
and sums their outputs; this module is the mamba branch: in-projection,
a short causal depthwise conv, the selective SSM (input-dependent B, C,
dt; diagonal A), out-projection.  Decode carries (conv window, SSM state)
per lane, O(1) per token.

The reference runs the diagonal recurrence ``h_t = a_t * h_{t-1} + b_t``
as an associative scan over T (``ssm.py:69``); here it is a loop over T,
which computes the same sums in another order (equal to f32 rounding, the
tests hold it at 1e-5).  Weight matmuls go through ``sail_linear.mm``; the
reference's engine defaults quantize only the ones whose K divides the
group, and at a group that divides d_model it quantizes ``a_log`` too and
its ``exp`` raises (``ssm.py:99``), as this module's does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.common import ModelConfig, promote
from repro_torch.models.layers import dense_init
from repro_torch.models.sail_linear import mm


class SSMState(NamedTuple):
    conv: torch.Tensor   # [B, conv_k - 1, inner]
    h: torch.Tensor      # [B, inner, d_state]


def ssm_inner(cfg: ModelConfig) -> int:
    return int(cfg.ssm_expand * cfg.d_model * (
        cfg.hybrid_ratio if cfg.family == "hybrid" else 1.0))


def ssm_init(generator: torch.Generator, cfg: ModelConfig, lead=(),
             device=None):
    """One SSM branch per leading index (the reference's init, drawn from
    ``generator``): A's log is ``log(1..n)`` per channel, dt's bias the
    inverse softplus of a log-uniform draw in [1e-3, 1e-1], D ones, the
    conv bias zeros."""
    d, n, lead = cfg.d_model, cfg.ssm_state, tuple(lead)
    inner = ssm_inner(cfg)
    dt_rank = max(1, d // 16)
    u = torch.rand(lead + (inner,), generator=generator, device=device)
    lo, hi = torch.log(torch.tensor(1e-3)), torch.log(torch.tensor(1e-1))
    dt = torch.exp(lo + (hi - lo) * u)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "w_in": dense_init(generator, lead + (d, 2 * inner), device=device),
        "conv_w": dense_init(generator, lead + (cfg.ssm_conv, inner),
                             fan_in=cfg.ssm_conv, device=device),
        "conv_b": torch.zeros(lead + (inner,), device=device),
        "w_bcdt": dense_init(generator, lead + (inner, 2 * n + dt_rank),
                             device=device),
        "w_dt": dense_init(generator, lead + (dt_rank, inner),
                           fan_in=dt_rank, device=device),
        "dt_bias": torch.log(torch.expm1(dt)),
        "a_log": torch.log(a).expand(lead + (inner, n)).contiguous(),
        "d_skip": torch.ones(lead + (inner,), device=device),
        "w_out": dense_init(generator, lead + (inner, d), fan_in=inner,
                            device=device),
    }


def _conv_causal(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv along T.  x [B, T, C]; w [K, C].  Returns the
    output and the last K - 1 inputs (the next call's state)."""
    k = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, k - 1, 0))
    else:
        xp = torch.cat([state, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1], :] * w[i] for i in range(k))
    return out + b, xp[:, -(k - 1):, :]


def _ssm_scan(a: torch.Tensor, bx: torch.Tensor,
              h0: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t * h_{t-1} + bx_t`` from ``h0``, a loop over T.
    a, bx [B, T, inner, n]; returns every h_t [B, T, inner, n]."""
    h, out = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + bx[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def apply_ssm(p, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[SSMState] = None, return_state: bool = False):
    """x [B, T, D] -> [B, T, D] (and the updated ``SSMState``)."""
    b, t, _ = x.shape
    n = cfg.ssm_state
    xz = mm(x, p["w_in"])
    xs, z = torch.chunk(xz, 2, dim=-1)                    # [B, T, inner]
    inner = xs.shape[-1]
    conv_state = state.conv if state is not None else None
    xs, new_conv = _conv_causal(xs, p["conv_w"], p["conv_b"], conv_state)
    xs = F.silu(xs)

    bcdt = mm(xs, p["w_bcdt"])
    bmat, cmat, dtr = torch.split(bcdt, [n, n, bcdt.shape[-1] - 2 * n],
                                  dim=-1)
    dt = F.softplus(mm(dtr, p["w_dt"]) + p["dt_bias"])    # [B, T, inner]
    a = -torch.exp(p["a_log"])                            # [inner, n]
    da = torch.exp(dt[..., None] * a)                     # [B, T, inner, n]
    dbx = dt[..., None] * bmat[:, :, None, :] * xs[..., None]
    h0 = (state.h if state is not None
          else torch.zeros((b, inner, n), device=x.device))
    h = _ssm_scan(da, dbx, h0)
    y = torch.einsum("btin,btn->bti", *promote(h, cmat)) + xs * p["d_skip"]
    y = y * F.silu(z)
    out = mm(y, p["w_out"])
    if return_state:
        return out, SSMState(conv=new_conv, h=h[:, -1])
    return out


def init_ssm_state(cfg: ModelConfig, batch: int, lead=(),
                   device=None) -> SSMState:
    """Zero state of ``batch`` lanes, per leading index."""
    inner, lead = ssm_inner(cfg), tuple(lead)
    return SSMState(
        conv=torch.zeros(lead + (batch, cfg.ssm_conv - 1, inner),
                         device=device),
        h=torch.zeros(lead + (batch, inner, cfg.ssm_state), device=device))
