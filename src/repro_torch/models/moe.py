"""Mixture-of-Experts layer (port of ``repro.models.moe``: granite-moe 32
experts top-8, mixtral 8 experts top-2).

Two modes, as in the reference:
  * ``"dispatch"``: GShard capacity dispatch (one-hot dispatch and combine
    tensors per group of ``MOE_GROUP_TOKENS`` tokens, einsums over
    expert-major buffers); tokens past an expert's capacity are dropped.
    ``lm.forward`` and the Planner's probes take it.
  * ``"dense"``: every expert on every token, combined by the top-k routing
    weights; exact.  Prefill, decode and verify take it.

The expert einsums go through ``sail_linear.einsum_q``, which dequantizes a
quantized expert stack on every call, as the reference does: no LUT-GEMV
launch serves an expert.  The router is a plain ``mm`` (a LUT-GEMV launch
where the policy quantizes it).

Under tensor-parallel training each model rank holds an F slice of every
expert (``w_gate`` / ``w_up`` column-parallel, ``w_down`` row-parallel)
and computes the router, the top-k and the dispatch whole and alike.
Megatron's operators go where the MLP's go, in two places each:
``tp_copy`` on the experts' input (not above the router, whose part of
``x``'s gradient is already whole on every rank) and on the routing
weights that build the combine tensor (each rank's F slice gives a
partial gradient of them); one ``tp_all_reduce`` of the combined
``[T, D]`` output, taken after the load-balancing term so that a
recomputing backward pass (``models.remat``) stops before it.  Outside a
``tp_context`` and in serving all three are the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.dist.sharding import dp_sum, tp_all_reduce, tp_copy
from repro_torch.models.common import ModelConfig
from repro_torch.models.layers import dense_init, gelu
from repro_torch.models.sail_linear import einsum_q, mm


def moe_init(generator: torch.Generator, cfg: ModelConfig, lead=(),
             device=None):
    """Router [*lead, d, E] and experts [*lead, E, d, f] / [*lead, E, f, d].
    ``w_gate`` and ``w_up`` scale by 1/sqrt(E), not 1/sqrt(d): the
    reference draws them with ``dense_init``'s default fan-in, the first
    dim of one layer's (E, d, f)."""
    d, f, e, lead = cfg.d_model, cfg.expert_ffn, cfg.n_experts, tuple(lead)
    return {
        "router": dense_init(generator, lead + (d, e), device=device),
        "w_gate": dense_init(generator, lead + (e, d, f), fan_in=e,
                             device=device),
        "w_up": dense_init(generator, lead + (e, d, f), fan_in=e,
                           device=device),
        "w_down": dense_init(generator, lead + (e, f, d), fan_in=f,
                             device=device),
    }


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row (a
    comparison, so no range check syncs the host or breaks a CUDA graph)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _router_probs(p, x: torch.Tensor, cfg: ModelConfig):
    """(router logits [..., E], top-k values, top-k experts, their softmax
    renormalised over the k)."""
    logits = mm(x, p["router"])
    topv, topi = torch.topk(logits, cfg.top_k, dim=-1)
    return logits, topv, topi, torch.softmax(topv, dim=-1)


def _expert_ffn(p, x: torch.Tensor, cfg: ModelConfig, spec_in: str,
                spec_out: str) -> torch.Tensor:
    """The experts' MLP: GELU on ``w_up`` for ``act="gelu"``, else SwiGLU
    (the reference's two branches)."""
    if cfg.act == "gelu":
        h = gelu(einsum_q(spec_in, x, p["w_up"]))
    else:
        h = F.silu(einsum_q(spec_in, x, p["w_gate"])) * \
            einsum_q(spec_in, x, p["w_up"])
    return einsum_q(spec_out, h, p["w_down"])


def apply_moe_dense(p, x: torch.Tensor, cfg: ModelConfig):
    """Exact dense-compute MoE: every expert, weighted by the top-k
    router.  Returns (out, aux loss)."""
    *lead, d = x.shape
    xt = x.reshape(-1, d)
    logits, _, topi, probs = _router_probs(p, xt, cfg)
    comb = (_one_hot(topi, cfg.n_experts, probs.dtype)
            * tp_copy(probs)[..., None]).sum(-2)             # [T, E]
    y = _expert_ffn(p, tp_copy(xt), cfg, "td,edf->tef", "tef,efd->ted")
    out = torch.einsum("ted,te->td", y, comb)
    aux = _aux_loss(logits, comb, cfg)
    return tp_all_reduce(out).reshape(*lead, d), aux


MOE_GROUP_TOKENS = 512   # GShard dispatch group (the reference's)


def apply_moe_dispatch(p, x: torch.Tensor, cfg: ModelConfig):
    """Capacity dispatch (GShard): tokens in groups of ``MOE_GROUP_TOKENS``
    (one group when that does not divide them), each routed to per-expert
    buffers of ``cf * group * k / E`` rows in order of (token, k); a
    (token, k) past its expert's capacity is dropped.  Returns (out, aux
    loss)."""
    *lead, d = x.shape
    xt = x.reshape(-1, d)
    t, e, k = xt.shape[0], cfg.n_experts, cfg.top_k
    tg = min(MOE_GROUP_TOKENS, t)
    if t % tg:
        tg = t
    ng = t // tg
    cap = max(1, int(cfg.capacity_factor * tg * k / e))

    logits, _, topi, probs = _router_probs(p, xt, cfg)       # topi [T, K]
    topi_g = topi.reshape(ng, tg, k)
    probs_g = tp_copy(probs).reshape(ng, tg, k)
    xg = tp_copy(xt).reshape(ng, tg, d)

    # buffer row of each (group, token, k): how many earlier (token, k)
    # pairs of the group went to the same expert
    flat = _one_hot(topi_g, e, torch.int64).reshape(ng, tg * k, e)
    pos = (torch.cumsum(flat, dim=1) * flat - 1).reshape(ng, tg, k, e)
    pos_k = torch.gather(pos, -1, topi_g[..., None])[..., 0]  # [G, Tg, K]
    in_cap = (pos_k < cap) & (pos_k >= 0)

    dtype = x.dtype
    disp = torch.zeros((ng, tg, e, cap), dtype=dtype, device=x.device)
    comb = torch.zeros((ng, tg, e, cap), dtype=torch.float32,
                       device=x.device)
    for j in range(k):
        oh_e = _one_hot(topi_g[..., j], e, dtype)
        oh_c = _one_hot(pos_k[..., j], cap, dtype)
        m = in_cap[..., j].to(dtype)[..., None, None]
        contrib = oh_e[..., :, None] * oh_c[..., None, :] * m
        disp = disp + contrib
        comb = comb + contrib.to(torch.float32) * probs_g[..., j, None, None]

    xe = torch.einsum("gtd,gtec->gecd", xg, disp)             # [G, E, C, D]
    ye = _expert_ffn(p, xe, cfg, "gecd,edf->gecf", "gecf,efd->gecd")
    out = torch.einsum("gecd,gtec->gtd", ye, comb.to(ye.dtype)).reshape(t, d)
    comb_e = comb.sum(-1).reshape(t, e)                       # [T, E]
    aux = _aux_loss(logits, comb_e, cfg)
    return tp_all_reduce(out.reshape(*lead, d).to(x.dtype)), aux


def _aux_loss(logits: torch.Tensor, comb: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Switch-style load-balancing loss: E * sum(tokens routed share *
    mean router probability) over the experts.  Under a ``dp_context``
    both fractions are over the whole data axis's tokens (``dp_sum``), so
    each rank returns its share of the global batch's loss."""
    probs = torch.softmax(logits, dim=-1)
    hits = (comb > 0).to(torch.float32)
    # the count is filled on the device, not copied from the host, so a
    # decode step that computes this term stays capturable as a CUDA graph
    count = hits.new_full((1,), hits.shape[0])
    total = dp_sum(torch.cat([hits.sum(0), count]))
    n = total[-1]
    return cfg.n_experts * torch.sum(total[:-1] / n * (probs.sum(0) / n))


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig, mode: str = "dispatch"):
    if mode == "dense":
        return apply_moe_dense(p, x, cfg)
    return apply_moe_dispatch(p, x, cfg)
