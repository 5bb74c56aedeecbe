"""Sensitivity-calibrated mixed-precision bit allocation (port of
``repro.core.sensitivity``).

SAIL's first stated challenge is that "optimal bit precision varies across
models and layers" (Sec. I); its LUT-GEMV serves any ``ql`` per matmul.
This module turns that into a serving feature:

  * ``output_sensitivity`` — score each weight unit (a 2-D leaf or one
    layer of a stacked leaf) by the end-to-end logit MSE of the model with
    every eligible weight at the uniform baseline and ONLY that unit moved
    to a candidate precision (the baseline itself is the exact center);
  * ``activation_sensitivity`` — the same for one unit's matmul inputs at
    each candidate ``abits`` (the gate-masked ``ActQuantWeight`` probe);
  * ``kv_sensitivity`` — per layer, the decode-logit MSE of quantizing
    that layer's cached K/V to int8;
  * ``weight_sensitivity`` — the calibration-free proxy (weight SSE);
  * ``allocate_bits`` / ``allocate_bits_joint`` — the budgeted solvers
    (bytes, or projected SAIL-machine cycles and optionally bytes);
  * ``calibrate_policy`` — score, solve, cap the segment count, and return
    the ``QuantPolicy`` with its ``BitAllocation``;
  * ``parse_bit_policy`` / ``resolve_bit_policy`` — deprecated shims over
    ``repro_torch.planning``.

The probes run ``lm.forward`` on fake-quantized f32 weights, so every
matmul in them is a plain ``torch.matmul`` (as in the reference); they run
on the device the parameters live on.  The probes never mutate ``params``:
swaps happen on the probe's own fake-quantized copies and are undone after
each forward.  The calibration tokens are the reference's
``jax.random.randint`` draw (``core.prng``), so a plan solved on the same
weights solves to the same allocation.  The solvers below the probes are
pure numpy and copied from the reference.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng, quant
from repro_torch.core.quant import SUPPORTED_ABITS, SUPPORTED_BITS
from repro_torch.planning.cost import quantizable_units

__all__ = [
    "AllocationReport", "JointAllocationReport", "Unit", "activation_sensitivity",
    "allocate_bits", "allocate_bits_joint", "calibrate_policy",
    "calibration_tokens", "enforce_max_segments", "fake_quant",
    "kv_sensitivity", "output_sensitivity", "parse_bit_policy",
    "pareto_state_filter", "quantizable_units", "resolve_bit_policy",
    "segment_count", "spec_map_from_units", "uniform_bytes", "unit_bytes",
    "weight_sensitivity",
]

# A unit key: (keystr path, layer index or None for non-stacked leaves).
UnitKey = Tuple[str, Optional[int]]


@dataclasses.dataclass(frozen=True)
class Unit:
    """One independently allocatable weight: a 2-D leaf or one layer slice
    of a stacked leaf.  ``copies`` folds extra leading dims into the byte
    accounting.  ``aerrors`` (activation precision -> predicted output
    error) is only present for joint (wbits, abits) allocation."""
    path: str
    layer: Optional[int]
    k: int
    n: int
    copies: int
    errors: Mapping[int, float]    # wbits -> predicted output error
    aerrors: Optional[Mapping[Optional[int], float]] = None

    @property
    def key(self) -> UnitKey:
        return (self.path, self.layer)


@dataclasses.dataclass(frozen=True)
class AllocationReport:
    """Solver diagnostics."""
    bits_by_unit: Dict[UnitKey, int]
    bytes_total: int
    budget_bytes: int
    predicted_error: float
    feasible: bool                 # min-bits config fit inside the budget


@dataclasses.dataclass(frozen=True)
class JointAllocationReport:
    """Joint (wbits, abits) solver diagnostics."""
    bits_by_unit: Dict[UnitKey, Tuple[int, int]]   # key -> (wbits, abits)
    bytes_total: int
    cycles_total: float
    byte_budget: Optional[int]
    cycle_budget: float
    predicted_error: float
    feasible: bool


def unit_bytes(k: int, n: int, bits: int, group_size: int,
               copies: int = 1) -> int:
    """QTensor storage bytes for one [K, N] weight (x ``copies``): packed
    words + group scales (the shared codebook is excluded, so a per-layer
    unit and a whole-leaf unit are priced consistently)."""
    from repro_torch.core.cost_model import qtensor_bytes
    return qtensor_bytes(k, n, bits, group_size, copies)


def fake_quant(w: torch.Tensor, bits: int, group_size: int,
               codebook: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Quantize->dequantize roundtrip of ``w[..., K, N]`` (looped over the
    leading dims, where the reference vmaps) — the error a SAIL-served
    matmul would see."""
    if w.ndim == 2:
        return quant.fake_quantize(w, bits, group_size, codebook)
    flat = w.reshape((-1,) + tuple(w.shape[-2:]))
    out = torch.stack([quant.fake_quantize(a, bits, group_size, codebook)
                       for a in flat])
    return out.reshape(w.shape)


def calibration_tokens(vocab: int, batch: int = 4, seq: int = 32,
                       seed: int = 0, device="cpu") -> torch.Tensor:
    """The reference's synthetic calibration batch, bit for bit
    (``jax.random.randint(PRNGKey(seed), (batch, seq), 0, vocab)``)."""
    toks = prng.randint(seed, (batch, seq), 0, vocab)
    return torch.from_numpy(toks.astype(np.int64)).to(device)


def uniform_bytes(params, policy, bits: int) -> int:
    """Total QTensor bytes of quantizing every eligible leaf at ``bits``
    (the byte budget 'uniform b-bit' occupies)."""
    total = 0
    for _, w, _ in quantizable_units(params, policy):
        k, n = w.shape[-2:]
        copies = 1
        for d in w.shape[:-2]:
            copies *= int(d)
        total += unit_bytes(int(k), int(n), bits, policy.group_size, copies)
    return total


# ---------------------------------------------------------------------------
# sensitivity scoring
# ---------------------------------------------------------------------------

def weight_sensitivity(params, policy,
                       bits_candidates: Sequence[int] = SUPPORTED_BITS,
                       per_layer: bool = True) -> Dict[UnitKey, Dict[int, float]]:
    """Calibration-free proxy: sum of squared weight reconstruction error
    per unit and candidate precision."""
    scores: Dict[UnitKey, Dict[int, float]] = {}
    for pstr, w, stacked in quantizable_units(params, policy):
        if stacked and per_layer:
            slices = [(layer, w[layer]) for layer in range(w.shape[0])]
        else:
            slices = [(None, w)]
        for layer, ws in slices:
            errs = {}
            for b in bits_candidates:
                dq = fake_quant(ws, b, policy.group_size,
                                policy.codebook_for(b))
                errs[b] = float(torch.sum((dq - ws) ** 2))
            scores[(pstr, layer)] = errs
    return scores


class _Probe:
    """One probe session: the f32 reference logits, the uniform-baseline
    fake-quantized leaves, and forwards with one leaf swapped."""

    def __init__(self, params, cfg, tokens, policy):
        from repro_torch.models import lm
        from repro_torch.models.sail_linear import _walk
        self._lm, self._walk = lm, _walk
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.tokens = torch.as_tensor(tokens).to(device=self.device,
                                                 dtype=torch.int64)
        self.forwards = 0
        self.ref = self.forward(params)
        self.units = quantizable_units(params, policy)
        self.base_bits = policy.bits
        cb = policy.codebook_for(policy.bits)
        self.base = {pstr: fake_quant(w, policy.bits, policy.group_size, cb)
                     for pstr, w, _ in self.units}
        self.err_base = self.error(self.tree())

    def forward(self, tree) -> torch.Tensor:
        self.forwards += 1
        return self._lm.forward(tree, self.tokens, self.cfg,
                                device=self.device)[0]

    def tree(self, path: Optional[str] = None, leaf=None):
        """params with every eligible leaf at the baseline, and ``path``'s
        leaf replaced by ``leaf``."""
        return self._walk(self.params, lambda p, x: leaf if p == path
                          else self.base.get(p, x))

    def error(self, tree) -> float:
        return float(torch.mean((self.forward(tree) - self.ref) ** 2))


def output_sensitivity(params, cfg, tokens, policy,
                       bits_candidates: Sequence[int] = SUPPORTED_BITS,
                       per_layer: bool = True,
                       stats: Optional[dict] = None
                       ) -> Dict[UnitKey, Dict[int, float]]:
    """Calibrated scores, centered at the uniform-``policy.bits`` model:
    the end-to-end logit MSE (vs the f32 reference) of the model with every
    eligible weight at the baseline and ONLY the probed unit moved to the
    candidate precision.  A stacked unit's layer slice is swapped into the
    baseline leaf in place and restored after its forward.  ``stats``
    (a dict) receives the number of forwards run."""
    probe = _Probe(params, cfg, tokens, policy)
    scores: Dict[UnitKey, Dict[int, float]] = {}
    for pstr, w, stacked in probe.units:
        base = probe.base[pstr]
        if stacked and per_layer:
            for layer in range(w.shape[0]):
                errs = {}
                saved = base[layer].clone()
                for b in bits_candidates:
                    if b == probe.base_bits:
                        errs[b] = probe.err_base
                        continue
                    base[layer] = fake_quant(w[layer], b, policy.group_size,
                                             policy.codebook_for(b))
                    errs[b] = probe.error(probe.tree())
                base[layer] = saved
                scores[(pstr, layer)] = errs
        else:
            errs = {}
            for b in bits_candidates:
                if b == probe.base_bits:
                    errs[b] = probe.err_base
                    continue
                dq = fake_quant(w, b, policy.group_size,
                                policy.codebook_for(b))
                errs[b] = probe.error(probe.tree(pstr, dq))
            scores[(pstr, None)] = errs
    if stats is not None:
        stats["forwards"] = stats.get("forwards", 0) + probe.forwards
    return scores


def activation_sensitivity(params, cfg, tokens, policy,
                           abits_candidates: Sequence[int] = SUPPORTED_ABITS,
                           per_layer: bool = True,
                           stats: Optional[dict] = None
                           ) -> Dict[UnitKey, Dict[Optional[int], float]]:
    """Activation-precision scores, exact-centered like the weight probes:
    the model at the uniform baseline with ONLY the probed unit's matmul
    inputs quantized to the candidate ``abits`` (an ``ActQuantWeight``
    whose per-layer gate turns the fake-quant on for one layer of a
    stack).  The ``None`` entry (f32 activations) is the baseline error."""
    from repro_torch.models.sail_linear import ActQuantWeight
    probe = _Probe(params, cfg, tokens, policy)
    dev = probe.device

    def run(pstr, gate, abits) -> float:
        wrapped = ActQuantWeight(w=probe.base[pstr],
                                 gate=torch.as_tensor(gate, dtype=torch.float32,
                                                      device=dev),
                                 abits=int(abits))
        return probe.error(probe.tree(pstr, wrapped))

    scores: Dict[UnitKey, Dict[Optional[int], float]] = {}
    for pstr, w, stacked in probe.units:
        if stacked and per_layer:
            n_layers = w.shape[0]
            for layer in range(n_layers):
                errs: Dict[Optional[int], float] = {None: probe.err_base}
                gate = np.zeros((n_layers,), np.float32)
                gate[layer] = 1.0
                for ab in abits_candidates:
                    errs[int(ab)] = run(pstr, gate, ab)
                scores[(pstr, layer)] = errs
        else:
            errs = {None: probe.err_base}
            gate = (np.ones((w.shape[0],), np.float32) if stacked
                    else np.float32(1.0))
            for ab in abits_candidates:
                errs[int(ab)] = run(pstr, gate, ab)
            scores[(pstr, None)] = errs
    if stats is not None:
        stats["forwards"] = stats.get("forwards", 0) + probe.forwards
    return scores


def _clone_cache(cache) -> Dict[str, Any]:
    return {"length": cache["length"].clone(),
            "layers": {k: v.clone() for k, v in cache["layers"].items()}}


def kv_sensitivity(params, cfg, tokens, bits: int = 8) -> Dict[str, Any]:
    """Per-layer decode-logit error from quantizing ONE layer's KV cache.

    Prefill the calibration batch with an f32 cache, take one reference
    decode step, then for each layer quantize->dequantize that layer's
    cached K and V (int8 per-head-dim absmax, the transform serving
    applies) and rerun the same decode step.  ``decode_step`` writes the
    cache in place, so every step starts from its own clone of the
    prefilled cache.  ``relative`` normalizes the summed error by the
    reference logit power — the number the Planner compares with its
    ``kv_tolerance`` to resolve ``kv_bits="auto"``.
    """
    from repro_torch.core.quant import dequantize_kv, quantize_kv
    from repro_torch.models import lm
    if bits != 8:
        raise ValueError(f"only int8 KV is served; got bits={bits}")
    if cfg.family == "ssm":
        raise ValueError("kv_sensitivity needs an attention family "
                         f"(family={cfg.family!r} has no KV cache)")
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    b, t = tokens.shape
    logits, cache = lm.prefill(params, tokens, cfg, cache_len=t + 1,
                               quant_kv=False, device=dev)
    tok = torch.argmax(logits, dim=-1)[:, None]
    ref, _ = lm.decode_step(params, tok, _clone_cache(cache), cfg,
                            device=dev)
    denom = float(torch.mean(ref ** 2))
    layers = cache["layers"]
    per_layer = []
    for i in range(int(layers["k"].shape[0])):
        probed = _clone_cache(cache)
        for name in ("k", "v"):
            probed["layers"][name][i] = dequantize_kv(
                *quantize_kv(layers[name][i]))
        lg, _ = lm.decode_step(params, tok, probed, cfg, device=dev)
        per_layer.append(float(torch.mean((lg - ref) ** 2)))
    total = float(sum(per_layer))
    return {"bits": int(bits), "per_layer": per_layer, "total": total,
            "relative": total / max(denom, 1e-30)}


# ---------------------------------------------------------------------------
# greedy budgeted allocation (pure numpy; copied from the reference)
# ---------------------------------------------------------------------------

def allocate_bits(units: Sequence[Unit], budget_bytes: int,
                  group_size: int,
                  bits_candidates: Sequence[int] = SUPPORTED_BITS,
                  pinned: Optional[Mapping[UnitKey, int]] = None
                  ) -> AllocationReport:
    """Greedy knapsack: start every free unit at the narrowest candidate,
    then repeatedly apply the upgrade with the best error-reduction per
    extra byte that still fits the budget (upgrades may jump several
    precisions, so non-monotone error ladders cannot wedge the solver),
    from several starts, then pairwise down/up swaps."""
    cand = sorted(set(int(b) for b in bits_candidates))
    pinned = dict(pinned or {})
    free = [u for u in units if u.key not in pinned]

    def bytes_at(u: Unit, b: int) -> int:
        return unit_bytes(u.k, u.n, b, group_size, u.copies)

    def climb(start_bits: int):
        current: Dict[UnitKey, int] = {}
        total = 0
        for u in units:
            b = pinned.get(u.key, start_bits)
            current[u.key] = b
            total += bytes_at(u, b)
        if total > budget_bytes:
            return None
        while True:
            best = None  # (ratio, delta_err, key_tiebreak, new_bits)
            for u in free:
                cur = current[u.key]
                err_cur = u.errors[cur]
                for b in cand:
                    if b <= cur:
                        continue
                    db = bytes_at(u, b) - bytes_at(u, cur)
                    if db <= 0 or total + db > budget_bytes:
                        continue
                    de = err_cur - u.errors[b]
                    if de <= 0:
                        continue
                    pick = (de / db, de, u.key, b)
                    if best is None or pick > best:
                        best = pick
            if best is None:
                break
            _, _, key, b = best
            u = next(x for x in free if x.key == key)
            total += bytes_at(u, b) - bytes_at(u, current[key])
            current[key] = b
        total = swap_refine(current, total)
        predicted = sum(u.errors[current[u.key]] for u in units)
        return current, total, predicted

    def swap_refine(current: Dict[UnitKey, int], total: int) -> int:
        """Pairwise trades: downgrade one unit to fund upgrading another."""
        while True:
            best = None  # (net_err_delta, key_down, bits_down, key_up, bits_up)
            for ud in free:
                cur_d = current[ud.key]
                for bd in cand:
                    if bd >= cur_d:
                        continue
                    saved = bytes_at(ud, cur_d) - bytes_at(ud, bd)
                    loss = ud.errors[bd] - ud.errors[cur_d]
                    for uu in free:
                        if uu.key == ud.key:
                            continue
                        cur_u = current[uu.key]
                        for bu in cand:
                            if bu <= cur_u:
                                continue
                            cost = bytes_at(uu, bu) - bytes_at(uu, cur_u)
                            if total - saved + cost > budget_bytes:
                                continue
                            net = loss + uu.errors[bu] - uu.errors[cur_u]
                            pick = (net, ud.key, bd, uu.key, bu)
                            if net < 0 and (best is None or pick < best):
                                best = pick
            if best is None:
                return total
            _, kd, bd, ku, bu = best
            ud = next(x for x in free if x.key == kd)
            uu = next(x for x in free if x.key == ku)
            total += (bytes_at(ud, bd) - bytes_at(ud, current[kd])
                      + bytes_at(uu, bu) - bytes_at(uu, current[ku]))
            current[kd] = bd
            current[ku] = bu

    solutions = [s for s in (climb(b) for b in cand) if s is not None]
    if not solutions:
        current = {u.key: pinned.get(u.key, cand[0]) for u in units}
        total = sum(bytes_at(u, current[u.key]) for u in units)
        predicted = sum(u.errors[current[u.key]] for u in units)
        return AllocationReport(bits_by_unit=current, bytes_total=total,
                                budget_bytes=int(budget_bytes),
                                predicted_error=predicted, feasible=False)
    current, total, predicted = min(solutions, key=lambda s: (s[2], s[1]))
    return AllocationReport(bits_by_unit=current, bytes_total=total,
                            budget_bytes=int(budget_bytes),
                            predicted_error=predicted, feasible=True)


def pareto_state_filter(states, err_of, cyc_of, byte_of=None):
    """Drop states strictly dominated in (error, cycles[, bytes]): a state
    another beats-or-ties on every objective (and beats on one) can never
    be part of a better allocation."""
    scored = [
        (s, err_of(s), cyc_of(s), byte_of(s) if byte_of is not None else 0)
        for s in states
    ]
    kept = []
    for s, e, c, b in scored:
        dominated = False
        for t, e2, c2, b2 in scored:
            if t == s:
                continue
            if e2 <= e and c2 <= c and b2 <= b and (e2 < e or c2 < c or b2 < b):
                dominated = True
                break
        if not dominated:
            kept.append(s)
    return kept


def allocate_bits_joint(units: Sequence[Unit], cycle_budget: float,
                        group_size: int,
                        byte_budget: Optional[int] = None,
                        bits_candidates: Sequence[int] = SUPPORTED_BITS,
                        abits_candidates: Sequence[int] = SUPPORTED_ABITS,
                        pinned: Optional[Mapping[UnitKey, int]] = None,
                        pinned_act: Optional[Mapping[UnitKey, int]] = None,
                        batch: int = 8, threads: int = 16,
                        machine=None, prt="paper", calib=None,
                        prune_states: bool = True
                        ) -> JointAllocationReport:
    """Joint (wbits, abits) allocation under a projected-cycles budget
    (SAIL machine cycles, ``core.cost_model``) and optionally a byte
    budget: each unit priced at its own cycle-optimal NBW and, under
    ``prt="measured"``, its own layer's PRT hit rate (``calib`` may map
    layers to batches).  Multi-start greedy climbs, then pairwise swaps,
    over each unit's Pareto frontier of states."""
    from repro_torch.core import cost_model as cm
    from repro_torch.core import pattern as _pattern
    m = machine or cm.SailMachine()
    calib = _pattern.canonical_calib(calib)
    wcand = sorted(set(int(b) for b in bits_candidates))
    acand = sorted(set(int(b) for b in abits_candidates))
    states = [(wb, ab) for wb in wcand for ab in acand]
    pinned = dict(pinned or {})
    pinned_act = dict(pinned_act or {})

    for u in units:
        if u.aerrors is None:
            raise ValueError(f"unit {u.key} has no activation scores "
                             "(aerrors) — run activation_sensitivity")

    bytes_tab: Dict[Tuple[UnitKey, int], int] = {}
    cyc_tab: Dict[Tuple[UnitKey, Tuple[int, int]], float] = {}
    for u in units:
        ucalib = _pattern.calib_for_layer(calib, u.layer)
        for wb in wcand:
            bytes_tab[(u.key, wb)] = unit_bytes(u.k, u.n, wb, group_size,
                                                u.copies)
        for s in states:
            wb, ab = s
            _, cyc = cm._best_nbw_and_cycles(u.k, u.n, wb, ab, batch,
                                             threads, m, prt, ucalib)
            cyc_tab[(u.key, s)] = u.copies * cyc

    def err(u: Unit, s: Tuple[int, int]) -> float:
        return u.errors[s[0]] + u.aerrors[s[1]]

    _states_cache: Dict[UnitKey, list] = {}

    def unit_states(u: Unit):
        got = _states_cache.get(u.key)
        if got is not None:
            return got
        wfix = pinned.get(u.key)
        afix = pinned_act.get(u.key)
        opts = [(wb, ab) for wb, ab in states
                if (wfix is None or wb == wfix)
                and (afix is None or ab == afix)]
        if prune_states and len(opts) > 2:
            opts = pareto_state_filter(
                opts, lambda s: err(u, s), lambda s: cyc_tab[(u.key, s)],
                (lambda s: bytes_tab[(u.key, s[0])])
                if byte_budget is not None else None)
        _states_cache[u.key] = opts
        return opts

    free = [u for u in units
            if len(unit_states(u)) > 1]

    def totals(current):
        by = sum(bytes_tab[(k, s[0])] for k, s in current.items())
        cy = sum(cyc_tab[(k, s)] for k, s in current.items())
        return by, cy

    def fits(by, cy):
        return (cy <= cycle_budget
                and (byte_budget is None or by <= byte_budget))

    def norm_cost(key, s) -> float:
        c = cyc_tab[(key, s)] / max(cycle_budget, 1e-9)
        if byte_budget is not None:
            c += bytes_tab[(key, s[0])] / max(byte_budget, 1)
        return c

    def min_state(u: Unit):
        return min(unit_states(u), key=lambda s: (norm_cost(u.key, s),
                                                  err(u, s)))

    def climb(start: Tuple[int, int]):
        current: Dict[UnitKey, Tuple[int, int]] = {}
        for u in units:
            opts = unit_states(u)
            current[u.key] = start if start in opts else min_state(u)
        by, cy = totals(current)
        if not fits(by, cy):
            return None
        while True:
            best = None  # (ratio, de, key, state)
            for u in free:
                cur = current[u.key]
                e_cur = err(u, cur)
                c_cur = norm_cost(u.key, cur)
                for s in unit_states(u):
                    if s == cur:
                        continue
                    de = e_cur - err(u, s)
                    if de <= 0:
                        continue
                    nby = by + bytes_tab[(u.key, s[0])] - \
                        bytes_tab[(u.key, cur[0])]
                    ncy = cy + cyc_tab[(u.key, s)] - cyc_tab[(u.key, cur)]
                    if not fits(nby, ncy):
                        continue
                    dc = norm_cost(u.key, s) - c_cur
                    ratio = de / dc if dc > 1e-12 else float("inf")
                    pick = (ratio, de, u.key, s)
                    if best is None or pick > best:
                        best = pick
            if best is None:
                break
            _, _, key, s = best
            by += bytes_tab[(key, s[0])] - bytes_tab[(key, current[key][0])]
            cy += cyc_tab[(key, s)] - cyc_tab[(key, current[key])]
            current[key] = s
        by, cy = swap_refine(current, by, cy)
        predicted = sum(err(u, current[u.key]) for u in units)
        return current, by, cy, predicted

    def swap_refine(current, by, cy):
        """Pairwise trades: move one unit to a cheaper state to fund a
        more accurate state elsewhere."""
        while True:
            best = None  # (net_err_delta, key_d, s_d, key_u, s_u)
            for ud in free:
                cur_d = current[ud.key]
                for sd in unit_states(ud):
                    d_by = bytes_tab[(ud.key, sd[0])] - \
                        bytes_tab[(ud.key, cur_d[0])]
                    d_cy = cyc_tab[(ud.key, sd)] - cyc_tab[(ud.key, cur_d)]
                    if d_cy >= 0 and d_by >= 0:
                        continue   # not a funding move
                    loss = err(ud, sd) - err(ud, cur_d)
                    for uu in free:
                        if uu.key == ud.key:
                            continue
                        cur_u = current[uu.key]
                        for su in unit_states(uu):
                            gain = err(uu, cur_u) - err(uu, su)
                            if gain <= 0:
                                continue
                            nby = by + d_by + \
                                bytes_tab[(uu.key, su[0])] - \
                                bytes_tab[(uu.key, cur_u[0])]
                            ncy = cy + d_cy + \
                                cyc_tab[(uu.key, su)] - \
                                cyc_tab[(uu.key, cur_u)]
                            if not fits(nby, ncy):
                                continue
                            net = loss - gain
                            pick = (net, ud.key, sd, uu.key, su)
                            if net < -1e-15 and (best is None
                                                 or pick < best):
                                best = pick
            if best is None:
                return by, cy
            _, kd, sd, ku, su = best
            by += (bytes_tab[(kd, sd[0])] - bytes_tab[(kd, current[kd][0])]
                   + bytes_tab[(ku, su[0])]
                   - bytes_tab[(ku, current[ku][0])])
            cy += (cyc_tab[(kd, sd)] - cyc_tab[(kd, current[kd])]
                   + cyc_tab[(ku, su)] - cyc_tab[(ku, current[ku])])
            current[kd] = sd
            current[ku] = su

    solutions = [s for s in (climb(st) for st in states) if s is not None]
    if not solutions:
        current = {u.key: min_state(u) for u in units}
        by, cy = totals(current)
        predicted = sum(err(u, current[u.key]) for u in units)
        return JointAllocationReport(
            bits_by_unit=current, bytes_total=by, cycles_total=cy,
            byte_budget=byte_budget, cycle_budget=float(cycle_budget),
            predicted_error=predicted, feasible=False)
    current, by, cy, predicted = min(solutions,
                                     key=lambda s: (s[3], s[2], s[1]))
    return JointAllocationReport(
        bits_by_unit=current, bytes_total=by, cycles_total=cy,
        byte_budget=byte_budget, cycle_budget=float(cycle_budget),
        predicted_error=predicted, feasible=True)


def spec_map_from_units(assign: Mapping[UnitKey, int]) -> Dict[str, Any]:
    """{(path, layer): bits} -> {path: bits | per-layer tuple}."""
    per_path: Dict[str, Any] = {}
    layered: Dict[str, Dict[int, int]] = {}
    for (path, layer), b in assign.items():
        if layer is None:
            per_path[path] = int(b)
        else:
            layered.setdefault(path, {})[layer] = int(b)
    for path, by_layer in layered.items():
        n_layers = max(by_layer) + 1
        if set(by_layer) != set(range(n_layers)):
            raise ValueError(f"allocation for {path} misses layers: "
                             f"{sorted(by_layer)}")
        per_path[path] = tuple(by_layer[i] for i in range(n_layers))
    return per_path


def _allocation_from_units(bits_by_unit: Mapping[UnitKey, Any]):
    """Unit assignment -> BitAllocation (scalar wbits, or (wbits, abits)
    pairs that also fill ``act_per_path``)."""
    from repro_torch.models.sail_linear import BitAllocation
    joint = any(isinstance(b, (tuple, list))
                for b in bits_by_unit.values())
    if not joint:
        return BitAllocation(per_path=spec_map_from_units(bits_by_unit))
    return BitAllocation(
        per_path=spec_map_from_units(
            {k: s[0] for k, s in bits_by_unit.items()}),
        act_per_path=spec_map_from_units(
            {k: s[1] for k, s in bits_by_unit.items()}))


def _segment_cuts(assign: Mapping[UnitKey, Any], paths, n_layers
                  ) -> List[int]:
    """Layer cut points of an assignment: a cut wherever ANY stacked
    path's state differs between adjacent layers (the rule
    ``sail_linear._segment_bounds`` applies to the emitted policy)."""
    cuts = [0]
    for layer in range(1, n_layers):
        if any(assign.get((p, layer)) != assign.get((p, layer - 1))
               for p in paths):
            cuts.append(layer)
    cuts.append(n_layers)
    return cuts


def segment_count(assign: Mapping[UnitKey, Any]) -> int:
    """Number of uniform-precision layer segments an assignment implies."""
    layers = sorted({k[1] for k in assign if k[1] is not None})
    if not layers:
        return 1
    paths = sorted({k[0] for k in assign if k[1] is not None})
    return len(_segment_cuts(assign, paths, max(layers) + 1)) - 1


def enforce_max_segments(units: Sequence[Unit],
                         assign: Dict[UnitKey, Any],
                         max_segments: int,
                         err_of=None,
                         bytes_of=None) -> Dict[UnitKey, Any]:
    """Cap the number of layer segments by merging adjacent segments: while
    over the cap, coalesce the adjacent pair whose merge costs the least
    predicted error (per stacked path the merged range adopts whichever
    side's state raises the summed error least; with ``bytes_of``, a
    direction that grows the bytes only when no byte-neutral one exists).
    """
    if max_segments < 1:
        raise ValueError(f"max_segments must be >= 1, got {max_segments}")
    if err_of is None:
        def err_of(u, s):
            if isinstance(s, (tuple, list)):
                return u.errors[s[0]] + u.aerrors[s[1]]
            return u.errors[s]
    assign = dict(assign)
    by_key = {u.key: u for u in units}
    paths = sorted({k[0] for k in assign if k[1] is not None})
    layers = sorted({k[1] for k in assign if k[1] is not None})
    if not layers:
        return assign
    n_layers = max(layers) + 1

    while True:
        cuts = _segment_cuts(assign, paths, n_layers)
        if len(cuts) - 1 <= max_segments:
            return assign
        best = None   # (err_delta, cut_index, {(path, layer): state})
        for i in range(1, len(cuts) - 1):
            a, b, c = cuts[i - 1], cuts[i], cuts[i + 1]
            delta = 0.0
            moves: Dict[UnitKey, Any] = {}
            for p in paths:
                lv, rv = assign[(p, a)], assign[(p, b)]
                if lv == rv:
                    continue
                d_left = sum(err_of(by_key[(p, layer)], lv)
                             - err_of(by_key[(p, layer)],
                                      assign[(p, layer)])
                             for layer in range(b, c))
                d_right = sum(err_of(by_key[(p, layer)], rv)
                              - err_of(by_key[(p, layer)],
                                       assign[(p, layer)])
                              for layer in range(a, b))
                take_left = d_left <= d_right
                if bytes_of is not None:
                    b_left = sum(bytes_of(by_key[(p, layer)], lv)
                                 - bytes_of(by_key[(p, layer)],
                                            assign[(p, layer)])
                                 for layer in range(b, c))
                    b_right = sum(bytes_of(by_key[(p, layer)], rv)
                                  - bytes_of(by_key[(p, layer)],
                                             assign[(p, layer)])
                                  for layer in range(a, b))
                    if b_left > 0 and b_right <= 0:
                        take_left = False
                    elif b_right > 0 and b_left <= 0:
                        take_left = True
                if take_left:
                    delta += d_left
                    for layer in range(b, c):
                        moves[(p, layer)] = lv
                else:
                    delta += d_right
                    for layer in range(a, b):
                        moves[(p, layer)] = rv
            if best is None or (delta, i) < best[:2]:
                best = (delta, i, moves)
        assign.update(best[2])


def _tokens_from_calib_batches(calib_batches) -> torch.Tensor:
    """Held-out token batches -> one [B, T] calibration tensor: a single
    [B, T] array or a sequence of [b_i, T] arrays, concatenated."""
    if isinstance(calib_batches, (list, tuple)):
        arrs = [np.asarray(b) for b in calib_batches]
        widths = {a.shape[-1] for a in arrs}
        if len(widths) != 1:
            raise ValueError(
                f"calib_batches have mixed sequence lengths {widths}")
        arr = np.concatenate([a.reshape(-1, a.shape[-1]) for a in arrs], 0)
    else:
        arr = np.asarray(calib_batches)
        if arr.ndim == 1:
            arr = arr[None]
    return torch.from_numpy(arr.astype(np.int64))


def calibrate_policy(params, cfg, policy=None, budget_bytes=None,
                     match_uniform: Optional[int] = None,
                     budget_bpw: Optional[float] = None,
                     tokens=None, mode: str = "output",
                     bits_candidates: Sequence[int] = SUPPORTED_BITS,
                     per_layer: bool = True, calib_batch: int = 4,
                     calib_seq: int = 32, scores=None,
                     calib_batches=None,
                     abits_candidates: Optional[Sequence[int]] = None,
                     act_scores=None, cycle_budget: Optional[float] = None,
                     match_uniform_abits: int = 8,
                     prt="paper", prt_calib=None, cost_batch: int = 8,
                     cost_threads: int = 16, machine=None,
                     max_segments: Optional[int] = None):
    """Score sensitivities and solve the budgeted allocation.

    Weight-only (default): minimize total predicted error subject to
    ``bytes <= budget`` (``budget_bytes``, ``match_uniform=b`` or
    ``budget_bpw``).  Joint (``abits_candidates`` given): also allocate
    activation precision per unit under a projected-cycles budget
    (``cycle_budget``, by default the uniform ``(match_uniform or
    policy.bits, match_uniform_abits)`` reference's cycles), the byte
    budget enforced only when explicit.  ``scores`` / ``act_scores`` skip
    the probing; paths matched by ``policy.rules`` / ``act_rules`` are
    pinned; ``max_segments`` caps the layer segments.  The probes run on
    the device ``params`` live on.

    Returns ``(policy_with_allocation, AllocationReport |
    JointAllocationReport)``.
    """
    from repro_torch.models.sail_linear import QuantPolicy
    policy = policy or QuantPolicy()
    joint = abits_candidates is not None
    if not joint and prt not in ("paper", True):
        raise ValueError(
            f"prt={prt!r} only affects the joint (wbits, abits) cycle "
            "budget — a weight-only allocation is priced in bytes, so "
            "the option would be silently ignored; add a<ab> to the "
            "spec (abits_candidates=) to enable joint mode")
    if calib_batches is not None and tokens is None:
        tokens = _tokens_from_calib_batches(calib_batches)
    if scores is not None:
        pass
    elif mode == "output":
        if tokens is None:
            tokens = calibration_tokens(cfg.vocab, calib_batch, calib_seq)
        scores = output_sensitivity(params, cfg, tokens, policy,
                                    bits_candidates, per_layer)
    elif mode == "weight":
        if joint:
            raise ValueError(
                "joint (wbits, abits) allocation requires mode='output': "
                "weight_sensitivity scores are weight-space SSE while "
                "activation probes are logit MSE — summing them would let "
                "the larger scale silently dominate the trade-off")
        scores = weight_sensitivity(params, policy, bits_candidates,
                                    per_layer)
    else:
        raise ValueError(f"mode must be 'output' or 'weight', got {mode}")
    if joint and act_scores is None:
        if tokens is None:
            tokens = calibration_tokens(cfg.vocab, calib_batch, calib_seq)
        act_scores = activation_sensitivity(params, cfg, tokens, policy,
                                            abits_candidates, per_layer)

    units: List[Unit] = []
    pinned: Dict[UnitKey, int] = {}
    pinned_act: Dict[UnitKey, int] = {}
    total_weights = 0
    for pstr, w, stacked in quantizable_units(params, policy):
        k, n = int(w.shape[-2]), int(w.shape[-1])
        per_slice_copies = 1
        for d in w.shape[1:-2]:
            per_slice_copies *= int(d)
        total_weights += int(w.numel())
        keys = ([(pstr, layer) for layer in range(w.shape[0])]
                if stacked and per_layer else [(pstr, None)])
        copies = (per_slice_copies if stacked and per_layer
                  else per_slice_copies * (int(w.shape[0]) if stacked
                                           else 1))
        rule_bits = None
        for pat, b in policy.rules:
            if re.search(pat, pstr):
                rule_bits = int(b)
                if rule_bits not in bits_candidates:
                    raise ValueError(
                        f"rule ({pat!r}, {b}) pins {pstr} outside the "
                        f"scored candidates {tuple(bits_candidates)}")
                break
        act_rule_bits = None
        if joint:
            for pat, b in policy.act_rules:
                if re.search(pat, pstr):
                    act_rule_bits = int(b)
                    if act_rule_bits not in abits_candidates:
                        raise ValueError(
                            f"act rule ({pat!r}, {b}) pins {pstr} outside "
                            f"the scored candidates "
                            f"{tuple(abits_candidates)}")
                    break
        for key in keys:
            units.append(Unit(path=pstr, layer=key[1], k=k, n=n,
                              copies=copies, errors=scores[key],
                              aerrors=(act_scores[key] if joint
                                       else None)))
            if rule_bits is not None:
                pinned[key] = rule_bits
            if act_rule_bits is not None:
                pinned_act[key] = act_rule_bits

    # a bpw request is an explicit byte budget too
    explicit_bytes = budget_bytes is not None or budget_bpw is not None
    if budget_bytes is None:
        if match_uniform is not None:
            budget_bytes = uniform_bytes(params, policy, match_uniform)
        elif budget_bpw is not None:
            budget_bytes = int(budget_bpw * total_weights / 8)
        else:
            budget_bytes = uniform_bytes(params, policy, policy.bits)

    if joint:
        from repro_torch.core import cost_model as cm
        if prt == "measured" and prt_calib is None and tokens is not None \
                and isinstance(params, dict) and "embed" in params:
            # the calibration tokens' embedding vectors stand in for
            # hidden activations (one PRT compute batch worth)
            emb = params["embed"][torch.as_tensor(tokens).to(
                device=params["embed"].device, dtype=torch.int64)]
            emb = emb.detach().float().cpu().numpy()
            prt_calib = emb.reshape(-1, emb.shape[-1])[:cost_batch]
        if cycle_budget is None:
            ref_wb = match_uniform if match_uniform is not None \
                else policy.bits
            cycle_budget = cm.mixed_decode_cycles(
                [(u.k, u.n, ref_wb, match_uniform_abits, u.copies)
                 for u in units],
                machine=machine or cm.SailMachine(), batch=cost_batch,
                nbw="auto", threads=cost_threads, prt=prt,
                calib=prt_calib)
        report = allocate_bits_joint(
            units, cycle_budget, policy.group_size,
            byte_budget=budget_bytes if explicit_bytes else None,
            bits_candidates=bits_candidates,
            abits_candidates=abits_candidates,
            pinned=pinned, pinned_act=pinned_act, batch=cost_batch,
            threads=cost_threads, machine=machine, prt=prt,
            calib=prt_calib)
    else:
        report = allocate_bits(units, budget_bytes, policy.group_size,
                               bits_candidates, pinned)
    assign = dict(report.bits_by_unit)
    if max_segments is not None:
        def seg_bytes(u, s):
            return unit_bytes(u.k, u.n, s[0] if joint else s,
                              policy.group_size, u.copies)

        capped = enforce_max_segments(units, assign, max_segments,
                                      bytes_of=seg_bytes)
        if capped != assign:
            assign = capped
            nbytes = sum(unit_bytes(
                u.k, u.n,
                assign[u.key][0] if joint else assign[u.key],
                policy.group_size, u.copies) for u in units)
            err = sum(
                (u.errors[assign[u.key][0]] + u.aerrors[assign[u.key][1]])
                if joint else u.errors[assign[u.key]]
                for u in units)
            # merging adopts a neighbour's state, so the capped assignment
            # can leave the budgets: re-derive feasible
            if joint:
                cycles = cm.mixed_decode_cycles(
                    [(u.k, u.n, assign[u.key][0], assign[u.key][1],
                      u.copies) for u in units],
                    machine=machine or cm.SailMachine(), batch=cost_batch,
                    nbw="auto", threads=cost_threads, prt=prt,
                    calib=prt_calib)
                ok = (cycles <= report.cycle_budget * (1 + 1e-9)
                      and (report.byte_budget is None
                           or nbytes <= report.byte_budget))
                report = dataclasses.replace(
                    report, bits_by_unit=assign, bytes_total=nbytes,
                    cycles_total=cycles, predicted_error=err,
                    feasible=report.feasible and ok)
            else:
                report = dataclasses.replace(
                    report, bits_by_unit=assign, bytes_total=nbytes,
                    predicted_error=err,
                    feasible=(report.feasible
                              and nbytes <= report.budget_bytes))
    allocation = _allocation_from_units(assign)
    return dataclasses.replace(policy, allocation=allocation), report


# ---------------------------------------------------------------------------
# deprecated shims over repro_torch.planning (the legacy bit_policy surface)
# ---------------------------------------------------------------------------

def parse_bit_policy(spec: str) -> Dict[str, Any]:
    """DEPRECATED: use ``repro_torch.planning.PlanSpec.parse``; returns the
    legacy dict form of the parsed plan."""
    import warnings

    from repro_torch.planning import PlanSpec
    warnings.warn(
        "parse_bit_policy is deprecated; use repro_torch.planning."
        "PlanSpec.parse (the dict form it returns is the legacy "
        "EngineConfig.bit_policy surface)", DeprecationWarning,
        stacklevel=2)
    return PlanSpec.parse(spec).to_legacy_dict()


def resolve_bit_policy(bit_policy, params, cfg, base):
    """DEPRECATED: use ``repro_torch.planning.resolve_plan``.

    EngineConfig.bit_policy (None | str | dict | QuantPolicy) -> the
    QuantPolicy to quantize with; auto modes run the calibration."""
    import warnings

    warnings.warn(
        "resolve_bit_policy is deprecated; use repro_torch.planning."
        "resolve_plan (EngineConfig.plan)", DeprecationWarning,
        stacklevel=2)
    return _resolve_policy_like(bit_policy, params, cfg, base)


def _resolve_policy_like(bit_policy, params, cfg, base):
    """Shared resolution for the legacy ``bit_policy`` surface (no
    deprecation warning: ``Engine`` warns once itself)."""
    from repro_torch import planning
    from repro_torch.models.sail_linear import QuantPolicy
    if bit_policy is None:
        return base
    if isinstance(bit_policy, QuantPolicy):
        return bit_policy
    if isinstance(bit_policy, str):
        return planning.resolve_plan(
            planning.PlanSpec.parse(bit_policy), params, cfg,
            base=base).policy
    if not isinstance(bit_policy, Mapping):
        raise TypeError(f"bit_policy must be None/str/dict/QuantPolicy, "
                        f"got {type(bit_policy)!r}")
    mode = bit_policy.get("mode", "spec")
    if mode in ("uniform", "rules", "auto"):
        try:
            plan = planning.PlanSpec.from_legacy_dict(bit_policy)
        except ValueError:
            if mode != "auto":
                raise
            # auto dicts may carry calibrate_policy kwargs that have no
            # PlanSpec field (calib_batch, budget_bytes, ...): forward them
            spec = dict(bit_policy)
            spec.pop("mode")
            abits = spec.pop("abits", None)
            if abits is not None:
                spec.setdefault("abits_candidates", SUPPORTED_ABITS)
                spec.setdefault("match_uniform_abits", int(abits))
            policy, _ = calibrate_policy(params, cfg, base, **spec)
            return policy
        return planning.resolve_plan(plan, params, cfg, base=base).policy
    if mode == "spec":
        spec = {k: v for k, v in bit_policy.items() if k != "mode"}
        return QuantPolicy.from_spec({
            "bits": base.bits, "group_size": base.group_size,
            "min_size": base.min_size, "skip_embed": base.skip_embed,
            **spec})
    raise ValueError(f"unknown bit_policy mode {mode!r}")
