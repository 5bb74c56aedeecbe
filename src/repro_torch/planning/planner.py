"""Planner: solve, price, and re-solve PlanSpecs (port of
``repro.planning.planner``).

``Planner.solve`` turns an *auto* ``PlanSpec`` into a solved one: it probes
the model once (``core.sensitivity``'s output, activation and KV probes,
cached on the planner) and solves the budgeted allocation.  With an
:class:`~repro_torch.planning.cost.Slo` the joint solver's cycle AND byte
budgets come from the target decode tokens/s; without one the budget is
match-uniform bytes or bits per weight.  ``Planner.replan`` consumes the
per-layer activation batches an ``ActivationTap`` captured inside
``Engine.step()`` and re-prices the plan under PRT discounts measured on
them (and, with ``resolve=True``, re-solves the allocation).

Every price here is the SAIL machine model's (``DecodeCostModel``), or the
effective machine a ``calibrate_cost`` fit describes when the plan carries
one — never the card's.

Invariants:

- ``solve`` is deterministic for given (params, plan, slo, calib): the
  calibration tokens are the reference's seeded draw and the probes are
  cached, so repeated solves return the same spec.
- A returned ``PlanResult.spec`` is always *solved*: ``auto`` modes carry
  ``weights_per_unit`` / ``acts_per_unit``, ``kv_bits="auto"`` resolves to
  8 or 32 (the per-layer KV probe against ``kv_tolerance``) and
  ``tp="auto"`` to the smallest priced shard count meeting the SLO (1
  without one).  ``draft="auto"`` needs speculative decoding, not ported
  (ROADMAP, Queue 1 item 3).
- ``replan`` never changes the served allocation unless ``resolve=True``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

from repro_torch.core import pattern
from repro_torch.core import sensitivity as sens
from repro_torch.planning.cost import (DecodeCostModel, PlanCost, Slo,
                                       dispatch_from_json, machine_from_json,
                                       unquantized_bytes)
from repro_torch.planning.spec import PlanSpec


@dataclasses.dataclass
class PlanResult:
    """One solved plan: the spec (source of truth), the servable policy,
    solver diagnostics, and the modeled cost on the SAIL machine."""

    spec: PlanSpec
    policy: Any
    report: Any = None
    cost: Optional[PlanCost] = None
    budgets: Any = None
    measured_prt_hit_rate: Optional[float] = None
    # per-layer KV quantization probe (when the plan asked kv_bits="auto")
    kv_sensitivity: Optional[dict] = None

    @property
    def meets_slo(self) -> Optional[bool]:
        if self.spec.target_tps is None or self.cost is None:
            return None
        return self.cost.tokens_per_second >= self.spec.target_tps * (1 - 1e-9)


def _solver_prt(prt: str):
    """PlanSpec prt mode -> the cost model's switch values."""
    return False if prt == "off" else prt


def plan_cost_model(plan: PlanSpec, **kw) -> DecodeCostModel:
    """The DecodeCostModel a plan is priced with: its PRT mode and NBW,
    and its fitted machine when it carries calibration provenance."""
    kw = dict(kw, prt=_solver_prt(plan.prt), nbw=plan.nbw)
    if plan.calibration is not None:
        kw["machine"] = machine_from_json(plan.calibration)
        disp = dispatch_from_json(plan.calibration)
        if disp is not None:
            kw["dispatch_cycles"] = disp
    return DecodeCostModel(**kw)


class Planner:
    """Solves one model's precision plans against one cost model.  The
    probes run on the device ``params`` live on."""

    def __init__(
        self,
        params,
        cfg,
        plan: PlanSpec | str | None = None,
        base=None,
        cost: Optional[DecodeCostModel] = None,
        tokens=None,
        scores=None,
        act_scores=None,
        kv_tolerance: float = 0.05,
    ):
        from repro_torch.models.sail_linear import QuantPolicy

        self.params = params
        self.cfg = cfg
        if isinstance(plan, str):
            plan = PlanSpec.parse(plan)
        self.plan = plan if plan is not None else PlanSpec(mode="auto", act_bits=8)
        self.base = base or QuantPolicy(
            bits=self.plan.weight_bits or 4,
            group_size=self.plan.group_size or 128,
            min_size=self.plan.min_size or 65536,
        )
        self.cost = cost if cost is not None else plan_cost_model(self.plan)
        self._tokens = tokens
        self._scores = scores
        self._act_scores = act_scores
        self.kv_tolerance = kv_tolerance
        self._kv_scores: Optional[dict] = None
        self._fixed_bytes: Optional[int] = None
        # probe forwards run so far (output + activation probes)
        self.probe_stats: dict = {}
        self.last: Optional[PlanResult] = None

    # -- probe caching ----------------------------------------------------

    def _calib_tokens(self):
        if self._tokens is None:
            self._tokens = sens.calibration_tokens(self.cfg.vocab)
        return self._tokens

    def _ensure_scores(self, joint: bool) -> None:
        tokens = self._calib_tokens()
        if self._scores is None:
            self._scores = sens.output_sensitivity(
                self.params, self.cfg, tokens, self.base, stats=self.probe_stats)
        if joint and self._act_scores is None:
            self._act_scores = sens.activation_sensitivity(
                self.params, self.cfg, tokens, self.base, stats=self.probe_stats
            )

    def fixed_bytes(self) -> int:
        """DRAM bytes of the leaves the plan cannot allocate (cached)."""
        if self._fixed_bytes is None:
            self._fixed_bytes = unquantized_bytes(self.params, self.base)
        return self._fixed_bytes

    def _tp_cost(self, cost: DecodeCostModel, plan: PlanSpec) -> DecodeCostModel:
        """Apply a plan's tensor-parallel knobs to a cost model: shard
        count, wire precision, and the model's all-reduce payload."""
        tp = plan.tp if isinstance(plan.tp, int) else 1
        if tp <= 1 and plan.wire is None:
            return cost
        from repro_torch.planning.cost import tp_allreduce_elems

        return dataclasses.replace(
            cost,
            tp=max(tp, 1),
            wire_bits=plan.wire if plan.wire is not None else 32,
            allreduce_elems=(float(tp_allreduce_elems(self.cfg)) if tp > 1 else 0.0),
        )

    def budgets(self, slo: Slo, plan: Optional[PlanSpec] = None):
        """SLO -> (seconds, cycle budget, byte budget); monotone in the
        target.  With a tensor-parallel plan the budgets are per shard."""
        cost = dataclasses.replace(self.cost, batch=slo.batch)
        if plan is not None:
            cost = self._tp_cost(cost, plan)
        return cost.budgets(slo, self.fixed_bytes())

    # -- solving ----------------------------------------------------------

    def solve(
        self, slo: Optional[Slo] = None, calib=None, plan: Optional[PlanSpec] = None
    ) -> PlanResult:
        """Solve the plan (optionally under an SLO) and price the result.

        ``calib``: measured activation batches for ``prt="measured"``
        pricing — one f32 [B, K] array or an ``ActivationTap.calib()``
        per-layer mapping; defaults to the cost model's batch.
        """
        plan = plan or self.plan
        kv_scores = None
        if plan.kv_bits == "auto":
            plan, kv_scores = self._resolve_kv(plan)
        if plan.tp == "auto":
            if slo is None and plan.target_tps is not None:
                slo = Slo(plan.target_tps, plan.slo_batch or self.cost.batch)
            plan = self._resolve_tp(plan, slo)
        if plan.mode != "auto":
            if plan.draft == "auto":
                plan = self._resolve_draft(plan)
            policy = plan.to_policy(self.base)
            result = PlanResult(
                spec=plan,
                policy=policy,
                cost=self._price(policy, plan, calib, slo),
                kv_sensitivity=kv_scores,
            )
            self.last = result
            return result
        if slo is None and plan.target_tps is not None:
            slo = Slo(plan.target_tps, plan.slo_batch or self.cost.batch)
        joint = plan.act_bits is not None
        self._ensure_scores(joint)
        calib = calib if calib is not None else self.cost.calib
        kwargs: dict = {
            "scores": self._scores,
            "tokens": self._tokens,
            "max_segments": plan.max_segments,
            "machine": self.cost.machine,
            "cost_batch": slo.batch if slo is not None else self.cost.batch,
            "cost_threads": self.cost.threads,
        }
        if joint:
            kwargs.update(
                act_scores=self._act_scores,
                abits_candidates=sens.SUPPORTED_ABITS,
                match_uniform_abits=int(plan.act_bits),
                prt=_solver_prt(plan.prt),
                prt_calib=calib,
            )
        budgets = None
        if slo is not None:
            if not joint and not self.cost.include_dram:
                raise ValueError(
                    "a weight-only SLO solve needs the DRAM term: without it the "
                    "SLO only constrains cycles, which weight-only allocation "
                    "does not budget (add act bits for a joint solve, or enable "
                    "include_dram)"
                )
            budgets = self.budgets(slo, plan)
            if joint:
                kwargs["cycle_budget"] = budgets.cycle_budget
            if budgets.byte_budget is not None:
                kwargs["budget_bytes"] = budgets.byte_budget
        elif plan.budget_bpw is not None:
            kwargs["budget_bpw"] = plan.budget_bpw
        else:
            kwargs["match_uniform"] = int(plan.weight_bits)
        policy, report = sens.calibrate_policy(self.params, self.cfg, self.base, **kwargs)
        solved = self._solved_spec(plan, report, slo)
        if solved.draft == "auto":
            solved = self._resolve_draft(solved)
        result = PlanResult(
            spec=solved,
            policy=policy,
            report=report,
            cost=self._price(policy, plan, calib, slo),
            budgets=budgets,
            kv_sensitivity=kv_scores,
        )
        self.last = result
        return result

    def _resolve_kv(self, plan: PlanSpec):
        """Resolve ``kv_bits="auto"`` to a concrete 8 or 32: int8 KV when the
        per-layer KV probe's summed decode-logit error, relative to the
        reference logit power, stays within ``kv_tolerance`` (cached)."""
        if self._kv_scores is None:
            self._kv_scores = sens.kv_sensitivity(self.params, self.cfg,
                                                  self._calib_tokens())
        bits = 8 if self._kv_scores["relative"] <= self.kv_tolerance else 32
        solved = dataclasses.replace(plan, kv_bits=bits, quant_kv=bits == 8)
        return solved, self._kv_scores

    #: ``tp="auto"`` search grid — shard counts worth pricing
    TP_GRID = (1, 2, 4, 8)

    def _resolve_tp(self, plan: PlanSpec, slo: Optional[Slo]) -> PlanSpec:
        """Resolve ``tp="auto"`` to the smallest shard count whose modeled
        tokens/s (the plan's anchor precision under the three-term model)
        meets the SLO; without an SLO, ``tp=1``.  Pricing only: the engine
        serves ``tp=1`` and refuses more (ROADMAP, Queue 1 item 3)."""
        if slo is None:
            return dataclasses.replace(plan, tp=1)
        anchor = self._anchor_policy(plan)
        chosen = self.TP_GRID[-1]
        for m in self.TP_GRID:
            cand = dataclasses.replace(plan, tp=int(m))
            cost = self._tp_cost(
                dataclasses.replace(
                    self.cost, batch=slo.batch, nbw=plan.nbw, prt=_solver_prt(plan.prt)
                ),
                cand,
            )
            modeled = cost.evaluate(self.params, anchor)
            if modeled.tokens_per_second >= slo.target_tps * (1 - 1e-9):
                chosen = int(m)
                break
        return dataclasses.replace(plan, tp=chosen)

    def _anchor_policy(self, plan: PlanSpec):
        """The policy ``_resolve_tp`` prices: the plan's own when it is
        directly servable, else the auto mode's match-uniform anchor."""
        probe = dataclasses.replace(plan, tp=None, draft=None)
        if probe.solved:
            return probe.to_policy(self.base)
        return dataclasses.replace(
            self.base,
            bits=int(plan.weight_bits) if plan.weight_bits is not None else self.base.bits,
            act_bits=plan.act_bits if plan.act_bits is not None else self.base.act_bits,
        )

    def _resolve_draft(self, plan: PlanSpec) -> PlanSpec:
        """``draft="auto"`` measures draft acceptance by speculative
        decoding, which is not ported."""
        raise NotImplementedError(
            f"plan {plan.format()!r}: draft=auto needs speculative decoding "
            "(its acceptance probe), not ported yet (ROADMAP, Queue 1 item 3)")

    def _solved_spec(self, plan: PlanSpec, report, slo: Optional[Slo]) -> PlanSpec:
        assign = report.bits_by_unit
        joint = any(isinstance(s, (tuple, list)) for s in assign.values())
        if joint:
            weights = sens.spec_map_from_units({k: s[0] for k, s in assign.items()})
            acts = sens.spec_map_from_units({k: s[1] for k, s in assign.items()})
        else:
            weights, acts = sens.spec_map_from_units(assign), None
        return dataclasses.replace(
            plan,
            weights_per_unit=weights,
            acts_per_unit=acts,
            target_tps=slo.target_tps if slo is not None else plan.target_tps,
            slo_batch=slo.batch if slo is not None else plan.slo_batch,
            group_size=self.base.group_size,
            min_size=self.base.min_size,
        )

    def _price(self, policy, plan: PlanSpec, calib, slo: Optional[Slo]) -> PlanCost:
        # price at the SLO's batch when one is in play: lookup cycles
        # scale with batch, so budgets and the evaluation must agree
        cost = dataclasses.replace(
            self.cost,
            prt=_solver_prt(plan.prt),
            calib=calib if calib is not None else self.cost.calib,
            nbw=plan.nbw,
            batch=slo.batch if slo is not None else self.cost.batch,
        )
        return self._tp_cost(cost, plan).evaluate(self.params, policy)

    def _traffic_hit_rate(self, plan: PlanSpec, calib) -> float:
        """PRT hit rate of the captured traffic at the plan's operating
        point (the plan's NBW when fixed, else the cycle-optimal NBW for
        the traffic's feature width at the plan's anchor precisions);
        per-layer batches average their per-layer rates."""
        abits = plan.act_bits if plan.act_bits is not None else 8
        wbits = plan.weight_bits if plan.weight_bits is not None else 4
        batches = (
            [v for k, v in sorted(calib.items(), key=lambda kv: (kv[0] is None, kv[0]))
             if k is not None] or [calib[None]]
            if isinstance(calib, dict)
            else [calib]
        )
        rates = []
        for batch in batches:
            nbw = plan.nbw
            if not isinstance(nbw, int):
                k = int(batch.shape[-1])
                nbw = self.cost.best_nbw(k, k, wbits, abits)
            rates.append(pattern.prt_hit_rate(nbw, abits, batch))
        return float(sum(rates) / len(rates))

    # -- online recalibration ---------------------------------------------

    def replan(self, tap, resolve: bool = False, slo: Optional[Slo] = None) -> PlanResult:
        """Recalibrate against live traffic captured by an ActivationTap.

        Default: keep the current allocation and re-price it with PRT
        discounts measured on the tapped per-layer activations (no probes,
        no solve).  ``resolve=True`` also re-solves the allocation under
        the measured discounts (reusing the cached probes).  The result's
        ``measured_prt_hit_rate`` is the traffic's PRT hit rate at the
        plan's (nbw, act-bits) operating point.
        """
        calib = tap.calib() if hasattr(tap, "calib") else tap
        if calib is None:
            raise ValueError("tap has captured no activations yet")
        base_plan = self.last.spec if self.last is not None else self.plan
        if slo is None and base_plan.target_tps is not None:
            slo = Slo(base_plan.target_tps, base_plan.slo_batch or self.cost.batch)
        plan = dataclasses.replace(base_plan, prt="measured")
        self.cost = dataclasses.replace(self.cost, prt="measured", calib=calib)
        hit = self._traffic_hit_rate(plan, calib)
        if resolve and plan.mode == "auto":
            fresh = dataclasses.replace(plan, weights_per_unit=None, acts_per_unit=None)
            result = self.solve(slo=slo, calib=calib, plan=fresh)
        else:
            policy = self.last.policy if self.last is not None else plan.to_policy(self.base)
            result = PlanResult(
                spec=plan,
                policy=policy,
                report=self.last.report if self.last is not None else None,
                cost=self._price(policy, plan, calib, slo),
            )
            self.last = result
        result.measured_prt_hit_rate = hit
        return result
