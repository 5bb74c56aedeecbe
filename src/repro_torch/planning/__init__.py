"""Precision planning (port of ``repro.planning``): the front door for
mixed-precision serving.

``PlanSpec`` (the typed plan, ``spec.py``) and ``DecodeCostModel`` (the
paper's SAIL machine's pricing, ``cost.py``), with ``as_plan`` /
``plan_from_arg`` / ``resolve_plan`` for every plan that needs no
calibration: ``uniform:``, ``rules:`` and *solved* ``auto`` plans (a
``plan.json`` with its per-unit allocation).  The Planner that solves an
``auto`` plan (sensitivity probes, the joint solve, ``kv=auto``,
``draft=auto``, ``tp=auto``), the activation tap and the cost model's
refit to the card wait for the Planner slice (ROADMAP, Queue 1 item 2).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Mapping, Optional

from repro_torch.planning.cost import (
    DEFAULT_LINK_BW,
    Budgets,
    DecodeCostModel,
    PlanCost,
    Slo,
    calib_for_layer,
    dispatch_from_json,
    expected_tokens_per_round,
    kv_block_bytes,
    kv_pool_blocks,
    kv_token_bytes,
    machine_from_json,
    policy_units,
    speculative_round_seconds,
    tp_allreduce_elems,
    unquantized_bytes,
)
from repro_torch.planning.spec import DraftSpec, PlanRule, PlanSpec

__all__ = [
    "Budgets",
    "DEFAULT_LINK_BW",
    "DecodeCostModel",
    "DraftSpec",
    "PlanCost",
    "PlanResult",
    "PlanRule",
    "PlanSpec",
    "Slo",
    "as_plan",
    "calib_for_layer",
    "dispatch_from_json",
    "expected_tokens_per_round",
    "kv_block_bytes",
    "kv_pool_blocks",
    "kv_token_bytes",
    "machine_from_json",
    "plan_from_arg",
    "plan_cost_model",
    "policy_units",
    "resolve_plan",
    "speculative_round_seconds",
    "tp_allreduce_elems",
    "unquantized_bytes",
]

_PLANNER = ("is not ported yet: it needs the Planner (sensitivity probes and "
            "the joint solve; ROADMAP, Queue 1 item 2)")


@dataclasses.dataclass
class PlanResult:
    """One servable plan: the spec (source of truth), its policy, and its
    modeled cost on the SAIL machine when asked for (the reference's
    ``planner.PlanResult`` without the solver's diagnostics)."""

    spec: PlanSpec
    policy: Any
    cost: Optional[PlanCost] = None


def plan_from_arg(value: Any) -> PlanSpec:
    """CLI plan argument -> PlanSpec: an existing PlanSpec passes
    through; a string is loaded as a plan file when it exists on disk or
    ends in .json, else parsed as grammar."""
    if isinstance(value, PlanSpec):
        return value
    if isinstance(value, str) and (os.path.exists(value)
                                   or value.endswith(".json")):
        return PlanSpec.load(value)
    return as_plan(value)


def as_plan(obj: Any) -> PlanSpec:
    """Coerce any accepted plan form to a PlanSpec: an existing PlanSpec,
    a grammar string, or a JSON / legacy dict."""
    if isinstance(obj, PlanSpec):
        return obj
    if isinstance(obj, str):
        return PlanSpec.parse(obj)
    if isinstance(obj, Mapping):
        return PlanSpec.from_json(obj)
    raise TypeError(f"cannot interpret {type(obj).__name__!r} as a PlanSpec")


def check_servable(plan: PlanSpec) -> None:
    """Raise ``NotImplementedError`` (naming ROADMAP) for a plan the port
    cannot serve yet: an unsolved one (``auto`` without its allocation,
    ``kv=auto``, ``draft=auto``, ``tp=auto``) needs the Planner; a
    concrete ``draft`` needs speculative decoding and ``tp > 1`` tensor
    parallelism."""
    for what, unsolved in (("an unsolved auto plan", plan.mode == "auto"
                            and plan.weights_per_unit is None),
                           ("kv=auto", plan.kv_bits == "auto"),
                           ("draft=auto", plan.draft == "auto"),
                           ("tp=auto", plan.tp == "auto")):
        if unsolved:
            raise NotImplementedError(f"plan {plan.format()!r}: {what} "
                                      f"{_PLANNER}")
    if plan.draft is not None:
        raise NotImplementedError(
            f"plan {plan.format()!r}: a draft plan needs speculative "
            "decoding, not ported yet (ROADMAP, Queue 1 item 3)")
    if isinstance(plan.tp, int) and plan.tp > 1:
        raise NotImplementedError(
            f"plan {plan.format()!r}: tp={plan.tp} needs tensor-parallel "
            "serving, not ported yet (ROADMAP, Queue 1 item 3)")


def plan_cost_model(plan: PlanSpec, **kw) -> DecodeCostModel:
    """The DecodeCostModel a plan is priced with: its PRT mode and NBW,
    and its fitted machine when it carries calibration provenance."""
    kw = dict(kw, prt=False if plan.prt == "off" else plan.prt, nbw=plan.nbw)
    if plan.calibration is not None:
        kw["machine"] = machine_from_json(plan.calibration)
        disp = dispatch_from_json(plan.calibration)
        if disp is not None:
            kw["dispatch_cycles"] = disp
    return DecodeCostModel(**kw)


def resolve_plan(plan: Any, params, cfg, base=None, slo: Optional[Slo] = None,
                 compute_cost: bool = False) -> PlanResult:
    """Plan -> servable PlanResult, for plans that need no calibration:
    uniform and rules plans and *solved* auto plans resolve directly.
    Anything that needs the Planner raises ``NotImplementedError``
    (``check_servable``).  ``compute_cost`` prices the result on the SAIL
    machine model, at ``slo.batch`` when an SLO is given."""
    from repro_torch.models.sail_linear import QuantPolicy
    plan = as_plan(plan)
    check_servable(plan)
    base = base or QuantPolicy(bits=plan.weight_bits or 4,
                               group_size=plan.group_size or 128,
                               min_size=plan.min_size or 65536)
    policy = plan.to_policy(base)
    cost = None
    if compute_cost:
        model = plan_cost_model(
            plan, **({"batch": slo.batch} if slo is not None else {}))
        cost = model.evaluate(params, policy)
    return PlanResult(spec=plan, policy=policy, cost=cost)
