"""Precision planning (port of ``repro.planning``): the front door for
mixed-precision serving.

``PlanSpec`` (the typed plan, ``spec.py``), ``DecodeCostModel`` (the
paper's SAIL machine's pricing, ``cost.py``), ``Planner`` (sensitivity
probes, the budgeted solve, SLO budgets, ``kv=auto``, ``tp=auto``, online
replan; ``planner.py``), ``ActivationTap`` (live-traffic capture,
``tap.py``) and ``run_calibration`` (the cost model refit to timings on
this host, ``calibrate_cost.py``), with ``as_plan`` / ``plan_from_arg`` /
``resolve_plan``.  Not ported yet: ``draft=`` plans (speculative decoding)
and serving ``tp > 1`` (ROADMAP, Queue 1 item 3).
"""
from __future__ import annotations

import os
from typing import Any, Mapping, Optional

from repro_torch.planning.calibrate_cost import (CalibrationResult,
                                                 run_calibration)
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
from repro_torch.planning.planner import (Planner, PlanResult,
                                         plan_cost_model)
from repro_torch.planning.spec import DraftSpec, PlanRule, PlanSpec
from repro_torch.planning.tap import ActivationTap

__all__ = [
    "ActivationTap",
    "Budgets",
    "CalibrationResult",
    "DEFAULT_LINK_BW",
    "DecodeCostModel",
    "DraftSpec",
    "PlanCost",
    "PlanResult",
    "PlanRule",
    "PlanSpec",
    "Planner",
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
    "run_calibration",
    "speculative_round_seconds",
    "tp_allreduce_elems",
    "unquantized_bytes",
]


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
    """Raise ``NotImplementedError`` (naming its ROADMAP item) for a plan
    the port cannot serve: a ``draft`` (concrete or ``auto``) needs
    speculative decoding and an integer ``tp > 1`` tensor-parallel
    serving.  Unsolved plans (``auto`` modes, ``kv=auto``, ``tp=auto``)
    serve: ``resolve_plan`` runs the Planner on them."""
    if plan.draft == "auto":
        raise NotImplementedError(
            f"plan {plan.format()!r}: draft=auto needs speculative decoding "
            "(its acceptance probe), not ported yet (ROADMAP, Queue 1 item 3)")
    if plan.draft is not None:
        raise NotImplementedError(
            f"plan {plan.format()!r}: a draft plan needs speculative "
            "decoding, not ported yet (ROADMAP, Queue 1 item 3)")
    if isinstance(plan.tp, int) and plan.tp > 1:
        raise NotImplementedError(
            f"plan {plan.format()!r}: tp={plan.tp} needs tensor-parallel "
            "serving, not ported yet (ROADMAP, Queue 1 item 3)")


def resolve_plan(plan: Any, params, cfg, base=None, slo: Optional[Slo] = None,
                 cost: Optional[DecodeCostModel] = None, tokens=None,
                 compute_cost: bool = False) -> PlanResult:
    """Plan -> servable PlanResult.

    Uniform and rules plans and *solved* auto plans (e.g. a ``plan.json``)
    resolve directly, with no calibration.  Unsolved plans run a
    :class:`Planner` on ``params`` (sensitivity probes and the budgeted
    solve on the device ``params`` live on, honouring ``slo`` /
    ``plan.target_tps``).  ``compute_cost`` prices a solved plan on the
    SAIL machine model (an unsolved one is always priced by its solve).
    Plans the port cannot serve raise ``NotImplementedError``
    (``check_servable``), before and after the solve (``tp=auto`` under an
    SLO may price more than one shard)."""
    plan = as_plan(plan)
    check_servable(plan)
    planner = Planner(params, cfg, plan, base=base, cost=cost, tokens=tokens)
    if plan.solved:
        policy = plan.to_policy(planner.base)
        return PlanResult(
            spec=plan, policy=policy,
            cost=planner._price(policy, plan, None, slo) if compute_cost
            else None)
    result = planner.solve(slo=slo)
    check_servable(result.spec)
    return result
