"""Precision planning (port of ``repro.planning``): the front door for
mixed-precision serving.

``PlanSpec`` (the typed plan, ``spec.py``), ``DecodeCostModel`` (the
paper's SAIL machine's pricing, ``cost.py``), ``Planner`` (sensitivity
probes, the budgeted solve, SLO budgets, ``kv=auto``, ``tp=auto``, online
replan; ``planner.py``), ``ActivationTap`` (live-traffic capture,
``tap.py``) and ``run_calibration`` (the cost model refit to timings on
this host, ``calibrate_cost.py``), with ``as_plan`` / ``plan_from_arg`` /
``resolve_plan``.  A ``draft=`` plan serves self-speculative decoding and
``draft=auto`` is grid-solved on measured acceptance; a ``tp=<M>`` plan
serves tensor-parallel over M ranks (``serving.distributed``).
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


def resolve_plan(plan: Any, params, cfg, base=None, slo: Optional[Slo] = None,
                 cost: Optional[DecodeCostModel] = None, tokens=None,
                 compute_cost: bool = False) -> PlanResult:
    """Plan -> servable PlanResult.

    Uniform and rules plans and *solved* auto plans (e.g. a ``plan.json``)
    resolve directly, with no calibration.  Unsolved plans run a
    :class:`Planner` on ``params`` (sensitivity probes and the budgeted
    solve on the device ``params`` live on, honouring ``slo`` /
    ``plan.target_tps``).  ``compute_cost`` prices a solved plan on the
    SAIL machine model (an unsolved one is always priced by its solve)."""
    plan = as_plan(plan)
    planner = Planner(params, cfg, plan, base=base, cost=cost, tokens=tokens)
    if plan.solved:
        policy = plan.to_policy(planner.base)
        return PlanResult(
            spec=plan, policy=policy,
            cost=planner._price(policy, plan, None, slo) if compute_cost
            else None)
    return planner.solve(slo=slo)
