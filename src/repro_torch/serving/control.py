"""SloController: the autonomous control loop over ``Engine.step()``
(port of ``repro.serving.control``, pure Python, copied as it is).

The engine exposes a control surface — ``Engine.replan()``, plan
provenance in ``stats()``, ``meets_slo`` in the cost model — and this
module closes the loop: a small deterministic state machine the engine
consults every iteration, with three escalating responses to the
measurements the engine already produces:

  * **shed / shrink** (occupancy control, purely model-driven and
    deterministic): the modeled iteration time ``t_iter(b)`` is
    nondecreasing in occupancy ``b`` (lookup cycles scale with batch),
    so an SLO — which bounds iteration latency at
    ``slo.seconds_per_iteration`` — admits a maximal feasible occupancy
    ``batch_cap``.  When the solved plan's ``meets_slo`` goes false at
    the pool size, the controller *shrinks* the effective decode batch
    to the cap, and admissions beyond it are *shed* (deferred in the
    FIFO, never dropped) until slots free up.
  * **replan** (drift control, measurement-driven with hysteresis):
    measured decode tokens/s is compared against the plan's modeled
    tokens/s over a sliding window.  Because the cost model prices a
    different machine (the paper's SAIL machine) than the card running
    the engine, drift is
    *anchored*: the first post-warmup window establishes the
    measured/modeled scale, and subsequent windows are judged relative
    to it — drift therefore means "the machine no longer behaves the way
    it did when this plan was priced", i.e. the calibration is stale.
    Only when |drift| stays outside the deadband for ``hysteresis``
    consecutive checks AND the cooldown has elapsed does the controller
    ask for a replan — no plan churn on noise.
  * **resolve** (allocation control): a replan re-prices the current
    allocation with PRT discounts measured on tapped traffic.  The
    expensive full re-solve is requested only when the tapped PRT
    hit-rate has moved by more than ``resolve_hit_delta`` from the rate
    the current plan was priced with — the only signal under which the
    solver would actually change the allocation.

The controller itself never touches the engine: it consumes numbers
(``observe``, ``decide``, ``batch_cap``) and counts its actions, and
``Engine.step()`` applies them.  That keeps the state machine unit-
testable without a model.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Callable, Dict, Optional

ACTIONS = ("shed", "shrink", "replan", "resolve", "skipped")

#: tolerance on the modeled-feasibility comparison — a plan solved
#: exactly onto its SLO budget must not flip infeasible on float noise
_SLO_EPS = 1e-9


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Knobs of the SLO control loop (surfaced via ``EngineConfig``)."""

    # drift loop
    check_every: int = 8  # decode iterations between drift checks
    deadband: float = 0.25  # |anchored drift| tolerated without action
    hysteresis: int = 2  # consecutive out-of-band checks before acting
    cooldown: int = 32  # decode iterations after an action before another
    window: int = 32  # sliding window (decode iterations) for measured tps
    warmup: int = 2  # initial decode iterations ignored (first launches)
    anchor: bool = True  # scale modeled tps by the first window's ratio
    # occupancy loop
    shed: bool = True  # defer admissions above the feasible batch cap
    min_batch: int = 1  # shrink floor (never cap below this)
    # escalation
    resolve_hit_delta: float = 0.02  # tapped PRT hit-rate delta forcing re-solve

    def __post_init__(self):
        if self.check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {self.check_every}")
        if self.deadband < 0:
            raise ValueError(f"deadband must be >= 0, got {self.deadband}")
        if self.hysteresis < 1:
            raise ValueError(f"hysteresis must be >= 1, got {self.hysteresis}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.min_batch < 1:
            raise ValueError(f"min_batch must be >= 1, got {self.min_batch}")
        if self.resolve_hit_delta < 0:
            raise ValueError(f"resolve_hit_delta must be >= 0, got {self.resolve_hit_delta}")

    @staticmethod
    def coerce(value: Any) -> "ControllerConfig":
        """EngineConfig.controller sugar: True / dict / ControllerConfig."""
        if isinstance(value, ControllerConfig):
            return value
        if value is True:
            return ControllerConfig()
        if isinstance(value, dict):
            return ControllerConfig(**value)
        raise TypeError(
            f"controller must be True, a dict of knobs, or a ControllerConfig, got {value!r}"
        )


class SloController:
    """The control-loop state machine (see module docstring).

    ``iter_seconds(b)`` models one decode iteration at occupancy ``b``
    (the engine supplies its memoized plan pricing); ``planned_tps`` is
    the modeled decode tokens/s at the full pool; ``slo`` bounds the
    modeled iteration latency; ``plan_hit_rate`` is the PRT hit rate the
    served plan was priced with (None until a measured replan ran).
    """

    def __init__(
        self,
        cfg: Optional[ControllerConfig] = None,
        slo=None,
        iter_seconds: Optional[Callable[[int], float]] = None,
        planned_tps: Optional[float] = None,
        plan_hit_rate: Optional[float] = None,
        tokens_per_iter: float = 1.0,
    ):
        self.cfg = cfg or ControllerConfig()
        self.slo = slo
        self._iter_seconds = iter_seconds
        self.planned_tps = planned_tps
        self.plan_hit_rate = plan_hit_rate
        # tokens each lane commits per scheduling quantum: 1 for plain
        # decode; E[accepted + 1] under speculative decoding, where one
        # "iteration" is a whole draft+verify round and the SLO's
        # per-iteration budget must be priced per committed token
        self.tokens_per_iter = float(tokens_per_iter)
        self.actions: Dict[str, int] = {a: 0 for a in ACTIONS}
        self.checks = 0
        self._window: deque = deque(maxlen=self.cfg.window)
        self._oob = 0  # consecutive out-of-band drift checks
        self._seen = 0  # decode iterations observed (incl. warmup)
        self._last_action_iter: Optional[int] = None
        self._anchor_scale: Optional[float] = None
        self._last_drift: Optional[float] = None
        self._cap: Optional[int] = None
        self._cap_pool: Optional[int] = None
        self._prev_cap: Optional[int] = None

    # -- occupancy control -------------------------------------------------

    def meets_slo_at(self, occupancy: int) -> Optional[bool]:
        """Does the modeled plan meet the SLO at this occupancy?

        The SLO bounds one masked decode iteration at
        ``slo.seconds_per_iteration`` (equivalently: each active slot's
        decode rate at its fair share ``target_tps / slo_batch``), and
        ``t_iter`` is nondecreasing in occupancy — so this flips false
        exactly once, at the feasibility boundary ``batch_cap``.
        """
        if self.slo is None or self._iter_seconds is None:
            return None
        # an SLO quotes tokens/s; one scheduling quantum delivers
        # tokens_per_iter tokens per lane (1 plain, E[accepted+1] for a
        # speculative round), so the latency budget scales with it
        budget = self.slo.seconds_per_iteration * self.tokens_per_iter
        return self._iter_seconds(int(occupancy)) <= budget * (1 + _SLO_EPS)

    def batch_cap(self, pool: int, free_cap: Optional[int] = None) -> int:
        """Largest occupancy (<= pool) at which the plan still meets the
        SLO, floored at ``min_batch``.  A cap below the pool counts one
        ``shrink`` action each time it tightens.

        ``free_cap``: optional second bound from KV memory — with a paged
        block pool, occupancy is feasible only if the blocks exist to
        back it, so the cap is ``min(modeled cap, free_cap)``.  The memory
        bound does not count ``shrink`` actions (that counter tracks the
        modeled-SLO lever; block exhaustion is reported by the engine's
        ``block_pool`` stats instead).
        """
        pool = int(pool)
        key = (pool, None if free_cap is None else int(free_cap))
        if self._cap is not None and self._cap_pool == key:
            return self._cap
        cap = pool
        if self.slo is not None and self._iter_seconds is not None:
            cap = 0
            for b in range(1, pool + 1):
                if not self.meets_slo_at(b):
                    break  # t_iter is nondecreasing: no later b can pass
                cap = b
            cap = max(cap, self.cfg.min_batch)
            cap = min(cap, pool)
        if self._prev_cap is not None and cap < self._prev_cap:
            self.actions["shrink"] += 1
        elif self._prev_cap is None and cap < pool:
            self.actions["shrink"] += 1
        self._prev_cap = cap
        if free_cap is not None:
            cap = max(min(cap, int(free_cap)), self.cfg.min_batch)
        self._cap, self._cap_pool = cap, key
        return cap

    def record_shed(self, n: int = 1) -> None:
        """The engine deferred ``n`` admissions that free slots could
        have taken, because occupancy sits at the cap."""
        self.actions["shed"] += int(n)

    # -- drift control -----------------------------------------------------

    def measured_tps(self) -> Optional[float]:
        """Windowed decode throughput (tokens/s over the sliding window)."""
        if not self._window:
            return None
        toks = sum(t for t, _, _ in self._window)
        secs = sum(s for _, s, _ in self._window)
        if secs <= 0:
            return None
        return toks / secs

    def drift(self) -> Optional[float]:
        """Last computed anchored drift (None before the anchor is set)."""
        return self._last_drift

    def _expected_seconds(self, occupancy: int) -> Optional[float]:
        """Modeled seconds of one iteration at this occupancy — the
        per-iteration reference the drift window accumulates.  Comparing
        at the iteration's OWN occupancy keeps legitimate occupancy
        swings (requests finishing, bursts landing) out of the drift
        signal; only behavior-vs-model change remains."""
        if self._iter_seconds is not None:
            return self._iter_seconds(int(occupancy))
        if self.planned_tps is not None and self.planned_tps > 0:
            return occupancy / self.planned_tps
        return None

    def observe(self, tokens: int, seconds: float, iteration: int) -> bool:
        """Feed one decode iteration (``tokens`` = occupancy, i.e. slots
        decoded; ``seconds`` = measured wall time); returns True when the
        drift loop wants an action (the engine then calls :meth:`decide`
        and applies/reports the result via :meth:`acted`).

        ``iteration`` is the engine's decode-iteration counter — the
        controller's clock for warmup, check cadence, and cooldown.
        """
        self._seen += 1
        if self._seen <= self.cfg.warmup:
            return False  # first-launch iterations would poison the window
        expected = self._expected_seconds(tokens)
        if expected is None:
            return False
        self._window.append((int(tokens), float(seconds), float(expected)))
        if iteration % self.cfg.check_every != 0:
            return False
        secs = sum(s for _, s, _ in self._window)
        exp = sum(e for _, _, e in self._window)
        if secs <= 0 or exp <= 0:
            return False
        self.checks += 1
        # throughput-like ratio: > 1 means the window ran FASTER than
        # the model expected at its occupancy mix
        ratio = exp / secs
        if self.cfg.anchor:
            if self._anchor_scale is None:
                # first post-warmup window calibrates the measured/modeled
                # scale; drift is then relative behavior change
                self._anchor_scale = ratio
                self._last_drift = 0.0
                return False
            self._last_drift = ratio / self._anchor_scale - 1.0
        else:
            self._last_drift = ratio - 1.0
        if abs(self._last_drift) <= self.cfg.deadband:
            self._oob = 0  # hysteresis: deadband re-entry resets the count
            return False
        self._oob += 1
        if self._oob < self.cfg.hysteresis:
            return False
        if (
            self._last_action_iter is not None
            and iteration - self._last_action_iter < self.cfg.cooldown
        ):
            return False
        return True

    def decide(
        self, tapped_hit_rate: Optional[float] = None, plan_hit_rate: Optional[float] = None
    ) -> str:
        """Escalation policy: ``"resolve"`` only when the tapped PRT
        hit-rate delta would actually move the allocation, else
        ``"replan"`` (re-price only)."""
        ref = plan_hit_rate if plan_hit_rate is not None else self.plan_hit_rate
        if (
            tapped_hit_rate is not None
            and ref is not None
            and abs(tapped_hit_rate - ref) > self.cfg.resolve_hit_delta
        ):
            return "resolve"
        return "replan"

    def acted(self, action: str, iteration: int) -> None:
        """Record an applied (or skipped) action and arm the cooldown."""
        if action not in ACTIONS:
            raise ValueError(f"unknown action {action!r} (expected one of {ACTIONS})")
        self.actions[action] += 1
        self._last_action_iter = int(iteration)
        self._oob = 0
        self._window.clear()

    def plan_changed(
        self,
        iter_seconds: Optional[Callable[[int], float]] = None,
        planned_tps: Optional[float] = None,
        plan_hit_rate: Optional[float] = None,
        tokens_per_iter: Optional[float] = None,
    ) -> None:
        """The engine swapped plans: re-anchor drift against the new
        model and recompute the occupancy cap on next use."""
        if iter_seconds is not None:
            self._iter_seconds = iter_seconds
        if planned_tps is not None:
            self.planned_tps = planned_tps
        if plan_hit_rate is not None:
            self.plan_hit_rate = plan_hit_rate
        if tokens_per_iter is not None:
            self.tokens_per_iter = float(tokens_per_iter)
        self._anchor_scale = None
        self._last_drift = None
        self._oob = 0
        self._window.clear()
        self._cap = None
        self._cap_pool = None

    # -- reporting ---------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {
            "batch_cap": self._cap,
            "checks": self.checks,
            "drift": self._last_drift,
            "measured_window_tps": self.measured_tps(),
            **{a: self.actions[a] for a in ACTIONS},
        }
