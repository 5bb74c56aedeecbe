"""Continuous-batching serving engine over a pool of KV-cache slots
(port of ``repro.serving.engine``: continuous and run-to-completion modes,
ring and paged pools, greedy and temperature sampling).

One model iteration serves every active user (SAIL Sec. III-A), so each
layer's weights stream once per iteration for the whole batch:

  * ``init_cache`` allocates a fixed ``[batch_size, cache_len]`` KV pool
    once; requests are prefilled into free slots and retired per slot;
  * every ``step()`` admits waiting requests (FIFO, optional prefill-token
    budget), commits each active slot's pending token (retiring on
    EOS / max tokens), then runs one masked decode for the rest.

``mode="batch"`` is the run-to-completion loop kept for A/B comparison:
admit a cohort (``IterationScheduler.admit``), prefill it in one pass
(``lm.prefill``, its own ring cache), decode it unmasked until every
member is done, admit again.

``EngineConfig.kv_block_size`` swaps the slot pool for a *paged* block
pool (``lm.init_paged_cache`` + ``serving.block_pool``): each request
holds a block table into a shared pool instead of a worst-case
``cache_len`` row, identical prompt prefixes share blocks copy-on-write,
admission is gated on free blocks, and the newest request is preempted
(recompute-style) when the pool runs dry.  The reference's invariants
hold: one extra physical *trash* block takes every dead write; a paged
lane never wraps (``submit`` refuses longer requests), so ring and paged
attention share one validity rule; shared prefix blocks are never
rewritten; a preempted request resumes from its committed tokens and,
under greedy sampling, produces the tokens it would have unpreempted.
Decode attention reads each lane's rows through its table in place (the
kernel's table mode); the table goes to the card once per step.

Weights are SAIL-quantized from ``ql``/``group_size``/``min_size``, or
from a precision ``plan`` (``planning.PlanSpec``, a grammar string or a
plan JSON dict): ``uniform:``, ``rules:``, a solved ``auto`` plan (a
``plan.json``), or an unsolved one (``auto:q<b>[a<ab>]...``,
``auto:<f>bpw``, ``kv=auto``, ``tp=auto``), which the Planner solves at
construction from sensitivity probes run on this engine's device; a bare
``slo`` solves ``auto:q<ql>a8,prt=measured`` against it.  A per-layer
allocation serves as a segmented layer stack.  KV is int8 when
``quant_kv``, unless the plan sets ``kv=8|32`` (or the Planner resolves
``kv=auto``), which overrides it for the ring pool, the paged pool and
the pool's byte pricing.  With ``tap_capacity > 0`` an ``ActivationTap``
captures each decode step's per-layer block inputs (dead lanes dropped),
and ``replan()`` re-prices the plan under PRT hit rates measured on them
(``resolve=True`` re-solves it) and ``apply_plan`` swaps the requantized
weights in between steps, under the running KV pool and requests.
``stats()`` reports the plan's hash and mode, ``replan_count``,
``prt_hit_rate`` and its ``planned_tps`` / ``drift``: those are the
paper's SAIL machine's modeled figures (``planning.DecodeCostModel``), or
this host's effective SAIL machine when the plan carries a
``calibrate_cost`` fit (``plan_calibrated``), never the card's.
``quantize=False`` serves the raw f32 tree (plain ``x @ w`` products; no
plan, so the plan fields of ``stats()`` are None).

Sampling is greedy at ``temperature`` 0.  Above it each token is
``categorical(key, row / T)`` under ``key = fold_in(fold_in(PRNGKey(seed),
uid), index)``, the reference's key stream bit for bit
(``core.prng.draw_rows``, one draw on the engine's device per step), where
``index`` counts the request's committed tokens: a request samples the
same tokens whatever the batch, the pool layout or a preemption.

A plan's ``draft=q<b>[a<ab>]:k<k>`` (or ``draft=auto``, which the Planner
solves against measured acceptance) serves self-speculative decoding
(``serving.speculative``): each decode iteration is a round of k draft
steps under an aggressive requantization of the same raw tree, one
(k+1)-token verify under the served tree and the acceptance rule; the
rollback sets each lane's length to its accepted frontier and, on the
paged pool, truncates its block table.  Greedy rounds commit plain
decoding's tokens.  ``EngineConfig.controller`` attaches a
``serving.control.SloController``: admissions are shed (deferred) and
the decode batch capped at the largest occupancy whose modeled iteration
(or round) time meets the SLO, bounded on the paged pool by the blocks
free, and a replan is asked for when measured-vs-modeled drift leaves the
deadband.

``EngineConfig.tp`` (or a concrete plan's ``tp=``) above 1 serves the
quantized tree sharded over a ``torch.distributed`` group of that many
ranks (``serving.distributed.TPServing``): every rank builds this engine
on the same requests and runs the same scheduler (SPMD), holds its slice
of the tree and its ``n_kv / tp`` heads of the KV pool, and only the
model's row-parallel all-reduces (at ``wire`` 32 or 8 bits) cross ranks.
The group is the caller's (``group=``) or the default one.  The controller
acts on rank 0's measured step times, broadcast, so every rank takes the
same decisions.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import planning
from repro_torch.core import prng
from repro_torch.core.scheduler import DECODE, IterationScheduler, Request
from repro_torch.device import resolve_device
from repro_torch.dist.sharding import tp_context
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
    quantize_params
from repro_torch.serving.block_pool import BlockSpaceManager
from repro_torch.serving.control import ControllerConfig, SloController
from repro_torch.serving.distributed import TPServing, local_config
from repro_torch.serving.speculative import SpeculativeDecoder, \
    accept_greedy


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 8            # KV-pool slots (paper: 8 balances the pipe)
    cache_len: int = 4096
    quantize: bool = True          # False: serve the raw f32 tree
    ql: int = 4
    group_size: int = 128
    quant_kv: bool = True
    min_size: int = 1024           # quantize tensors >= this many elements
    # Precision plan: a planning.PlanSpec (possibly solved / loaded from a
    # plan.json), a grammar string ("uniform:<b>[a<ab>][,kv=8|32|auto]",
    # "rules:<regex>=<b>[a<ab>],...,default=<b>[a<ab>]",
    # "auto:q<b>[a<ab>][,prt=...][,maxseg=<n>][,slo=<tps>]",
    # "auto:<f>bpw"), or a PlanSpec JSON dict.  Unsolved plans run the
    # Planner at engine construction.
    plan: Any = None
    # target decode tokens/s at ``batch_size`` on the SAIL machine model:
    # makes an auto ``plan`` an SLO solve (cycle AND byte budgets from the
    # target) and prices a solved one against it (a warning when it falls
    # short); set without ``plan`` it implies "auto:q<ql>a8,prt=measured"
    slo: Optional[float] = None
    # >0 attaches a planning.ActivationTap of that row capacity: every
    # ``tap_every``-th decode iteration's per-layer block inputs are
    # captured for online PRT recalibration (Engine.replan)
    tap_capacity: int = 0
    tap_every: int = 1
    # keep the raw f32 weights resident so apply_plan/replan can
    # requantize mid-serve: None retains them exactly when a tap is
    # attached; True for tap-less swaps, False to free them (replan raises)
    retain_raw: Optional[bool] = None
    # autonomous SLO control loop: True (defaults), a knob dict, or a
    # serving.control.ControllerConfig.  The controller sheds / shrinks
    # occupancy against the SLO and gates replans on measured-vs-modeled
    # drift (continuous mode only).
    controller: Any = None
    # DEPRECATED legacy surface (use ``plan``): None, QuantPolicy, policy
    # spec dict, or grammar string
    bit_policy: Any = None
    eos_token: int = -1            # -1: never stop early
    temperature: float = 0.0       # 0 = greedy
    # PRNG root for temperature > 0: each token's key is folded from
    # (seed, request uid, per-request sample index), so a request's
    # sampled tokens do not depend on batch composition, preemption or
    # the pool layout
    seed: int = 0
    mode: str = "continuous"       # "continuous" | "batch" (run-to-completion)
    prefill_budget: Optional[int] = None  # new prefill tokens per iteration
    prompt_bucket: int = 16        # prompts padded to a multiple
    # Paged KV pool (continuous mode): a block size replaces the
    # [batch_size, cache_len] slot pool with a shared pool of blocks
    # (per-request block tables, copy-on-write prefix sharing,
    # block-gated admission, preemption).
    kv_block_size: Optional[int] = None   # tokens per block; None = slots
    # pool size (first match wins): a block count, a byte budget priced by
    # planning.cost.kv_pool_blocks, else batch_size slot-equivalents
    kv_pool_blocks: Optional[int] = None
    kv_budget_bytes: Optional[int] = None
    share_prefix: bool = True      # COW-share identical prompt prefixes
    preempt: bool = True           # evict the newest request when dry
    # Tensor-parallel serving: shard the quantized weight tree over ``tp``
    # ranks of a process group (continuous mode, no tap, no draft); a
    # concrete plan's tp= / wire= overrides these knobs
    tp: int = 1
    wire: int = 32                 # all-reduce bits: 32 exact, 8 compressed


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    latency_s: float
    ttft_s: float = 0.0            # submit -> first token available


class Engine:
    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 device="cuda", group=None):
        """``group``: the process group a ``tp > 1`` engine shards over
        (None: the default group); it must hold exactly ``tp`` ranks."""
        if ecfg.mode not in ("continuous", "batch"):
            raise ValueError(f"mode={ecfg.mode!r}: 'continuous' or 'batch'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.slo: Optional[planning.Slo] = None
        self.plan: Optional[planning.PlanSpec] = None
        self.quant_policy: Optional[QuantPolicy] = None
        self.plan_report = None
        self.replan_count = 0
        self.prt_hit_rate: Optional[float] = None
        self.tap: Optional[planning.ActivationTap] = None
        self.controller: Optional[SloController] = None
        self.spec_decoder: Optional[SpeculativeDecoder] = None
        # plan pricing on the SAIL machine model: the plan's units and
        # fixed bytes (None without a plan), iteration seconds memoized
        # per occupancy, and the modeled seconds of the decode steps run
        # (each at its occupancy), the reference side of drift
        self._plan_units = None
        self._plan_fixed_bytes = 0
        self._iter_cache: Dict[int, float] = {}
        self.modeled_seconds = 0.0
        self._raw_params = None
        if (ecfg.bit_policy is not None or ecfg.plan is not None) \
                and not ecfg.quantize:
            raise ValueError("a precision plan requires quantize=True")
        if ecfg.plan is not None and ecfg.bit_policy is not None:
            raise ValueError("pass plan= OR the deprecated bit_policy=, "
                             "not both")
        if ecfg.slo is not None and ecfg.bit_policy is not None:
            raise ValueError("slo= requires plan= — the deprecated "
                             "bit_policy surface has no SLO semantics "
                             "and would silently ignore the target")
        if ecfg.tap_capacity > 0:
            if ecfg.mode == "continuous":
                self.tap = planning.ActivationTap(ecfg.tap_capacity,
                                                  ecfg.tap_every)
            else:
                warnings.warn(
                    "tap_capacity is ignored in mode='batch' — the "
                    "ActivationTap hooks the continuous engine's masked "
                    "decode iteration", UserWarning, stacklevel=2)
        # the raw tree on this engine's device: the Planner's probes run
        # on it, apply_plan requantizes it, quantize=False serves it
        params = map_tensors(params, lambda t: t.to(self.device))
        if ecfg.quantize:
            self._resolve_plan(params)
            retain = (ecfg.retain_raw if ecfg.retain_raw is not None
                      else self.tap is not None)
            self._raw_params = params if retain else None
            self.params, b0, b1 = quantize_params(params, self.quant_policy)
            self.compression = b0 / max(b1, 1)
        else:
            self.params, self.compression = params, 1.0
        # KV precision: a concrete plan kv_bits overrides quant_kv; the
        # pool's dtype is fixed from here on
        kvb = (self.plan.kv_bits if self.plan is not None
               and isinstance(self.plan.kv_bits, int) else None)
        self.kv_bits = kvb if kvb is not None else (8 if ecfg.quant_kv
                                                    else 32)
        self._quant_kv = self.kv_bits == 8
        # tensor parallelism: a concrete plan tp= / wire= wins over the
        # EngineConfig knobs; the shard count is fixed for the engine's life
        plan_tp = (self.plan.tp if self.plan is not None
                   and isinstance(self.plan.tp, int) else None)
        plan_wire = (self.plan.wire if self.plan is not None
                     and self.plan.wire is not None else None)
        self.tp = plan_tp if plan_tp is not None else int(ecfg.tp)
        self.wire_bits = (plan_wire if plan_wire is not None
                          else int(ecfg.wire))
        self.tp_serving: Optional[TPServing] = None
        if self.tp > 1:
            if ecfg.mode != "continuous":
                raise ValueError("tensor-parallel serving requires "
                                 "mode='continuous'")
            if self.tap is not None:
                raise ValueError(
                    "tensor-parallel serving and an ActivationTap cannot "
                    "coexist — the sharded decode step has no capture path")
            self.tp_serving = TPServing(cfg, self.tp, self.wire_bits, group)
            self.params = self.tp_serving.shard_params(self.params)
        # the model code runs over this rank's view of cfg (cfg itself at
        # tp=1), inside self._tp()
        self._mcfg = local_config(cfg, self.tp)
        self.sched = IterationScheduler(target_batch=ecfg.batch_size,
                                        max_batch=ecfg.batch_size,
                                        prefill_budget=ecfg.prefill_budget)
        self._uid = 0
        self.completions: Dict[int, Completion] = {}
        self._gen: Dict[int, List[int]] = {}
        self._t0: Dict[int, float] = {}
        self._ttft: Dict[int, float] = {}
        self._on_token: Dict[int, Callable[[int, int], None]] = {}
        self._orig_plen: Dict[int, int] = {}
        self.iterations = 0
        self.prefill_iterations = 0
        self.decode_iterations = 0
        self.prefill_tokens = 0
        self.decode_seconds = 0.0
        self._decode_tokens = 0
        self.peak_active = 0
        self.events: Dict[int, Dict[str, int]] = {}   # per-uid iterations
        self._clen = (ecfg.cache_len if cfg.window is None
                      else min(ecfg.cache_len, cfg.window))
        self.paged = ecfg.kv_block_size is not None
        self.block_mgr = None
        if self.paged and ecfg.mode != "continuous":
            raise ValueError("paged KV (kv_block_size) requires "
                             "mode='continuous'")
        if self.paged and cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"paged KV is attention-only; family={cfg.family!r} "
                "keeps recurrent state, not a block pool")
        draft = self.plan.draft if self.plan is not None else None
        if draft is not None:
            self._check_speculative(draft)
        # the continuous engine's pool; batch mode prefills each cohort
        # into a cache of its own
        if ecfg.mode == "continuous":
            self._cur = np.zeros((ecfg.batch_size,), np.int64)
            if self.paged:
                self._init_paged_pool(int(ecfg.kv_block_size))
            else:
                self.cache = lm.init_cache(self._mcfg, ecfg.batch_size,
                                           self._clen, self._quant_kv,
                                           device=self.device)
        if draft is not None:
            # the draft tree requantizes the SAME raw tree aggressively and
            # stays resident beside the served one
            self.spec_decoder = SpeculativeDecoder(params, cfg, draft,
                                                   self.quant_policy)
        if ecfg.controller:
            if ecfg.mode != "continuous":
                warnings.warn(
                    "controller is ignored in mode='batch' — the "
                    "SloController hooks the continuous engine's "
                    "iteration loop", UserWarning, stacklevel=2)
            else:
                self.controller = SloController(
                    ControllerConfig.coerce(ecfg.controller), slo=self.slo,
                    iter_seconds=(self._modeled_iter_seconds
                                  if self._plan_units is not None else None),
                    planned_tps=self.planned_tps(),
                    plan_hit_rate=self.prt_hit_rate,
                    tokens_per_iter=self._tokens_per_iter())

    def _check_speculative(self, draft) -> None:
        """The reference's gates on a plan's draft (``engine.py:399-431``)."""
        if not isinstance(draft, planning.DraftSpec):
            raise ValueError(
                "plan.draft is unresolved ('auto') — solve the plan "
                "(Planner / resolve_plan with an SLO) before serving")
        if self.ecfg.mode != "continuous":
            raise ValueError("speculative decoding (plan draft=) requires "
                             "mode='continuous'")
        if self.tp_serving is not None:
            raise ValueError(
                "speculative decoding is not supported under "
                "tensor-parallel serving — the draft/verify round runs "
                "outside the sharded entry points")
        if self.cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                "speculative decoding needs a pure-attention family — "
                "recurrent state cannot roll back to the accepted frontier "
                f"(family={self.cfg.family!r})")
        if self.cfg.pos == "sinusoidal":
            raise ValueError(
                "speculative decoding does not support sinusoidal positions "
                "(multi-token verify embeds at pos_offset=0, like "
                "decode_step)")
        if self.tap is not None:
            raise ValueError(
                "speculative decoding and an ActivationTap cannot coexist — "
                "the round bypasses the tapped decode step")

    def _base_policy(self) -> QuantPolicy:
        return QuantPolicy(bits=self.ecfg.ql, group_size=self.ecfg.group_size,
                           min_size=self.ecfg.min_size)

    def _resolve_plan(self, params) -> None:
        """The served plan and its policy (an unsolved plan is solved here,
        on ``params``), priced while the raw tree is in hand (units and
        fixed bytes behind ``planned_tps``)."""
        ecfg = self.ecfg
        base = self._base_policy()
        plan_in = ecfg.plan
        if plan_in is None and ecfg.bit_policy is None \
                and ecfg.slo is not None:
            # a bare SLO: the joint SLO solve anchored at the engine's ql
            plan_in = planning.PlanSpec(mode="auto", weight_bits=ecfg.ql,
                                        act_bits=8, prt="measured",
                                        quant_kv=ecfg.quant_kv)
        if plan_in is not None:
            plan = planning.as_plan(plan_in)
            # an SLO is quoted at this engine's decode batch
            target = ecfg.slo if ecfg.slo is not None else plan.target_tps
            if target is not None:
                self.slo = planning.Slo(target, batch=ecfg.batch_size)
            result = planning.resolve_plan(
                plan, params, self.cfg, base=base, slo=self.slo,
                compute_cost=plan.solved and self.slo is not None)
            if (self.slo is not None and result.cost is not None
                    and result.cost.tokens_per_second
                    < self.slo.target_tps * (1 - 1e-9)):
                feas = getattr(result.report, "feasible", True)
                warnings.warn(
                    f"plan {result.spec.spec_hash} models "
                    f"{result.cost.tokens_per_second:.1f} tok/s on the SAIL "
                    f"machine at batch {self.slo.batch}, below the requested "
                    f"SLO of {self.slo.target_tps:.1f}"
                    + ("" if feas else " (solver budgets infeasible even at "
                       "minimum precision)")
                    + "; lower the target, raise the batch, or serve a "
                    "cheaper plan", UserWarning, stacklevel=3)
            policy = result.policy
            self.plan = result.spec
            self.plan_report = result.report
        elif ecfg.bit_policy is not None:
            warnings.warn(
                "EngineConfig.bit_policy is deprecated; use "
                "EngineConfig.plan (a repro_torch.planning.PlanSpec, "
                "grammar string, or plan JSON)", DeprecationWarning,
                stacklevel=3)
            from repro_torch.core.sensitivity import _resolve_policy_like
            policy = _resolve_policy_like(ecfg.bit_policy, params, self.cfg,
                                          base)
            self.plan = planning.PlanSpec.from_policy(
                policy, quant_kv=ecfg.quant_kv)
        else:
            policy = base
            self.plan = planning.PlanSpec.from_policy(
                policy, quant_kv=ecfg.quant_kv)
        self.quant_policy = policy
        self._plan_units = planning.policy_units(params, policy)
        self._plan_fixed_bytes = planning.unquantized_bytes(params, policy)

    # --- client API -------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               on_token: Optional[Callable[[int, int], None]] = None) -> int:
        """Queue a request; returns its uid.  ``on_token(uid, token)`` is
        called as each generated token is committed.  Paged mode refuses a
        request longer than a lane's table holds (lanes never wrap), and
        a speculating engine one whose draft lookahead (k + 1 positions
        past the request) would not fit a lane of either pool."""
        # a round writes k + 1 candidate positions past the committed
        # frontier; lanes must never wrap over them
        spec_extra = (self.spec_decoder.k + 1
                      if self.spec_decoder is not None else 0)
        need = len(prompt) + max_new_tokens + spec_extra
        if self.paged:
            room = self._mbs * int(self.ecfg.kv_block_size)
            if need > room:
                raise ValueError(
                    f"request needs {need} KV positions but a paged lane "
                    f"holds {room} ({self._mbs} blocks x "
                    f"{self.ecfg.kv_block_size}); paged lanes never wrap: "
                    "raise cache_len or shorten the request")
        elif spec_extra and need > self._clen:
            raise ValueError(
                f"request needs {need} KV positions (prompt + max_new + "
                f"draft lookahead) but the ring holds {self._clen} — "
                "speculative rollback forbids ring wrap; raise cache_len or "
                "shorten the request")
        self._uid += 1
        now = time.perf_counter()
        self.sched.submit(Request(uid=self._uid, prompt_len=len(prompt),
                                  max_new_tokens=max_new_tokens,
                                  arrived_at=now))
        self._orig_plen[self._uid] = len(prompt)
        self._gen[self._uid] = list(prompt)
        self._t0[self._uid] = now
        if on_token is not None:
            self._on_token[self._uid] = on_token
        return self._uid

    def step(self) -> bool:
        """One engine iteration: admit + prefill into free slots, commit
        each active slot's pending token (retiring on EOS / max tokens),
        then one masked decode for every remaining slot (``mode="batch"``:
        serve one whole cohort).  Returns True while work remains."""
        if self.ecfg.mode != "continuous":
            self._serve_batch()
            return not self.sched.idle()
        ctl = self.controller
        cap = None
        if ctl is not None and ctl.cfg.shed:
            free_cap = self._block_free_cap() if self.paged else None
            cap = ctl.batch_cap(self.ecfg.batch_size, free_cap=free_cap)
        admitted = self.sched.schedule(
            max_active=cap,
            can_admit=self._try_allocate if self.paged else None)
        if (cap is not None and self.sched.waiting and self.sched.free_slots
                and self.sched.active >= cap):
            # free slots exist but the SLO cap binds: these admissions are
            # shed (deferred in FIFO), not dropped
            ctl.record_shed()
        if admitted:
            # one prefill pass per padded length: a burst streams each
            # layer's weights once, not once per request
            groups: Dict[int, List[Request]] = {}
            for req in admitted:
                groups.setdefault(self._padded_len(req), []).append(req)
            for padded, reqs in groups.items():
                self._prefill_slots(reqs, padded)
        for req in list(self.sched.running):
            finished = req.generated >= req.max_new_tokens
            if not finished:
                tok = int(self._cur[req.slot])
                self._gen[req.uid].append(tok)
                req.generated += 1
                cb = self._on_token.get(req.uid)
                if cb is not None:
                    cb(req.uid, tok)
                finished = (tok == self.ecfg.eos_token
                            or req.generated >= req.max_new_tokens)
            if finished:
                self._finish(req)
        active = list(self.sched.running)
        spec = self.spec_decoder
        if self.paged and active:
            # every active lane appends one KV position (k + 1 in a round:
            # the k drafts, which verify rewrites, and the bonus slot):
            # grant its block slots first (copy-on-write off shared blocks,
            # preempting the newest request when the pool runs dry)
            active = self._ensure_append_blocks(
                active, n=spec.k + 1 if spec is not None else 1)
        self.peak_active = max(self.peak_active, len(active))
        if spec is not None and active:
            self._speculative_round(active, ctl)
            return not self.sched.idle()
        if active:
            mask = np.zeros((self.ecfg.batch_size,), bool)
            for req in active:
                mask[req.slot] = True
            t0 = time.perf_counter()
            tables = None
            if self.paged:
                # the previous step's copy has finished: _sample synced
                self._tables_dev.copy_(self._tables_host, non_blocking=True)
                tables = self._tables_dev
            capture = (self.tap is not None
                       and self.tap.should_capture(self.decode_iterations))
            with self._tp():
                out = lm.decode_step(
                    self.params, self._cur[:, None], self.cache, self._mcfg,
                    quant_kv=self._quant_kv, active_mask=mask,
                    device=self.device, block_tables=tables,
                    capture_layer_inputs=capture)
            if capture:
                logits, self.cache, layer_inputs = out
                self.tap.observe(layer_inputs, mask)
            else:
                logits, self.cache = out
            uids = np.zeros((self.ecfg.batch_size,), np.int64)
            sidx = np.zeros((self.ecfg.batch_size,), np.int64)
            for req in active:
                uids[req.slot] = req.uid
                sidx[req.slot] = self._sample_index(req.uid)
            nxt = self._sample(logits, uids, sidx)
            # _sample copies to the host, so dt covers the whole iteration
            # (and any tap capture's copy)
            dt = time.perf_counter() - t0
            if ctl is not None:
                dt = self._agreed_seconds(dt)
            self.iterations += 1
            self.decode_iterations += 1
            self.decode_seconds += dt
            self._decode_tokens += len(active)
            exp = self._modeled_iter_seconds(len(active))
            if exp is not None:
                self.modeled_seconds += exp
            if self.paged:
                self._len_np[mask] += 1
            for req in active:
                self._cur[req.slot] = nxt[req.slot]
                self.events[req.uid].setdefault("first_decode_iteration",
                                                self.iterations)
            if ctl is not None and ctl.observe(len(active), dt,
                                               self.decode_iterations):
                self._controller_step()
        return not self.sched.idle()

    def run(self) -> List[Completion]:
        """Serve until all submitted requests finish."""
        while self.step():
            pass
        return list(self.completions.values())

    # --- paged-pool internals -----------------------------------------------
    def _init_paged_pool(self, bs: int) -> None:
        """The block pool (with its trash block), its manager and the lanes'
        block tables, on the host and on the card."""
        ecfg = self.ecfg
        if bs < 1:
            raise ValueError(f"kv_block_size={bs}: need >= 1")
        self._mbs = -(-self._clen // bs)       # table columns per lane
        nblocks = self._paged_pool_blocks(bs)
        self.block_mgr = BlockSpaceManager(nblocks, bs,
                                           share_prefix=ecfg.share_prefix)
        # one extra physical block: the trash block every dead table entry
        # and masked write points at
        self._trash = nblocks
        self.cache = lm.init_paged_cache(self._mcfg, ecfg.batch_size,
                                         nblocks + 1, bs, self._quant_kv,
                                         device=self.device)
        # the host's tables live in a (pinned, on the card) buffer that one
        # copy_ per decode step sends to a device tensor allocated here
        shape = (ecfg.batch_size, self._mbs)
        self._tables_host = torch.full(
            shape, self._trash, dtype=torch.int32,
            pin_memory=self.device.type == "cuda")
        self._tables_np = self._tables_host.numpy()
        self._tables_dev = torch.empty(shape, dtype=torch.int32,
                                       device=self.device)
        self._len_np = np.zeros((ecfg.batch_size,), np.int64)

    def _paged_pool_blocks(self, bs: int) -> int:
        """Pool size in blocks (without the trash block): the explicit
        count, else what the byte budget buys at the pool's KV precision,
        else ``batch_size`` worst-case lanes; at least one whole lane."""
        ecfg, cfg = self.ecfg, self.cfg
        if ecfg.kv_pool_blocks is not None:
            n = int(ecfg.kv_pool_blocks)
        elif ecfg.kv_budget_bytes is not None:
            n = planning.kv_pool_blocks(ecfg.kv_budget_bytes, bs,
                                        cfg.n_layers, cfg.n_kv, cfg.head_dim,
                                        self.kv_bits)
        else:
            n = ecfg.batch_size * self._mbs
        return max(n, self._mbs)

    def _block_free_cap(self) -> int:
        """How many requests the block pool could hold now: the active set
        plus a non-mutating estimate of the admissible waiters (prefix
        sharing included), the memory bound ``SloController.batch_cap``
        takes."""
        prompts = [tuple(self._gen[r.uid][:r.prompt_len])
                   for r in self.sched.waiting]
        return self.sched.active + self.block_mgr.admission_cap(prompts)

    def _try_allocate(self, req: Request) -> bool:
        """The scheduler's admission gate: allocate the request's prefill
        blocks (sharing any registered prefix).  Consulted only when the
        request is otherwise certain to be admitted; False stops this
        iteration's admissions (FIFO holds)."""
        prompt = tuple(self._gen[req.uid][:req.prompt_len])
        if not self.block_mgr.can_allocate(prompt):
            return False
        self.block_mgr.allocate(req.uid, prompt)
        return True

    def _ensure_append_blocks(self, active: List[Request],
                              n: int = 1) -> List[Request]:
        """Grant every active lane the slots its next ``n`` KV writes land
        in (``n`` = k + 1 in a speculative round: the draft writes k of
        them and verify all n): in place in its frontier block, a fresh
        block at a block boundary, or a copy-on-write split off a shared
        block.  When the pool runs dry the newest request is preempted and
        the grant retried.  Returns the requests that still decode this
        step; the copies run as one batched in-place copy per pool
        tensor."""
        bs = int(self.ecfg.kv_block_size)
        cows: List[Tuple[int, int]] = []
        preempted: set = set()
        granted: List[Request] = []
        for req in active:
            if req.uid in preempted:
                continue
            for j in range(n):
                if req.uid in preempted:
                    break
                pos = int(self._len_np[req.slot]) + j
                while True:
                    res = self.block_mgr.append_slot(req.uid, pos)
                    if res is not None:
                        kind, src, dst = res
                        if kind in ("alloc", "cow"):
                            self._tables_np[req.slot, pos // bs] = dst
                        if kind == "cow":
                            cows.append((src, dst))
                        break
                    victim = self._pick_victim()
                    if victim is None:
                        raise MemoryError(
                            "KV block pool exhausted and preemption is "
                            "disabled (EngineConfig.preempt=False): grow "
                            "kv_pool_blocks or kv_budget_bytes")
                    self._preempt(victim)
                    preempted.add(victim.uid)
                    if victim is req:
                        break
            if req.uid not in preempted:
                granted.append(req)
        if cows:
            idx = lambda col: torch.as_tensor([c[col] for c in cows],
                                              dtype=torch.int64,
                                              device=self.device)
            lm._copy_blocks(self.cache["layers"], idx(0), idx(1))
        return [r for r in granted if r.uid not in preempted]

    def _pick_victim(self) -> Optional[Request]:
        """The newest running request that holds blocks (FIFO priority: the
        oldest work keeps its blocks), or None when preemption is off."""
        if not self.ecfg.preempt:
            return None
        for cand in reversed(self.sched.running):
            if self.block_mgr.has_table(cand.uid):
                return cand
        return None

    def _preempt(self, victim: Request) -> None:
        """Recompute-style eviction: free the victim's blocks, trash its
        table row, and requeue it at the FRONT of the waiting queue with
        its committed tokens as the resume prompt."""
        uid, slot = victim.uid, victim.slot
        self.block_mgr.preempt(uid)
        self._tables_np[slot, :] = self._trash
        self._len_np[slot] = 0
        self.sched.preempt(uid)
        victim.prompt_len = len(self._gen[uid])
        ev = self.events.setdefault(uid, {})
        ev["preemptions"] = ev.get("preemptions", 0) + 1
        ev["preempted_iteration"] = self.iterations

    # --- speculative rounds -------------------------------------------------
    def _speculative_round(self, active: List[Request], ctl) -> None:
        """One self-speculative round: k draft steps under the aggressive
        tree, one (k+1)-token verify under the served tree, then commit
        the accepted prefix and roll back the rest (``serving.speculative``).

        The accepted prefix commits token by token with the top-of-step
        commit's EOS / max-new checks; the correction (first rejection) or
        bonus (all accepted) token becomes the new pending ``_cur``.  The
        cache is updated in place, so the rewind before verify puts back a
        copy of ``length`` taken before the draft, and the rollback after
        it writes the accepted frontier; verify already rewrote every
        draft slot at the served precision, and slots past a lane's
        frontier stay invalid until rewritten in order.  On
        the paged pool the lane's table is truncated to its frontier
        (``BlockSpaceManager.truncate``) and its host length and table row
        follow, as they follow a preemption."""
        spec = self.spec_decoder
        k = spec.k
        bsz = self.ecfg.batch_size
        mask = np.zeros((bsz,), bool)
        uids = np.zeros((bsz,), np.int64)
        sidx = np.zeros((bsz,), np.int64)
        for req in active:
            mask[req.slot] = True
            uids[req.slot] = req.uid
            sidx[req.slot] = self._sample_index(req.uid)
        # the lengths before the draft: the rewind and the rollback's base
        prev_len = self.cache["length"].clone()
        new_len = prev_len.cpu().numpy().astype(np.int64)
        tables = None
        if self.paged:
            self._tables_dev.copy_(self._tables_host, non_blocking=True)
            tables = self._tables_dev
        temp = self.ecfg.temperature
        t0 = time.perf_counter()
        cur = torch.as_tensor(self._cur[:, None], device=self.device)
        d_toks, d_logits, self.cache = lm.draft_tokens(
            spec.draft_params, cur, self.cache, self.cfg, k,
            quant_kv=self._quant_kv, active_mask=mask, device=self.device,
            block_tables=tables, temperature=temp, seed=self.ecfg.seed,
            uids=uids, indices=sidx)
        # rewind: verify feeds the round again from its first position
        self.cache["length"] = prev_len
        v_logits, self.cache = lm.verify_step(
            self.params, torch.cat([cur, d_toks], dim=1), self.cache,
            self.cfg, quant_kv=self._quant_kv, active_mask=mask,
            device=self.device, block_tables=tables)
        draft_np = d_toks.cpu().numpy()
        if temp > 0:
            n_acc, nxt = spec.accept(
                draft_np, v_logits.cpu().numpy(), d_logits.cpu().numpy(),
                temperature=temp, seed=self.ecfg.seed, uids=uids,
                indices=sidx)
        else:
            # the greedy rule reads only the verify rows' argmax: take it
            # on the device, not the [B, k+1, V] logits to the host
            n_acc, nxt = accept_greedy(
                draft_np, torch.argmax(v_logits, dim=-1).cpu().numpy())
        # the copies above waited for the device: dt is the whole round
        dt = time.perf_counter() - t0
        self.iterations += 1
        self.decode_iterations += 1
        produced = 0
        # the rule's acceptance (draft quality): lanes that hit max_new or
        # EOS inside the prefix cut the commit, not the statistic
        accepted_total = int(n_acc[mask].sum())
        for req in active:
            s, uid = req.slot, req.uid
            self.events[uid].setdefault("first_decode_iteration",
                                        self.iterations)
            finished = False
            for j in range(int(n_acc[s])):
                tok = int(draft_np[s, j])
                self._gen[uid].append(tok)
                req.generated += 1
                produced += 1
                cb = self._on_token.get(uid)
                if cb is not None:
                    cb(uid, tok)
                if (tok == self.ecfg.eos_token
                        or req.generated >= req.max_new_tokens):
                    finished = True
                    break
            new_len[s] = len(self._gen[uid])
            if finished:
                self._finish(req)
                continue
            self._cur[s] = int(nxt[s])
            produced += 1
            if self.paged:
                dropped = self.block_mgr.truncate(uid, int(new_len[s]))
                if dropped:
                    keep = len(self.block_mgr.table(uid))
                    self._tables_np[s, keep:keep + dropped] = self._trash
                self._len_np[s] = int(new_len[s])
        # one write rolls every lane back to its accepted frontier
        self.cache["length"] = torch.as_tensor(new_len.astype(np.int32),
                                               device=self.device)
        self.decode_seconds += dt
        self._decode_tokens += produced
        exp = self._modeled_iter_seconds(len(active))
        if exp is not None:
            self.modeled_seconds += exp
        spec.note_round(len(active), accepted_total)
        if ctl is not None and ctl.observe(len(active), dt,
                                           self.decode_iterations):
            self._controller_step()

    # --- internals ----------------------------------------------------------
    def _padded_len(self, req: Request) -> int:
        # recurrent families fold every input token into their state, so
        # they prefill at exact length; attention families bucket (causal
        # masking and the ring's validity ignore the padding)
        bucket = (1 if self.cfg.family in ("ssm", "hybrid")
                  else max(1, self.ecfg.prompt_bucket))
        plen = req.prompt_len
        return max(min(-(-plen // bucket) * bucket,
                       max(self._clen, plen)), plen)

    def _prefill_slots(self, reqs: List[Request], padded: int) -> None:
        b = len(reqs)
        toks = np.zeros((b, padded), np.int64)
        lengths = np.zeros((b,), np.int32)
        for i, req in enumerate(reqs):
            toks[i, :req.prompt_len] = self._gen[req.uid][:req.prompt_len]
            lengths[i] = req.prompt_len
        slots = np.asarray([req.slot for req in reqs], np.int64)
        if self.paged:
            # scatter each token row through its request's table; padding
            # rows and rows of shared prefix blocks go to the trash block
            bs = int(self.ecfg.kv_block_size)
            phys = np.full((b, padded), self._trash, np.int64)
            offs = np.tile(np.arange(padded) % bs, (b, 1))
            for i, req in enumerate(reqs):
                table = self.block_mgr.table(req.uid)
                nsh = self.block_mgr.shared_prefix_blocks(req.uid)
                self._tables_np[req.slot] = self._trash
                self._tables_np[req.slot, :len(table)] = table
                t = np.arange(nsh * bs, req.prompt_len)
                phys[i, t] = np.asarray(table)[t // bs]
            with self._tp():
                logits, self.cache = lm.prefill_into_blocks(
                    self.params, toks, self.cache, slots, phys.ravel(),
                    offs.ravel(), self._mcfg, quant_kv=self._quant_kv,
                    lengths=lengths, device=self.device)
            for req in reqs:
                self._len_np[req.slot] = req.prompt_len
        else:
            with self._tp():
                logits, self.cache = lm.prefill_into_slot(
                    self.params, toks, self.cache, slots, self._mcfg,
                    quant_kv=self._quant_kv, lengths=lengths,
                    device=self.device)
        self.iterations += 1
        self.prefill_iterations += 1
        self.prefill_tokens += int(lengths.sum())
        first = self._sample(logits, [req.uid for req in reqs],
                             [self._sample_index(req.uid) for req in reqs])
        now = time.perf_counter()
        for i, req in enumerate(reqs):
            self._cur[req.slot] = int(first[i])
            # kept across preemption: TTFT is submit -> FIRST token
            self._ttft.setdefault(req.uid, now - self._t0[req.uid])
            req.state = DECODE
            ev = self.events.setdefault(req.uid, {})
            if "admitted_iteration" in ev:
                ev["resumed_iteration"] = self.iterations
            else:
                ev["admitted_iteration"] = self.iterations

    def _finish(self, req: Request) -> None:
        slot = req.slot
        self.sched.release(req.uid)
        if self.paged and self.block_mgr.has_table(req.uid):
            self.block_mgr.free(req.uid)
            self._tables_np[slot, :] = self._trash
            self._len_np[slot] = 0
        # the ORIGINAL prompt length: after a preemption req.prompt_len
        # covers the committed tokens too (the resume prompt)
        gen = self._gen[req.uid][self._orig_plen[req.uid]:]
        self.completions[req.uid] = Completion(
            uid=req.uid, tokens=gen,
            latency_s=time.perf_counter() - self._t0[req.uid],
            ttft_s=self._ttft.get(req.uid, 0.0))
        self.events[req.uid]["finished_iteration"] = self.iterations

    # --- batch-mode (run-to-completion) internals -------------------------
    def _serve_batch(self) -> None:
        """Admit a cohort, prefill it in one pass into a ring cache of its
        own, then run unmasked decode steps until every member is done
        (EOS or its max tokens); members that finish early ride along."""
        batch = self.sched.admit()
        if not batch:
            return
        ecfg, cfg = self.ecfg, self.cfg
        b = len(batch)
        maxlen = max(r.prompt_len for r in batch)
        toks = np.zeros((b, maxlen), np.int64)
        lengths = np.zeros((b,), np.int32)
        for i, r in enumerate(batch):
            p = self._gen[r.uid][:r.prompt_len]
            toks[i, :len(p)] = p
            lengths[i] = len(p)
        self.peak_active = max(self.peak_active, b)
        logits, cache = lm.prefill(
            self.params, toks, cfg, cache_len=self._clen,
            quant_kv=self._quant_kv, lengths=lengths, device=self.device)
        self.iterations += 1
        self.prefill_iterations += 1
        self.prefill_tokens += int(lengths.sum())
        uids = [r.uid for r in batch]
        cur = self._sample(logits, uids,
                           [self._sample_index(u) for u in uids])
        now = time.perf_counter()
        for r in batch:
            self._ttft[r.uid] = now - self._t0[r.uid]
        steps = max(r.max_new_tokens for r in batch)
        done_at: Dict[int, int] = {}
        for step in range(steps):
            for i, r in enumerate(batch):
                if r.uid in done_at:
                    continue
                if r.max_new_tokens <= 0:
                    done_at[r.uid] = step
                    continue
                tok = int(cur[i])
                self._gen[r.uid].append(tok)
                cb = self._on_token.get(r.uid)
                if cb is not None:
                    cb(r.uid, tok)
                if tok == ecfg.eos_token or step + 1 >= r.max_new_tokens:
                    done_at[r.uid] = step
            if len(done_at) == b or step == steps - 1:
                break
            logits, cache = lm.decode_step(
                self.params, cur[:, None], cache, cfg,
                quant_kv=self._quant_kv, device=self.device)
            self.iterations += 1
            self.decode_iterations += 1
            cur = self._sample(logits, uids,
                               [self._sample_index(u) for u in uids])
        for r in batch:
            self.completions[r.uid] = Completion(
                uid=r.uid, tokens=self._gen[r.uid][r.prompt_len:],
                latency_s=time.perf_counter() - self._t0[r.uid],
                ttft_s=self._ttft.get(r.uid, 0.0))
        self.sched.step_complete(uids)

    # --- sampling -----------------------------------------------------------
    def _sample_index(self, uid: int) -> int:
        """How many tokens this request has sampled and committed so far
        (0 at the prefill's sample): committed state only, so a resumed
        re-prefill re-samples the pending token under its original
        index."""
        return len(self._gen[uid]) - self._orig_plen.get(uid, 0)

    def _sample(self, logits: torch.Tensor, uids=None,
                indices=None) -> np.ndarray:
        """One token per logits row.  Greedy: argmax (first index on ties,
        as jnp.argmax).  At temperature T > 0, row b draws under the key of
        (``uids[b]``, ``indices[b]``); rows without a live request pass uid
        0 and the caller drops their draws."""
        if self.ecfg.temperature <= 0:
            return torch.argmax(logits, dim=-1).cpu().numpy()
        if uids is None:
            uids = indices = np.zeros((logits.shape[0],), np.int64)
        return prng.draw_rows(logits, uids, indices, self.ecfg.seed,
                              self.ecfg.temperature).tokens.cpu().numpy()

    def _tp(self):
        """The block every model call runs in: the tensor-parallel group's
        collectives at the engine's wire precision (nothing at tp=1)."""
        if self.tp_serving is None:
            return contextlib.nullcontext()
        return tp_context(self.tp_serving.group, self.wire_bits)

    def _agreed_seconds(self, dt: float) -> float:
        """A wall-clock reading every rank acts on alike: rank 0's,
        broadcast over the tensor-parallel group (``dt`` itself when
        serving on one device)."""
        if self.tp_serving is None:
            return dt
        group = self.tp_serving.group
        t = torch.tensor([dt], dtype=torch.float64)
        dist.broadcast(t, dist.get_global_rank(group, 0) if group is not None
                       else 0, group=group)
        return float(t.item())

    def measured_tps(self) -> Optional[float]:
        """Decode-phase tokens per wall second of masked decode steps."""
        if self.decode_seconds <= 0 or self._decode_tokens == 0:
            return None
        return self._decode_tokens / self.decode_seconds

    # --- plan pricing (the SAIL machine model, not the card) ----------------
    def _modeled_iter_seconds(self, occupancy: int) -> Optional[float]:
        """Modeled seconds of one scheduling quantum at ``occupancy`` lanes
        (lookup cycles scale with the batch, so it is nondecreasing: the
        controller's feasibility curve), memoized per plan; None when
        serving unquantized (no plan to price).  Plain decode: one masked
        iteration.  Speculative: one round, ``k * t_draft + t_verify``
        (``planning.speculative_round_seconds``)."""
        if self._plan_units is None:
            return None
        got = self._iter_cache.get(occupancy)
        if got is None:
            cost = self._plan_cost_model(occupancy)
            if self.spec_decoder is not None:
                got = planning.speculative_round_seconds(
                    cost, self._plan_units, self.spec_decoder.draft_units,
                    self.quant_policy.group_size, self._plan_fixed_bytes,
                    self.spec_decoder.k)
            else:
                total = (cost.qbytes(self._plan_units,
                                     self.quant_policy.group_size)
                         + self._plan_fixed_bytes)
                got = cost.iteration_seconds(cost.cycles(self._plan_units),
                                             total)
            self._iter_cache[occupancy] = got
        return got

    def _plan_cost_model(self, batch: int):
        """The served plan's ``DecodeCostModel`` at ``batch``, priced at the
        engine's shard count and wire precision under TP."""
        kw: Dict[str, Any] = {"batch": int(batch)}
        if self.tp_serving is not None:
            kw.update(tp=self.tp_serving.tp,
                      wire_bits=self.tp_serving.wire_bits,
                      allreduce_elems=planning.tp_allreduce_elems(self.cfg))
        return planning.plan_cost_model(self.plan, **kw)

    def _tokens_per_iter(self) -> float:
        """Tokens a lane commits per scheduling quantum: 1 for plain
        decode, E[accepted + 1] for a speculative round."""
        return (self.spec_decoder.expected_tokens()
                if self.spec_decoder is not None else 1.0)

    def planned_tps(self, batch: Optional[int] = None) -> Optional[float]:
        """Modeled decode tokens/s of the served plan at ``batch``
        occupancy (default: the full pool) on the SAIL machine model;
        None when serving unquantized.  A speculative round commits
        E[accepted + 1] tokens per lane."""
        b = self.ecfg.batch_size if batch is None else int(batch)
        secs = self._modeled_iter_seconds(b)
        if secs is None:
            return None
        return b * self._tokens_per_iter() / max(secs, 1e-30)

    def modeled_run_tps(self) -> Optional[float]:
        """Modeled tokens/s of the decode steps actually run, each priced
        at its occupancy: the counterpart of :meth:`measured_tps`."""
        if self.modeled_seconds <= 0 or self._decode_tokens == 0:
            return None
        return self._decode_tokens / self.modeled_seconds

    # --- live replanning ----------------------------------------------------
    def _tapped_hit_rate(self) -> Optional[float]:
        """PRT hit rate of the tapped traffic at the served plan's
        operating point (compare with the rate the plan was priced at)."""
        if self.tap is None:
            return None
        calib = self.tap.calib()
        if calib is None:
            return None
        from repro_torch.core import cost_model as cm
        from repro_torch.core import pattern
        merged = calib.get(None) if isinstance(calib, dict) else calib
        plan = self.plan
        wbits = (plan.weight_bits if plan is not None
                 and plan.weight_bits is not None else self.ecfg.ql)
        abits = (plan.act_bits if plan is not None
                 and plan.act_bits is not None else 8)
        nbw = plan.nbw if plan is not None else "auto"
        if not isinstance(nbw, int):
            k = int(merged.shape[-1])
            nbw = cm.best_nbw_for_unit(k, k, wbits, abits,
                                       batch=self.ecfg.batch_size)
        return pattern.prt_hit_rate(nbw, abits, merged)

    def _controller_step(self) -> None:
        """Apply the drift loop's requested action: replan (re-price on the
        tapped traffic) or, when the tapped PRT hit rate moved enough to
        change the allocation, a full re-solve.  Without a tap (or the raw
        weights) the action is recorded as skipped: the drift stays
        visible in ``stats()`` but nothing can act on it."""
        ctl = self.controller
        it = self.decode_iterations
        if not (self.tap is not None and self._raw_params is not None
                and self.tap.rows_seen > 0):
            ctl.acted("skipped", it)
            return
        action = ctl.decide(self._tapped_hit_rate(), self.prt_hit_rate)
        self.replan(resolve=(action == "resolve"))
        ctl.acted(action, it)

    def apply_plan(self, plan, force_requantize: bool = False) -> None:
        """Swap the engine onto a new (solved) plan between steps.

        Requantizes the retained raw weights under the plan's policy and
        swaps the parameter tree; the KV pool, the block tables, the
        scheduler and every in-flight request stay, so decoding continues
        without dropping a token.  Accepts a PlanSpec, grammar string /
        JSON, or a ``Planner`` ``PlanResult``.  A plan whose policy is the
        one served skips the requantization unless ``force_requantize``.
        KV precision, shard count and wire precision are fixed at
        construction: a plan asking for others warns and serves on; under
        TP the requantized tree is sharded again.  The plan's draft swaps in
        too: a different draft requantizes the draft tree, none stops
        speculating (the pending token carries over either way).
        """
        if self._raw_params is None:
            raise ValueError("apply_plan needs the raw weights resident "
                             "— construct the engine with quantize=True "
                             "and retain_raw=True (or a tap attached)")
        hit = None
        report = None
        if isinstance(plan, planning.PlanResult):
            hit = plan.measured_prt_hit_rate
            spec, policy, report = plan.spec, plan.policy, plan.report
        else:
            spec = planning.as_plan(plan)
            policy = spec.to_policy(self._base_policy())
        if isinstance(spec.kv_bits, int) and spec.kv_bits != self.kv_bits:
            warnings.warn(
                f"plan requests kv_bits={spec.kv_bits} but the KV pool "
                f"was allocated {self.kv_bits}-bit at construction — KV "
                "precision cannot hot-swap under in-flight requests; "
                "rebuild the engine to change it", UserWarning,
                stacklevel=2)
        if isinstance(spec.tp, int) and spec.tp != self.tp:
            warnings.warn(
                f"plan requests tp={spec.tp} but the engine serves "
                f"tp={self.tp} — the process group is fixed at construction; "
                "rebuild the engine to change shard count", UserWarning,
                stacklevel=2)
        if spec.wire is not None and spec.wire != self.wire_bits:
            warnings.warn(
                f"plan requests wire={spec.wire} but the engine serves "
                f"wire={self.wire_bits} — all-reduce precision is fixed at "
                "construction; rebuild the engine to change it",
                UserWarning, stacklevel=2)
        if force_requantize or policy != self.quant_policy:
            self.params, b0, b1 = quantize_params(self._raw_params, policy)
            self.compression = b0 / max(b1, 1)
            if self.tp_serving is not None:
                self.params = self.tp_serving.shard_params(self.params)
        self.quant_policy = policy
        self.plan = spec
        # the report tracks the plan actually served
        self.plan_report = report
        self.replan_count += 1
        if hit is not None:
            self.prt_hit_rate = hit
        # re-price: the swapped plan has its own units
        self._plan_units = planning.policy_units(self._raw_params, policy)
        self._plan_fixed_bytes = planning.unquantized_bytes(
            self._raw_params, policy)
        self._iter_cache.clear()
        if spec.target_tps is not None:
            self.slo = planning.Slo(spec.target_tps,
                                    batch=spec.slo_batch
                                    or self.ecfg.batch_size)
        draft = (spec.draft if isinstance(spec.draft, planning.DraftSpec)
                 else None)
        if draft is None:
            self.spec_decoder = None
        elif self.spec_decoder is None or self.spec_decoder.spec != draft:
            self.spec_decoder = SpeculativeDecoder(self._raw_params, self.cfg,
                                                   draft, policy)
        if self.controller is not None:
            # the swapped plan has its own feasibility curve: re-anchor
            self.controller.slo = self.slo
            self.controller.plan_changed(
                iter_seconds=self._modeled_iter_seconds,
                planned_tps=self.planned_tps(),
                plan_hit_rate=self.prt_hit_rate,
                tokens_per_iter=self._tokens_per_iter())

    def replan(self, planner=None, resolve: bool = False):
        """Online recalibration from live traffic: feed the tap's captured
        per-layer batches to ``Planner.replan`` (measured PRT discounts;
        ``resolve=True`` re-solves the allocation, on this engine's device)
        and swap the result in with :meth:`apply_plan`.  Pass a
        ``planner`` to reuse its cached probes across replans; otherwise a
        fresh one wraps the served plan.  Returns the ``PlanResult``."""
        if self.tap is None:
            raise ValueError("no ActivationTap attached — set "
                             "EngineConfig.tap_capacity > 0 (taps only "
                             "attach in mode='continuous')")
        if self._raw_params is None:
            raise ValueError("replan needs the raw weights resident — "
                             "construct the engine with quantize=True "
                             "and retain_raw=True (or rely on the tap "
                             "default)")
        if planner is None:
            planner = planning.Planner(self._raw_params, self.cfg, self.plan,
                                       base=self._base_policy())
            planner.last = planning.PlanResult(
                spec=self.plan, policy=self.quant_policy,
                report=self.plan_report)
        result = planner.replan(self.tap, resolve=resolve)
        self.apply_plan(result)
        return result

    def _tp_stats(self) -> Dict[str, Any]:
        """Tensor-parallel serving: shard count, wire precision, the
        all-reduce bytes one full-pool decode iteration moves per rank, and
        the SAIL machine model's wire seconds and their share of that
        iteration (None unquantized)."""
        b = self.ecfg.batch_size
        tw = (self._plan_cost_model(b).t_wire(b)
              if self._plan_units is not None else None)
        secs = self._modeled_iter_seconds(b)
        return {"shards": self.tp_serving.tp,
                "wire_bits": self.tp_serving.wire_bits,
                "allreduce_bytes_per_iter":
                    self.tp_serving.allreduce_bytes_per_iter(b),
                "modeled_t_wire_s": tw,
                "modeled_wire_share": (tw / secs if tw is not None
                                       and secs else None)}

    def stats(self) -> Dict[str, Any]:
        lats = [c.latency_s for c in self.completions.values()]
        ttfts = [c.ttft_s for c in self.completions.values()]
        measured = self.measured_tps()
        modeled = self.modeled_run_tps()
        planned = self.planned_tps()
        # measured (the card) against modeled (the SAIL machine): a raw
        # ratio, meaningful as a machine comparison only once a plan
        # carries constants fitted to the card (plan_calibrated)
        ref = modeled if modeled is not None else planned
        drift = (measured / ref - 1.0
                 if measured is not None and ref else None)
        return {"requests": len(self.completions),
                "generated_tokens": sum(len(c.tokens)
                                        for c in self.completions.values()),
                "measured_tps": measured,
                "planned_tps": planned,
                "modeled_run_tps": modeled,
                "drift": drift,
                "controller": (self.controller.stats()
                               if self.controller is not None else None),
                "speculative": (self.spec_decoder.stats()
                                if self.spec_decoder is not None else None),
                "peak_active": self.peak_active,
                "kv_bits": self.kv_bits,
                "tp": (self._tp_stats() if self.tp_serving is not None
                       else None),
                "block_pool": (self.block_mgr.stats() if self.paged
                               else None),
                "iterations": self.iterations,
                "prefill_iterations": self.prefill_iterations,
                "decode_iterations": self.decode_iterations,
                "prefill_tokens": self.prefill_tokens,
                "decode_seconds": self.decode_seconds,
                "weight_compression": round(self.compression, 2),
                "mixed_precision": bool(self.quant_policy is not None
                                        and self.quant_policy.is_mixed()),
                "plan_hash": (self.plan.spec_hash if self.plan is not None
                              else None),
                "plan_mode": (self.plan.mode if self.plan is not None
                              else None),
                "plan_calibrated": bool(self.plan is not None
                                        and self.plan.calibration
                                        is not None),
                "replan_count": self.replan_count,
                "prt_hit_rate": self.prt_hit_rate,
                "tapped_rows": (self.tap.rows_seen
                                if self.tap is not None else 0),
                "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
                "p99_latency_s": (float(np.percentile(lats, 99))
                                  if lats else 0.0),
                "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0}

