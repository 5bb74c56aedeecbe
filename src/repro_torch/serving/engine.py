"""Continuous-batching serving engine over a pool of KV-cache slots
(port of ``repro.serving.engine``, continuous mode, ring and paged pools).

One model iteration serves every active user (SAIL Sec. III-A), so each
layer's weights stream once per iteration for the whole batch:

  * ``init_cache`` allocates a fixed ``[batch_size, cache_len]`` KV pool
    once; requests are prefilled into free slots and retired per slot;
  * every ``step()`` admits waiting requests (FIFO, optional prefill-token
    budget), commits each active slot's pending token (retiring on
    EOS / max tokens), then runs one masked decode for the rest.

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
``calibrate_cost`` fit (``plan_calibrated``), never the card's.  Sampling
is greedy.  Not ported yet (ROADMAP, Queue 1 item 3): the controller
(with the paged pool's free-block cap), speculation and ``draft`` plans
(with the paged verify), tensor parallelism (``tp > 1``, with its paged
prefill), run-to-completion mode, unquantized serving and temperature
sampling.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import planning
from repro_torch.core.scheduler import DECODE, IterationScheduler, Request
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
    quantize_params
from repro_torch.serving.block_pool import BlockSpaceManager


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 8            # KV-pool slots (paper: 8 balances the pipe)
    cache_len: int = 4096
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
    # DEPRECATED legacy surface (use ``plan``): None, QuantPolicy, policy
    # spec dict, or grammar string
    bit_policy: Any = None
    eos_token: int = -1            # -1: never stop early
    prefill_budget: Optional[int] = None  # new prefill tokens per iteration
    prompt_bucket: int = 16        # prompts padded to a multiple
    # Paged KV pool: a block size replaces the [batch_size, cache_len] slot
    # pool with a shared pool of blocks (per-request block tables,
    # copy-on-write prefix sharing, block-gated admission, preemption).
    kv_block_size: Optional[int] = None   # tokens per block; None = slots
    # pool size (first match wins): a block count, a byte budget priced by
    # planning.cost.kv_pool_blocks, else batch_size slot-equivalents
    kv_pool_blocks: Optional[int] = None
    kv_budget_bytes: Optional[int] = None
    share_prefix: bool = True      # COW-share identical prompt prefixes
    preempt: bool = True           # evict the newest request when dry


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    latency_s: float
    ttft_s: float = 0.0            # submit -> first token available


class Engine:
    def __init__(self, params, cfg: ModelConfig, ecfg: EngineConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.ecfg = ecfg
        self.slo: Optional[planning.Slo] = None
        self.plan_report = None
        self.replan_count = 0
        self.prt_hit_rate: Optional[float] = None
        self.tap: Optional[planning.ActivationTap] = None
        if ecfg.plan is not None and ecfg.bit_policy is not None:
            raise ValueError("pass plan= OR the deprecated bit_policy=, "
                             "not both")
        if ecfg.slo is not None and ecfg.bit_policy is not None:
            raise ValueError("slo= requires plan= — the deprecated "
                             "bit_policy surface has no SLO semantics "
                             "and would silently ignore the target")
        if ecfg.tap_capacity > 0:
            self.tap = planning.ActivationTap(ecfg.tap_capacity,
                                              ecfg.tap_every)
        # the raw tree on this engine's device: the Planner's probes run
        # on it, and apply_plan requantizes it
        params = map_tensors(params, lambda t: t.to(self.device))
        self._resolve_plan(params)
        retain = (ecfg.retain_raw if ecfg.retain_raw is not None
                  else self.tap is not None)
        self._raw_params = params if retain else None
        self.params, b0, b1 = quantize_params(params, self.quant_policy)
        self.compression = b0 / max(b1, 1)
        # KV precision: a concrete plan kv_bits overrides quant_kv; the
        # pool's dtype is fixed from here on
        kvb = self.plan.kv_bits if isinstance(self.plan.kv_bits, int) \
            else None
        self.kv_bits = kvb if kvb is not None else (8 if ecfg.quant_kv
                                                    else 32)
        self._quant_kv = self.kv_bits == 8
        # plan pricing on the SAIL machine model: iteration seconds
        # memoized per occupancy, and the modeled seconds of the decode
        # steps run (each at its occupancy), the reference side of drift
        self._iter_cache: Dict[int, float] = {}
        self.modeled_seconds = 0.0
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
        self._cur = np.zeros((ecfg.batch_size,), np.int64)
        self.paged = ecfg.kv_block_size is not None
        self.block_mgr = None
        if self.paged:
            self._init_paged_pool(int(ecfg.kv_block_size))
        else:
            self.cache = lm.init_cache(cfg, ecfg.batch_size, self._clen,
                                       self._quant_kv, device=self.device)

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
        request longer than a lane's table holds (lanes never wrap)."""
        if self.paged:
            need = len(prompt) + max_new_tokens
            room = self._mbs * int(self.ecfg.kv_block_size)
            if need > room:
                raise ValueError(
                    f"request needs {need} KV positions but a paged lane "
                    f"holds {room} ({self._mbs} blocks x "
                    f"{self.ecfg.kv_block_size}); paged lanes never wrap: "
                    "raise cache_len or shorten the request")
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
        then one masked decode for every remaining slot.  Returns True
        while work remains."""
        admitted = self.sched.schedule(
            can_admit=self._try_allocate if self.paged else None)
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
        if self.paged and active:
            # every active lane appends one KV position: grant its block
            # slot first (copy-on-write off shared blocks, preempting the
            # newest request when the pool runs dry)
            active = self._ensure_append_blocks(active)
        self.peak_active = max(self.peak_active, len(active))
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
            out = lm.decode_step(
                self.params, self._cur[:, None], self.cache, self.cfg,
                quant_kv=self._quant_kv, active_mask=mask,
                device=self.device, block_tables=tables,
                capture_layer_inputs=capture)
            if capture:
                logits, self.cache, layer_inputs = out
                self.tap.observe(layer_inputs, mask)
            else:
                logits, self.cache = out
            nxt = self._sample(logits)
            # _sample copies to the host, so dt covers the whole iteration
            # (and any tap capture's copy)
            dt = time.perf_counter() - t0
            self.iterations += 1
            self.decode_iterations += 1
            self.decode_seconds += dt
            self._decode_tokens += len(active)
            self.modeled_seconds += self._modeled_iter_seconds(len(active))
            if self.paged:
                self._len_np[mask] += 1
            for req in active:
                self._cur[req.slot] = nxt[req.slot]
                self.events[req.uid].setdefault("first_decode_iteration",
                                                self.iterations)
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
        ecfg, cfg = self.ecfg, self.cfg
        if bs < 1:
            raise ValueError(f"kv_block_size={bs}: need >= 1")
        self._mbs = -(-self._clen // bs)       # table columns per lane
        nblocks = self._paged_pool_blocks(bs)
        self.block_mgr = BlockSpaceManager(nblocks, bs,
                                           share_prefix=ecfg.share_prefix)
        # one extra physical block: the trash block every dead table entry
        # and masked write points at
        self._trash = nblocks
        self.cache = lm.init_paged_cache(cfg, ecfg.batch_size, nblocks + 1,
                                         bs, self._quant_kv,
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

    def _ensure_append_blocks(self, active: List[Request]) -> List[Request]:
        """Grant every active lane the slot its next KV write lands in:
        in place in its frontier block, a fresh block at a block boundary,
        or a copy-on-write split off a shared block.  When the pool runs dry
        the newest request is preempted and the grant retried.  Returns the
        requests that still decode this step; the copies run as one batched
        in-place copy per pool tensor."""
        bs = int(self.ecfg.kv_block_size)
        cows: List[Tuple[int, int]] = []
        preempted: set = set()
        granted: List[Request] = []
        for req in active:
            if req.uid in preempted:
                continue
            pos = int(self._len_np[req.slot])
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
                        "KV block pool exhausted and preemption is disabled "
                        "(EngineConfig.preempt=False): grow kv_pool_blocks "
                        "or kv_budget_bytes")
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

    # --- internals ----------------------------------------------------------
    def _padded_len(self, req: Request) -> int:
        bucket = max(1, self.ecfg.prompt_bucket)
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
            logits, self.cache = lm.prefill_into_blocks(
                self.params, toks, self.cache, slots, phys.ravel(),
                offs.ravel(), self.cfg, quant_kv=self._quant_kv,
                lengths=lengths, device=self.device)
            for req in reqs:
                self._len_np[req.slot] = req.prompt_len
        else:
            logits, self.cache = lm.prefill_into_slot(
                self.params, toks, self.cache, slots, self.cfg,
                quant_kv=self._quant_kv, lengths=lengths, device=self.device)
        self.iterations += 1
        self.prefill_iterations += 1
        self.prefill_tokens += int(lengths.sum())
        first = self._sample(logits)
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

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy: argmax per row (first index on ties, as jnp.argmax)."""
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def measured_tps(self) -> Optional[float]:
        """Decode-phase tokens per wall second of masked decode steps."""
        if self.decode_seconds <= 0 or self._decode_tokens == 0:
            return None
        return self._decode_tokens / self.decode_seconds

    # --- plan pricing (the SAIL machine model, not the card) ----------------
    def _modeled_iter_seconds(self, occupancy: int) -> float:
        """Modeled seconds of one decode iteration at ``occupancy`` lanes
        (lookup cycles scale with the batch), memoized."""
        got = self._iter_cache.get(occupancy)
        if got is None:
            cost = planning.plan_cost_model(self.plan, batch=int(occupancy))
            total = (cost.qbytes(self._plan_units,
                                 self.quant_policy.group_size)
                     + self._plan_fixed_bytes)
            got = cost.iteration_seconds(cost.cycles(self._plan_units),
                                         total)
            self._iter_cache[occupancy] = got
        return got

    def planned_tps(self, batch: Optional[int] = None) -> float:
        """Modeled decode tokens/s of the served plan at ``batch``
        occupancy (default: the full pool) on the SAIL machine model."""
        b = self.ecfg.batch_size if batch is None else int(batch)
        return b / max(self._modeled_iter_seconds(b), 1e-30)

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
        wbits = (self.plan.weight_bits if self.plan.weight_bits is not None
                 else self.ecfg.ql)
        abits = self.plan.act_bits if self.plan.act_bits is not None else 8
        nbw = self.plan.nbw
        if not isinstance(nbw, int):
            k = int(merged.shape[-1])
            nbw = cm.best_nbw_for_unit(k, k, wbits, abits,
                                       batch=self.ecfg.batch_size)
        return pattern.prt_hit_rate(nbw, abits, merged)

    def apply_plan(self, plan, force_requantize: bool = False) -> None:
        """Swap the engine onto a new (solved) plan between steps.

        Requantizes the retained raw weights under the plan's policy and
        swaps the parameter tree; the KV pool, the block tables, the
        scheduler and every in-flight request stay, so decoding continues
        without dropping a token.  Accepts a PlanSpec, grammar string /
        JSON, or a ``Planner`` ``PlanResult``.  A plan whose policy is the
        one served skips the requantization unless ``force_requantize``.
        KV precision and shard count are fixed at construction: a plan
        asking for others warns and serves on.
        """
        if self._raw_params is None:
            raise ValueError("apply_plan needs the raw weights resident — "
                             "construct the engine with retain_raw=True "
                             "(or a tap attached)")
        hit = None
        report = None
        if isinstance(plan, planning.PlanResult):
            hit = plan.measured_prt_hit_rate
            spec, policy, report = plan.spec, plan.policy, plan.report
        else:
            spec = planning.as_plan(plan)
            planning.check_servable(spec)
            policy = spec.to_policy(self._base_policy())
        if isinstance(spec.kv_bits, int) and spec.kv_bits != self.kv_bits:
            warnings.warn(
                f"plan requests kv_bits={spec.kv_bits} but the KV pool "
                f"was allocated {self.kv_bits}-bit at construction — KV "
                "precision cannot hot-swap under in-flight requests; "
                "rebuild the engine to change it", UserWarning,
                stacklevel=2)
        if isinstance(spec.tp, int) and spec.tp != 1:
            warnings.warn(
                f"plan requests tp={spec.tp} but the engine serves tp=1 "
                "(tensor-parallel serving is not ported: ROADMAP, Queue 1 "
                "item 3)", UserWarning, stacklevel=2)
        if force_requantize or policy != self.quant_policy:
            self.params, b0, b1 = quantize_params(self._raw_params, policy)
            self.compression = b0 / max(b1, 1)
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

    def replan(self, planner=None, resolve: bool = False):
        """Online recalibration from live traffic: feed the tap's captured
        per-layer batches to ``Planner.replan`` (measured PRT discounts;
        ``resolve=True`` re-solves the allocation, on this engine's device)
        and swap the result in with :meth:`apply_plan`.  Pass a
        ``planner`` to reuse its cached probes across replans; otherwise a
        fresh one wraps the served plan.  Returns the ``PlanResult``."""
        if self.tap is None:
            raise ValueError("no ActivationTap attached — set "
                             "EngineConfig.tap_capacity > 0")
        if self._raw_params is None:
            raise ValueError("replan needs the raw weights resident — "
                             "construct the engine with retain_raw=True "
                             "(or rely on the tap default)")
        if planner is None:
            planner = planning.Planner(self._raw_params, self.cfg, self.plan,
                                       base=self._base_policy())
            planner.last = planning.PlanResult(
                spec=self.plan, policy=self.quant_policy,
                report=self.plan_report)
        result = planner.replan(self.tap, resolve=resolve)
        self.apply_plan(result)
        return result

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
                "peak_active": self.peak_active,
                "kv_bits": self.kv_bits,
                "block_pool": (self.block_mgr.stats() if self.paged
                               else None),
                "iterations": self.iterations,
                "prefill_iterations": self.prefill_iterations,
                "decode_iterations": self.decode_iterations,
                "prefill_tokens": self.prefill_tokens,
                "decode_seconds": self.decode_seconds,
                "weight_compression": round(self.compression, 2),
                "mixed_precision": self.quant_policy.is_mixed(),
                "plan_hash": self.plan.spec_hash,
                "plan_mode": self.plan.mode,
                "plan_calibrated": self.plan.calibration is not None,
                "replan_count": self.replan_count,
                "prt_hit_rate": self.prt_hit_rate,
                "tapped_rows": (self.tap.rows_seen
                                if self.tap is not None else 0),
                "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
                "p99_latency_s": (float(np.percentile(lats, 99))
                                  if lats else 0.0),
                "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0}

