"""Continuous-batching serving engine over a fixed pool of KV-cache slots
(port of ``repro.serving.engine``, continuous mode, ring pool).

One model iteration serves every active user (SAIL Sec. III-A), so each
layer's weights stream once per iteration for the whole batch:

  * ``init_cache`` allocates a fixed ``[batch_size, cache_len]`` KV pool
    once; requests are prefilled into free slots and retired per slot;
  * every ``step()`` admits waiting requests (FIFO, optional prefill-token
    budget), commits each active slot's pending token (retiring on
    EOS / max tokens), then runs one masked decode for the rest.

Weights are SAIL-quantized from ``ql``/``group_size``/``min_size``, or
from a ``plan`` of the form ``uniform:<b>[a<ab>]``; KV is int8 when
``quant_kv``.  Sampling is greedy.  Not ported yet (ROADMAP): the planner
and controller, taps, the paged pool, speculation, tensor parallelism,
run-to-completion mode, unquantized serving and temperature sampling.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.scheduler import DECODE, IterationScheduler, Request
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
    quantize_params

_UNIFORM = re.compile(r"^uniform:(\d+)(?:a(\d+))?$")


def parse_plan(plan: str) -> Tuple[int, Optional[int]]:
    """``uniform:<b>[a<ab>]`` -> (weight bits, activation bits or None)."""
    m = _UNIFORM.match(plan.strip()) if isinstance(plan, str) else None
    if m is None:
        raise ValueError(
            f"plan {plan!r}: only 'uniform:<b>[a<ab>]' is ported; rules/auto "
            "plans and PlanSpec objects wait for the planning slice "
            "(ROADMAP)")
    return int(m.group(1)), None if m.group(2) is None else int(m.group(2))


@dataclasses.dataclass
class EngineConfig:
    batch_size: int = 8            # KV-pool slots (paper: 8 balances the pipe)
    cache_len: int = 4096
    ql: int = 4
    group_size: int = 128
    quant_kv: bool = True
    min_size: int = 1024           # quantize tensors >= this many elements
    plan: Optional[str] = None     # "uniform:<b>[a<ab>]"
    eos_token: int = -1            # -1: never stop early
    prefill_budget: Optional[int] = None  # new prefill tokens per iteration
    prompt_bucket: int = 16        # prompts padded to a multiple


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
        bits, abits = (parse_plan(ecfg.plan) if ecfg.plan is not None
                       else (ecfg.ql, None))
        self.quant_policy = QuantPolicy(bits=bits, group_size=ecfg.group_size,
                                        min_size=ecfg.min_size, act_bits=abits)
        self.params, b0, b1 = quantize_params(
            map_tensors(params, lambda t: t.to(self.device)),
            self.quant_policy)
        self.compression = b0 / max(b1, 1)
        self._quant_kv = bool(ecfg.quant_kv)
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
        self._clen = (ecfg.cache_len if cfg.window is None
                      else min(ecfg.cache_len, cfg.window))
        self._cur = np.zeros((ecfg.batch_size,), np.int64)
        self.cache = lm.init_cache(cfg, ecfg.batch_size, self._clen,
                                   self._quant_kv, device=self.device)

    # --- client API -------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int,
               on_token: Optional[Callable[[int, int], None]] = None) -> int:
        """Queue a request; returns its uid.  ``on_token(uid, token)`` is
        called as each generated token is committed."""
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
        admitted = self.sched.schedule()
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
        self.peak_active = max(self.peak_active, len(active))
        if active:
            mask = np.zeros((self.ecfg.batch_size,), bool)
            for req in active:
                mask[req.slot] = True
            t0 = time.perf_counter()
            logits, self.cache = lm.decode_step(
                self.params, self._cur[:, None], self.cache, self.cfg,
                quant_kv=self._quant_kv, active_mask=mask,
                device=self.device)
            nxt = self._sample(logits)
            # _sample copies to the host, so dt covers the whole iteration
            dt = time.perf_counter() - t0
            self.iterations += 1
            self.decode_iterations += 1
            self.decode_seconds += dt
            self._decode_tokens += len(active)
            for req in active:
                self._cur[req.slot] = nxt[req.slot]
        return not self.sched.idle()

    def run(self) -> List[Completion]:
        """Serve until all submitted requests finish."""
        while self.step():
            pass
        return list(self.completions.values())

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
            self._ttft.setdefault(req.uid, now - self._t0[req.uid])
            req.state = DECODE

    def _finish(self, req: Request) -> None:
        self.sched.release(req.uid)
        gen = self._gen[req.uid][self._orig_plen[req.uid]:]
        self.completions[req.uid] = Completion(
            uid=req.uid, tokens=gen,
            latency_s=time.perf_counter() - self._t0[req.uid],
            ttft_s=self._ttft.get(req.uid, 0.0))

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """Greedy: argmax per row (first index on ties, as jnp.argmax)."""
        return torch.argmax(logits, dim=-1).cpu().numpy()

    def measured_tps(self) -> Optional[float]:
        """Decode-phase tokens per wall second of masked decode steps."""
        if self.decode_seconds <= 0 or self._decode_tokens == 0:
            return None
        return self._decode_tokens / self.decode_seconds

    def stats(self) -> Dict[str, Any]:
        lats = [c.latency_s for c in self.completions.values()]
        ttfts = [c.ttft_s for c in self.completions.values()]
        return {"requests": len(self.completions),
                "generated_tokens": sum(len(c.tokens)
                                        for c in self.completions.values()),
                "measured_tps": self.measured_tps(),
                "peak_active": self.peak_active,
                "kv_bits": 8 if self._quant_kv else 32,
                "iterations": self.iterations,
                "prefill_iterations": self.prefill_iterations,
                "decode_iterations": self.decode_iterations,
                "prefill_tokens": self.prefill_tokens,
                "decode_seconds": self.decode_seconds,
                "weight_compression": round(self.compression, 2),
                "mean_latency_s": float(np.mean(lats)) if lats else 0.0,
                "p99_latency_s": (float(np.percentile(lats, 99))
                                  if lats else 0.0),
                "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0}

