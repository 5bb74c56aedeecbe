"""Iteration-level continuous-batching scheduler (port of the slot
scheduler in ``repro.core.scheduler``; pure Python, copied).

One model iteration serves every active user (SAIL Sec. III-A), requests
occupy fixed KV-pool slots from admission to retirement, and freed slots
are back-filled from the FIFO queue at iteration granularity under a
Sarathi-style per-iteration prefill-token budget.  The paged engine
gates admission on free KV blocks (``schedule(can_admit=...)``) and
requeues a preempted request at the front (``preempt``).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

# Request lifecycle: WAITING -> PREFILL (slot assigned) -> DECODE -> DONE.
WAITING = "waiting"
PREFILL = "prefill"
DECODE = "decode"
DONE = "done"


@dataclasses.dataclass
class Request:
    uid: int
    prompt_len: int
    max_new_tokens: int
    arrived_at: float = 0.0
    generated: int = 0
    done: bool = False
    state: str = WAITING
    slot: int = -1                # KV-pool row while PREFILL/DECODE


@dataclasses.dataclass
class IterationScheduler:
    """Iteration-based scheduler over a fixed pool of KV-cache slots.

    ``schedule()`` admits in arrival order, one pool slot per request, and
    caps the prompt tokens newly admitted per call at ``prefill_budget``
    (the first admission is exempt so an over-budget prompt cannot
    starve).  ``release()`` returns a finished request's slot to the free
    list, so a request arriving mid-decode joins the next iteration.
    """
    target_batch: int = 8
    max_batch: int = 32
    prefill_budget: Optional[int] = None   # new prefill tokens / iteration
    waiting: List[Request] = dataclasses.field(default_factory=list)
    running: List[Request] = dataclasses.field(default_factory=list)
    finished: List[Request] = dataclasses.field(default_factory=list)
    free_slots: List[int] = dataclasses.field(default_factory=list)
    _slots_init: bool = False

    def submit(self, req: Request) -> None:
        self.waiting.append(req)

    def _ensure_slots(self) -> None:
        if not self._slots_init:
            self.free_slots = list(range(self.max_batch))
            self._slots_init = True

    def schedule(self, max_active: Optional[int] = None,
                 can_admit: Optional[Callable[[Request], bool]] = None
                 ) -> List[Request]:
        """Admit waiting requests into free slots; return the newly
        admitted ones (state PREFILL, ``slot`` assigned).

        ``can_admit``: optional callback consulted last, immediately before
        a request would be admitted — the paged engine's block gate, which
        allocates the request's blocks as a side effect.  A False answer
        stops admission for this call, keeping FIFO order."""
        self._ensure_slots()
        admitted: List[Request] = []
        used = 0
        while self.waiting and self.free_slots:
            if max_active is not None and len(self.running) >= max_active:
                break
            nxt = self.waiting[0]
            if (admitted and self.prefill_budget is not None
                    and used + nxt.prompt_len > self.prefill_budget):
                break
            if can_admit is not None and not can_admit(nxt):
                break
            req = self.waiting.pop(0)
            req.slot = self.free_slots.pop(0)
            req.state = PREFILL
            used += req.prompt_len
            self.running.append(req)
            admitted.append(req)
        return admitted

    def preempt(self, uid: int) -> Request:
        """Evict a running request back to the FRONT of the waiting queue
        (recompute-style preemption): its slot is freed and it resumes
        first once blocks free up.  The engine releases its KV blocks and
        extends ``prompt_len`` over its committed tokens."""
        for r in self.running:
            if r.uid == uid:
                self.running.remove(r)
                if r.slot >= 0:
                    self.free_slots.append(r.slot)
                    self.free_slots.sort()
                    r.slot = -1
                r.state = WAITING
                self.waiting.insert(0, r)
                return r
        raise KeyError(f"uid {uid} not running")

    def release(self, uid: int) -> Request:
        """Retire a finished request; its slot returns to the free pool."""
        for r in self.running:
            if r.uid == uid:
                self.running.remove(r)
                r.done = True
                r.state = DONE
                if r.slot >= 0:
                    self.free_slots.append(r.slot)
                    self.free_slots.sort()
                    r.slot = -1
                self.finished.append(r)
                return r
        raise KeyError(f"uid {uid} not running")

    @property
    def active(self) -> int:
        return len(self.running)

    def idle(self) -> bool:
        return not self.waiting and not self.running
