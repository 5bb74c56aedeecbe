"""Tensor-level scheduling, ping-pong pipelining and the iteration
scheduler (port of ``repro.core.scheduler``; pure Python, copied).

SAIL Sec. III-A loads each layer's weights into the LLC once per
iteration and runs every user against them (weight temporal locality),
with the cache split into two halves as a ping-pong buffer so the stream
of layer L+1 overlaps the compute of layer L:

  * ``TensorSchedule`` / ``plan_tensor_schedule`` — the (layer, tensor) ->
    phase residency plan over the two halves;
  * ``PipelineModel`` — analytic ping-pong timing (the bubble-free batch,
    the throughput knee the paper finds near batch 8);
  * ``IterationScheduler`` — the engine's scheduler: one model iteration
    serves every active user, requests occupy fixed KV-pool slots from
    admission to retirement, and freed slots are back-filled from the
    FIFO queue at iteration granularity under a Sarathi-style
    per-iteration prefill-token budget.  The paged engine gates admission
    on free KV blocks (``schedule(can_admit=...)``) and requeues a
    preempted request at the front (``preempt``); ``admit`` /
    ``step_complete`` are the run-to-completion (``mode="batch"``)
    interface.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class TensorPlacement:
    name: str
    nbytes: int
    layer: int
    buffer: int           # 0/1 ping-pong half
    phase: int            # pipeline step in which it is resident


@dataclasses.dataclass
class TensorSchedule:
    """Layer-at-a-time residency plan over a two-half buffer of given size."""
    placements: List[TensorPlacement]
    buffer_bytes: int
    n_phases: int

    def residency(self, phase: int) -> List[TensorPlacement]:
        return [p for p in self.placements if p.phase == phase]


def plan_tensor_schedule(layer_tensors: Sequence[Sequence[Tuple[str, int]]],
                         buffer_bytes: int) -> TensorSchedule:
    """Assign each layer's tensors to alternating ping-pong halves.

    layer_tensors: per layer, a list of (tensor_name, nbytes).  Each half
    holds one layer's working set; a layer larger than half the buffer is
    split into tiles (the sc/loc fields of ``lutmm_1k``), each its own
    phase, tensors placed largest first on the emptiest tile that fits.
    """
    half = buffer_bytes // 2
    placements: List[TensorPlacement] = []
    phase = 0
    for layer, tensors in enumerate(layer_tensors):
        total = sum(b for _, b in tensors)
        n_tiles = max(1, -(-total // half))   # ceil: split layer into tiles
        per_tile = [[] for _ in range(n_tiles)]
        acc = [0] * n_tiles
        for name, b in sorted(tensors, key=lambda t: -t[1]):
            i = min(range(n_tiles), key=lambda j: acc[j])
            if acc[i] + b > half and b <= half:
                i = next((j for j in range(n_tiles) if acc[j] + b <= half), i)
            per_tile[i].append((name, b))
            acc[i] += b
        for tile in per_tile:
            for name, b in tile:
                placements.append(TensorPlacement(
                    name=name, nbytes=b, layer=layer,
                    buffer=phase % 2, phase=phase))
            phase += 1
    return TensorSchedule(placements=placements, buffer_bytes=buffer_bytes,
                          n_phases=phase)


@dataclasses.dataclass
class PipelineModel:
    """Analytic ping-pong pipeline (paper Fig. 4).

    Per phase one buffer half is written with the next weight tile
    (t_write = tile_bytes / stream_bw) while the other half feeds compute
    (t_compute = batch * tile_bytes / compute_rate).  The pipeline is
    bubble-free iff t_write <= t_compute.
    """
    stream_bw: float              # bytes/s into the buffer (DRAM->LLC)
    compute_rate: float           # effective bytes/s consumed by compute at B=1

    def phase_time(self, tile_bytes: int, batch: int) -> float:
        t_write = tile_bytes / self.stream_bw
        t_compute = batch * tile_bytes / self.compute_rate
        return max(t_write, t_compute)

    def iteration_time(self, tile_bytes_seq: Iterable[int],
                       batch: int) -> float:
        seq = list(tile_bytes_seq)
        if not seq:
            return 0.0
        # fill: first write is exposed; afterwards phases overlap
        fill = seq[0] / self.stream_bw
        return fill + sum(self.phase_time(b, batch) for b in seq)

    def bubble_free_batch(self, tile_bytes: int) -> int:
        """Smallest batch at which compute fully hides the write stream."""
        b = 1
        while (b * tile_bytes / self.compute_rate
               < tile_bytes / self.stream_bw and b < 1024):
            b += 1
        return b

    def optimal_batch(self, tile_bytes: int, max_batch: int = 64) -> int:
        """Batch maximising aggregate throughput B / phase_time(B): the
        knee where it stops rising by more than 2% (the paper's Fig. 6
        plateau beyond about 7-8)."""
        best_b, best_rate = 1, 0.0
        for b in range(1, max_batch + 1):
            rate = b / self.phase_time(tile_bytes, b)
            if rate > best_rate * 1.02:      # 2% hysteresis finds the knee
                best_b, best_rate = b, rate
        return best_b

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

    # --- run-to-completion (mode="batch") interface -----------------------

    def admit(self) -> List[Request]:
        """Fill the running batch up to ``target_batch`` from the FIFO
        queue; returns the whole running batch."""
        while self.waiting and len(self.running) < self.target_batch:
            req = self.waiting.pop(0)
            req.state = DECODE
            self.running.append(req)
        return list(self.running)

    def step_complete(self, finished_uids: Sequence[int]) -> None:
        """One token for every running request; those named, or at their
        ``max_new_tokens``, retire."""
        done = set(finished_uids)
        still = []
        for r in self.running:
            r.generated += 1
            if r.uid in done or r.generated >= r.max_new_tokens:
                r.done = True
                r.state = DONE
                self.finished.append(r)
            else:
                still.append(r)
        self.running = still

    @property
    def active(self) -> int:
        return len(self.running)

    def idle(self) -> bool:
        return not self.waiting and not self.running
