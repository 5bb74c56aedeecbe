"""DecodeCostModel: one pricing facade for precision plans (port of
``repro.planning.cost``, copied).

It prices plans on the paper's SAIL machine (``core.cost_model``: CPU
plus C-SRAM at 3 GHz over 204.8 GB/s DDR4), not on the H100 the port
serves on: ``planned_tps`` and ``drift`` in ``Engine.stats()`` are that
modeled machine's figures.  ``planning.calibrate_cost`` refits its
constants to timings taken on this host (an effective SAIL machine, still
not the card's LUT-GEMV speed); ``machine_from_json`` /
``dispatch_from_json`` read a plan's fitted constants when it carries
them.

Consolidates the cost primitives that used to be wired together ad hoc
(``mixed_decode_cycles`` / ``resolve_prt_discount`` / ``best_nbw_for_unit``)
and — the DRAM-aware objective from the ROADMAP — folds the weight-stream
time into the modeled decode iteration:

    t_iter = max(t_dram, t_compute)        (ping-pong overlap, Sec. III-A)
    t_dram = total_weight_bytes / (dram_bw * dram_efficiency)

so a byte-heavy allocation can no longer hide behind the compute bound.
Because the iteration time is a max of two linear terms, an SLO (target
decode tokens/s at a batch) decomposes *exactly* into two linear budgets
the joint allocator already knows how to enforce:

    T            = batch / target_tps            seconds per iteration
    cycle_budget = T * freq_hz                   C-SRAM compute budget
    byte_budget  = T * dram_bw * eff - fixed     weight-stream budget

(``fixed`` is the DRAM traffic of the leaves the policy does not
quantize — embeddings, norms — which streams every iteration whatever
the plan says.)  ``Planner.solve(slo=...)`` is just this decomposition
plus the existing solver.

Tensor-parallel pricing: sharding the weight tree ``tp`` ways
divides both the compute and the weight stream but adds a wire term —
two ring all-reduces per layer (``wo`` and ``w_down`` partial sums):

    t_iter = max(t_compute / M, t_dram / M, t_wire)
    t_wire = 2(M-1)/M * batch * allreduce_elems * wire_bits/8 / link_bw

so the Planner can trade bits against shards at a fixed SLO: per-shard
budgets scale by M, while ``t_wire`` — which no bit allocation changes —
caps how far sharding helps.  ``wire_bits=8`` prices the compressed
(int8+scale) all-reduce.

Per-layer PRT calibration: ``calib`` may be one f32 ``[B, K]`` activation
batch or a ``{layer: batch}`` mapping (``None`` key = global fallback),
e.g. from the reference's ``planning.tap.ActivationTap.calib()`` — each
unit is then discounted by its own layer's measured hit rate.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

from repro_torch.core import cost_model as cm
from repro_torch.core.pattern import calib_for_layer

# Inter-shard link bandwidth when no measured/configured value is given:
# one PCIe 4.0 x16 link's practical ~16 GB/s — the class of interconnect
# the commodity-hardware deployments SAIL targets actually have.
DEFAULT_LINK_BW = 16e9


def tp_allreduce_elems(cfg) -> int:
    """All-reduce payload elements per decode token: one ``d_model``
    partial sum per attention (``wo``) and one per MLP (``w_down``) in
    every layer.  ``cfg`` is duck-typed (needs ``n_layers``/``d_model``)."""
    return 2 * int(cfg.n_layers) * int(cfg.d_model)


@dataclasses.dataclass(frozen=True)
class Slo:
    """A decode service-level objective: aggregate tokens/s at a batch."""

    target_tps: float
    batch: int = 8

    def __post_init__(self):
        if self.target_tps <= 0:
            raise ValueError(f"target_tps must be positive, got {self.target_tps}")
        if self.batch < 1:
            raise ValueError(f"batch must be >= 1, got {self.batch}")

    @property
    def seconds_per_iteration(self) -> float:
        """One masked decode iteration commits ``batch`` tokens, so the
        SLO bounds its latency at batch/target seconds."""
        return self.batch / self.target_tps


@dataclasses.dataclass(frozen=True)
class Budgets:
    """SLO-derived solver budgets (see module docstring for derivation)."""

    seconds: float
    cycle_budget: float
    byte_budget: Optional[int]
    fixed_bytes: int = 0


@dataclasses.dataclass(frozen=True)
class PlanCost:
    """Modeled cost of one plan/policy on one model.

    ``t_compute`` / ``t_dram`` are per-shard times (already divided by
    the model's ``tp``); ``t_wire`` is the per-iteration all-reduce time
    (0.0 at ``tp=1``)."""

    cycles: float
    quant_bytes: int
    fixed_bytes: int
    t_compute: float
    t_dram: float
    seconds_per_iteration: float
    tokens_per_second: float
    t_wire: float = 0.0

    @property
    def total_bytes(self) -> int:
        return self.quant_bytes + self.fixed_bytes

    @property
    def dram_bound(self) -> bool:
        return self.t_dram > self.t_compute

    @property
    def bound(self) -> str:
        """Which term sets the iteration time: "compute", "dram", or
        "wire" — the regime the SLO solver is trading within."""
        terms = {"compute": self.t_compute, "dram": self.t_dram,
                 "wire": self.t_wire}
        return max(terms, key=terms.get)


@dataclasses.dataclass(frozen=True)
class DecodeCostModel:
    """Prices (cycles, bytes, seconds, tokens/s) of precision plans.

    ``prt`` selects the pattern-discount model (False/"off", True/"paper",
    "measured"); ``nbw`` is a fixed NBW or "auto" (per-unit cycle-optimal);
    ``include_dram=False`` reverts to the legacy compute-only objective
    (the pre-PlanSpec behavior, kept for A/B in the bench).

    ``tp`` / ``wire_bits`` / ``link_bw`` / ``allreduce_elems`` price
    tensor-parallel serving (module docstring): compute and DRAM divide
    by the shard count, the all-reduce adds ``t_wire``.
    ``dispatch_cycles`` is an optional per-(NBW, abits) fixed
    kernel-dispatch overhead fitted by the reference's
    ``planning.calibrate_cost`` —
    (((nbw, abits), cycles), ...) pairs, charged once per kernel
    invocation.
    """

    machine: cm.SailMachine = dataclasses.field(default_factory=cm.SailMachine)
    batch: int = 8
    threads: int = 16
    prt: Any = "paper"
    nbw: Any = "auto"
    include_dram: bool = True
    calib: Any = None
    tp: int = 1
    wire_bits: int = 32
    link_bw: Optional[float] = None
    allreduce_elems: float = 0.0
    dispatch_cycles: Any = None

    def __post_init__(self):
        from repro_torch.core import pattern

        object.__setattr__(self, "calib", pattern.canonical_calib(self.calib))
        if self.tp < 1:
            raise ValueError(f"tp must be >= 1, got {self.tp}")
        if self.wire_bits not in (8, 32):
            raise ValueError(f"wire_bits must be 8 or 32, got {self.wire_bits}")
        disp = self.dispatch_cycles
        if disp is not None and not isinstance(disp, tuple):
            # accept dicts / lists (JSON provenance) but store hashably
            items = disp.items() if hasattr(disp, "items") else disp
            disp = tuple(
                sorted(
                    (
                        (
                            (int(k.split(":")[0]), int(k.split(":")[1]))
                            if isinstance(k, str)
                            else (int(k[0]), int(k[1]))
                        ),
                        float(v),
                    )
                    for k, v in items
                )
            )
            object.__setattr__(self, "dispatch_cycles", disp)

    # -- per-unit pricing -------------------------------------------------

    def discount(self, nbw: int, wbits: int, abits: int, layer=None) -> float:
        """Lookup-cycle discount for one (nbw, wbits, abits) point, using
        the layer's own calibration batch when one was captured."""
        return cm.resolve_prt_discount(
            self.prt, nbw, wbits, abits, calib_for_layer(self.calib, layer), self.machine
        )

    def _dispatch(self, nbw: int, abits: int) -> float:
        """Fixed per-invocation dispatch overhead at this (NBW, abits)
        cell (0.0 when no calibration fitted one)."""
        if not self.dispatch_cycles:
            return 0.0
        want = (int(nbw), int(abits))
        for key, cyc in self.dispatch_cycles:
            if key == want:
                return cyc
        return 0.0

    def unit_cycles(self, k, n, wbits, abits, copies: int = 1, layer=None) -> float:
        """C-SRAM cycles of one [K, N] matrix at its allocated precision
        (f32 activations — abits None — are priced at the 8-bit default,
        matching ``mixed_decode_cycles``)."""
        ab = 8 if abits is None else int(abits)
        calib = calib_for_layer(self.calib, layer)
        if self.nbw == "auto":
            nbw_used, cyc = cm._best_nbw_and_cycles(
                k, n, wbits, ab, self.batch, self.threads, self.machine, self.prt, calib
            )
        else:
            nbw_used = int(self.nbw)
            disc = cm.resolve_prt_discount(self.prt, nbw_used, wbits, ab, calib, self.machine)
            cyc = cm.lut_gemv_cycles(
                self.machine, self.batch, k, n, nbw_used, wbits, ab, self.threads, disc
            )
        return copies * (cyc + self._dispatch(nbw_used, ab))

    def best_nbw(self, k, n, wbits, abits, layer=None) -> int:
        ab = 8 if abits is None else int(abits)
        return cm._best_nbw_and_cycles(
            k,
            n,
            wbits,
            ab,
            self.batch,
            self.threads,
            self.machine,
            self.prt,
            calib_for_layer(self.calib, layer),
        )[0]

    # -- whole-plan pricing -----------------------------------------------

    def cycles(self, units) -> float:
        """Projected C-SRAM cycles of one decode iteration.

        ``units``: (k, n, wbits, abits, copies[, layer]) tuples — the
        output of :func:`policy_units`.
        """
        total = 0.0
        for u in units:
            k, n, wb, ab, copies = u[0], u[1], u[2], u[3], u[4]
            layer = u[5] if len(u) > 5 else None
            total += self.unit_cycles(k, n, wb, ab, copies, layer)
        return total

    def qbytes(self, units, group_size: int) -> int:
        """QTensor bytes of the allocation (packed words + scales)."""
        return sum(cm.qtensor_bytes(u[0], u[1], u[2], group_size, u[4]) for u in units)

    def t_compute(self, cycles: float) -> float:
        """Per-shard compute time: each of the ``tp`` shards runs 1/tp of
        every matmul's lookups."""
        return cycles / self.machine.freq_hz / self.tp

    def t_dram(self, total_bytes: float) -> float:
        """Per-shard weight-stream time: the sharded tree streams 1/tp of
        the bytes per device."""
        if not self.include_dram:
            return 0.0
        return total_bytes / (self.machine.dram_bw * self.machine.dram_efficiency) / self.tp

    def t_wire(self, batch=None) -> float:
        """Per-iteration all-reduce time: a ring all-reduce moves
        ``2(M-1)/M`` of the payload per shard, and the payload is one
        partial sum per row-parallel matmul per token
        (``allreduce_elems`` elements at ``wire_bits``)."""
        if self.tp <= 1 or self.allreduce_elems <= 0:
            return 0.0
        b = self.batch if batch is None else batch
        payload = b * self.allreduce_elems * self.wire_bits / 8.0
        bw = self.link_bw if self.link_bw is not None else DEFAULT_LINK_BW
        return 2.0 * (self.tp - 1) / self.tp * payload / bw

    def iteration_seconds(self, cycles: float, total_bytes: float) -> float:
        """Ping-pong LLC overlap: the weight stream hides behind compute
        (or vice versa) and the all-reduce overlaps the other layers'
        work, so one iteration costs the max of the three terms."""
        return max(self.t_compute(cycles), self.t_dram(total_bytes), self.t_wire())

    def tokens_per_second(self, cycles: float, total_bytes: float, batch=None) -> float:
        b = self.batch if batch is None else batch
        return b / max(self.iteration_seconds(cycles, total_bytes), 1e-30)

    def budgets(self, slo: Slo, fixed_bytes: int = 0) -> Budgets:
        """Decompose an SLO into the joint solver's two linear budgets.

        Under TP the per-shard budgets scale by the shard count (the
        model streams/computes 1/tp per device), while ``t_wire`` —
        which no bit allocation changes — must fit on its own or the SLO
        is unreachable at this (tp, wire) point."""
        t = slo.seconds_per_iteration
        tw = self.t_wire(slo.batch)
        if tw >= t:
            raise ValueError(
                f"SLO {slo.target_tps} tok/s @ batch {slo.batch} is unreachable at "
                f"tp={self.tp}, wire={self.wire_bits}: the all-reduce alone takes "
                f"{tw:.2e}s of the {t:.2e}s iteration budget — no bit allocation "
                "can fix a wire-bound plan (fewer shards or wire=8 might)"
            )
        cycle_budget = t * self.machine.freq_hz * self.tp
        byte_budget = None
        if self.include_dram:
            byte_budget = int(
                t * self.machine.dram_bw * self.machine.dram_efficiency * self.tp
            ) - int(fixed_bytes)
            if byte_budget < 0:
                raise ValueError(
                    f"SLO {slo.target_tps} tok/s @ batch {slo.batch} is unreachable: "
                    f"streaming the {fixed_bytes} unquantized bytes alone exceeds the "
                    f"{t:.2e}s iteration budget"
                )
        return Budgets(
            seconds=t,
            cycle_budget=cycle_budget,
            byte_budget=byte_budget,
            fixed_bytes=int(fixed_bytes),
        )

    def evaluate(self, params, policy, batch=None) -> PlanCost:
        """Price a resolved policy on a concrete parameter tree.

        ``batch`` overrides the model's batch for the WHOLE evaluation —
        lookup cycles scale with it, not just the tokens-per-iteration
        numerator — so pricing at an SLO's batch is one consistent
        re-evaluation, never a mixed-batch ratio."""
        if batch is not None and batch != self.batch:
            return dataclasses.replace(self, batch=int(batch)).evaluate(params, policy)
        units = policy_units(params, policy)
        cycles = self.cycles(units)
        qbytes = self.qbytes(units, policy.group_size)
        fixed = unquantized_bytes(params, policy) if self.include_dram else 0
        total = qbytes + fixed
        tc, td, tw = self.t_compute(cycles), self.t_dram(total), self.t_wire()
        secs = max(tc, td, tw)
        b = self.batch if batch is None else batch
        return PlanCost(
            cycles=cycles,
            quant_bytes=qbytes,
            fixed_bytes=fixed,
            t_compute=tc,
            t_dram=td,
            t_wire=tw,
            seconds_per_iteration=secs,
            tokens_per_second=b / max(secs, 1e-30),
        )


def policy_units(params, policy) -> List[Tuple[int, int, int, Optional[int], int, Optional[int]]]:
    """Cost-model units of every leaf ``policy`` quantizes:
    (k, n, wbits, abits, copies, layer) — per-layer entries for scan
    stacks whose assignment varies by layer, one aggregated entry
    otherwise.  This is the single source the engine, planner, and
    benchmarks price plans with."""
    def at(spec, i):
        if spec is None or not isinstance(spec, (tuple, list)):
            return spec
        return spec[i]

    units: List[Tuple[int, int, int, Optional[int], int, Optional[int]]] = []
    for pstr, w, stacked in quantizable_units(params, policy):
        k, n = int(w.shape[-2]), int(w.shape[-1])
        spec = policy.bits_for(pstr)
        aspec = policy.abits_for(pstr)
        if stacked:
            per_slice = 1
            for d in w.shape[1:-2]:
                per_slice *= int(d)
            layers = int(w.shape[0])
            layered = isinstance(spec, (tuple, list)) or isinstance(aspec, (tuple, list))
            if layered:
                for i in range(layers):
                    units.append((k, n, int(at(spec, i)), _opt(at(aspec, i)), per_slice, i))
            else:
                units.append((k, n, int(spec), _opt(aspec), per_slice * layers, None))
        else:
            units.append((k, n, int(spec), _opt(aspec), 1, None))
    return units


def _opt(ab):
    return None if ab is None else int(ab)


def unquantized_bytes(params, policy) -> int:
    """DRAM bytes of the leaves ``policy`` leaves in f32 (embeddings,
    norms, small tensors).  They stream every decode iteration no matter
    what the plan allocates, so the DRAM-aware objective charges them as
    a fixed term."""
    from repro_torch.models.sail_linear import flatten_with_paths

    quantized = {p for p, _, _ in quantizable_units(params, policy)}
    total = 0
    for pstr, leaf in flatten_with_paths(params):
        if pstr not in quantized:
            total += int(leaf.numel()) * leaf.element_size()
    return total


def quantizable_units(params, policy) -> List[Tuple[str, Any, bool]]:
    """(path, leaf, stacked?) for every leaf ``policy`` would quantize
    (the reference keeps it in ``core/sensitivity.py``)."""
    from repro_torch.models.sail_linear import (_should_quantize,
                                                _should_quantize_stacked,
                                                flatten_with_paths)
    out = []
    for pstr, w in flatten_with_paths(params):
        if _should_quantize(pstr, w, policy):
            out.append((pstr, w, False))
        elif _should_quantize_stacked(pstr, w, policy):
            out.append((pstr, w, True))
    return out


# ---------------------------------------------------------------------------
# Self-speculative pricing (PlanSpec.draft: a bit-gap buys tokens/round)
# ---------------------------------------------------------------------------


def expected_tokens_per_round(acceptance: float, k: int) -> float:
    """Expected committed tokens of one draft-k/verify round.

    Greedy speculative sampling commits the longest draft prefix the
    verifier agrees with, plus the verifier's own next token: with
    per-position acceptance ``a``, that is ``sum_{i=0..k} a^i`` =
    ``(1 - a^(k+1)) / (1 - a)`` — between 1 (every draft rejected, the
    round still commits the verifier's correction) and ``k + 1``
    (all-accept plus the bonus token)."""
    a = min(max(float(acceptance), 0.0), 1.0)
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def speculative_round_seconds(
    cost: "DecodeCostModel",
    verify_units,
    draft_units,
    group_size: int,
    fixed_bytes: int,
    k: int,
) -> float:
    """Modeled seconds of one speculative round at ``cost.batch`` lanes.

    The draft phase runs ``k`` single-token iterations under the draft
    tree (its own, smaller, weight stream); the verify phase is ONE
    iteration whose lookups carry ``batch * (k + 1)`` rows but whose
    weight stream is the same conservative bytes a plain iteration
    streams — the amortization speculative decoding banks on: DRAM
    traffic per round is ``k * draft_bytes + verify_bytes`` for up to
    ``k + 1`` committed tokens per lane."""
    d_cycles = cost.cycles(draft_units)
    d_bytes = cost.qbytes(draft_units, group_size) + fixed_bytes
    t_draft = cost.iteration_seconds(d_cycles, d_bytes)
    verify = dataclasses.replace(cost, batch=cost.batch * (k + 1))
    v_cycles = verify.cycles(verify_units)
    v_bytes = cost.qbytes(verify_units, group_size) + fixed_bytes
    t_verify = verify.iteration_seconds(v_cycles, v_bytes)
    return k * t_draft + t_verify


# ---------------------------------------------------------------------------
# KV-cache pricing (the third PlanSpec dimension: kv_bits buys concurrency)
# ---------------------------------------------------------------------------


def kv_token_bytes(n_layers: int, n_kv: int, head_dim: int, kv_bits: int = 32) -> int:
    """Bytes one cached token costs across all layers (K and V).

    ``kv_bits=8`` prices the served int8 layout: one int8 code per element
    plus one f32 absmax scale per (token, kv-head) for each of K and V —
    the exact arrays ``lm.init_paged_cache(quant_kv=True)`` allocates.
    """
    if kv_bits == 8:
        per_side = n_kv * head_dim + n_kv * 4  # int8 codes + f32 scales
    elif kv_bits == 32:
        per_side = n_kv * head_dim * 4
    else:
        raise ValueError(f"kv_bits must be 8 or 32, got {kv_bits}")
    return 2 * n_layers * per_side


def kv_block_bytes(
    block_size: int, n_layers: int, n_kv: int, head_dim: int, kv_bits: int = 32
) -> int:
    """Bytes of one paged KV block (``block_size`` tokens)."""
    return block_size * kv_token_bytes(n_layers, n_kv, head_dim, kv_bits)


def kv_pool_blocks(
    budget_bytes: int,
    block_size: int,
    n_layers: int,
    n_kv: int,
    head_dim: int,
    kv_bits: int = 32,
) -> int:
    """Paged blocks a KV byte budget buys — quantized KV literally buys
    concurrency: at ``kv_bits=8`` the same budget holds ~4x the tokens
    (minus the scale overhead), so admission sustains more users."""
    blk = kv_block_bytes(block_size, n_layers, n_kv, head_dim, kv_bits)
    return max(1, int(budget_bytes) // blk)


# ---------------------------------------------------------------------------
# Fitted machine constants carried by a plan (PlanSpec.calibration)
# ---------------------------------------------------------------------------

# Machine fields a calibration is allowed to override (the reference's
# ``planning.calibrate_cost.FITTED_FIELDS``).  Everything else (frequency,
# array geometry, ...) stays structural.
FITTED_FIELDS = (
    "lookup_base_cycles",
    "lookup_per_bit_cycles",
    "rebuild_ctrl_cycles",
    "build_overhead",
    "dram_bw",
    "dram_efficiency",
)


def machine_from_json(calibration: Mapping[str, Any],
                      base: Optional[cm.SailMachine] = None) -> cm.SailMachine:
    """``PlanSpec.calibration`` provenance -> fitted SailMachine."""
    base = base if base is not None else cm.SailMachine()
    overrides = {
        k: float(v)
        for k, v in calibration.get("machine_overrides", {}).items()
        if k in FITTED_FIELDS
    }
    return dataclasses.replace(base, **overrides)


def dispatch_from_json(
    calibration: Mapping[str, Any],
) -> Optional[Tuple[Tuple[Tuple[int, int], float], ...]]:
    """``PlanSpec.calibration`` provenance -> the hashable per-(NBW,
    abits) dispatch table ``DecodeCostModel.dispatch_cycles`` takes (None
    when the calibration carries no dispatch fit)."""
    disp = calibration.get("dispatch_cycles")
    if not disp:
        return None
    return tuple(sorted(parse_dispatch(disp).items()))


def parse_dispatch(disp: Mapping[Any, Any]) -> Dict[Tuple[int, int], float]:
    """JSON ``"nbw:abits" -> cycles`` mapping (or in-memory tuple keys)
    back to the ``{(nbw, abits): cycles}`` form."""
    out: Dict[Tuple[int, int], float] = {}
    for key, v in disp.items():
        nbw, ab = key.split(":") if isinstance(key, str) else key
        out[(int(nbw), int(ab))] = float(v)
    return out
