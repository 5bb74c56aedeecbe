"""Analytic SAIL machine model (paper Secs. III-C, IV, V; port of
``repro.core.cost_model``, copied: the paper's machine and constants).

This models the paper's SAIL machine (CPU cores plus C-SRAM arrays at
3 GHz over 204.8 GB/s DDR4), not the H100 the port runs on: its
cycles and tokens/s are the modeled machine's figures, never the card's.

The paper evaluates SAIL with gem5 plus an NDP model whose cycle counts for
LUT-GEMV / batched inference / in-memory type conversion are "characterized
... and hardcoded into the NDP model" (Sec. V-A).  This module is that
characterization, reconstructed from the published microarchitecture:

  * C-SRAM array: 256 x 512 bits @ 3 GHz; n-bit add = n+1 cycles,
    n-bit multiply = n^2 + 5n - 2 cycles (Sec. IV-B(d));
  * type conversion: 3n^2/2 + 39(n-1) cycles (Sec. III-E);
  * 2 C-SRAM arrays per thread (32 KB / thread, Sec. V-I), up to 16 threads
    = 32 arrays (matching the 32 NDPs of Sec. V-A);
  * 8-channel DDR4-3200 DRAM = 204.8 GB/s; 32 MB / 32-slice LLC; NoC
    32 B/cycle @ 2 GHz (Table I);
  * ping-pong LLC halves overlap DRAM->LLC transfer with C-SRAM compute
    (Sec. III-A), so a decode iteration costs max(t_dram, t_compute) plus
    the un-overlapped de-/quant tail;
  * the PRT discount (Sec. III-D) scales lookup cycles by the measured
    pattern hit rate (13.8% at the paper's 17% repeat rate).

Three efficiency constants that gem5 would capture microarchitecturally
(DFM streaming efficiency, LUT-rebuild dataflow overhead, CPU-side GEMV
efficiency of the baselines) are calibrated against the paper's published
anchors (Fig. 6 cycle counts, Table II throughput).  Everything else is
first-principles.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

from repro_torch.core import typeconv
from repro_torch.core.pattern import PAPER_CYCLE_REDUCTION


# ---------------------------------------------------------------------------
# Machine description
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SailMachine:
    freq_hz: float = 3.0e9                 # C-SRAM runs at system clock
    arrays_per_thread: int = 2             # 2 x (256x512) per thread
    array_rows: int = 256
    array_cols: int = 512                  # bitline lanes (N-parallelism)
    dram_bw: float = 204.8e9               # 8ch DDR4-3200
    llc_bytes: int = 32 * 2**20
    llc_slices: int = 32
    noc_bytes_per_cycle: float = 32.0
    noc_freq_hz: float = 2.0e9
    # calibrated dataflow constants (fit by the reference's core/calibrate.py
    # against the paper's Fig. 6 anchors + Table II SAIL columns):
    lookup_base_cycles: float = 30.7125    # DFM broadcast+row select+SA read
    lookup_per_bit_cycles: float = 5.94    # accumulate slope per weight bit
    rebuild_ctrl_cycles: float = 9900.0    # per-group residency swap / ctrl
    rebuild_nbw_exp: float = 4.4           # dataflow penalty ~ (2/nbw)^exp
    build_overhead: float = 1.0            # fitted multiplier on adds+load
    thread_scale_tau: float = 0.0          # SAIL multi-thread contention
    dram_efficiency: float = 0.92          # achieved fraction of peak BW

    def add_cycles(self, n: int) -> int:
        return n + 1

    def mult_cycles(self, n: int) -> int:
        return n * n + 5 * n - 2


@dataclasses.dataclass(frozen=True)
class CpuMachine:
    """ARM Neoverse-N1-like baseline (Table I)."""
    freq_hz: float = 3.0e9
    simd_bits: int = 128                   # NEON
    fma_per_cycle: int = 2                 # 2 FP/SIMD pipes
    dram_bw: float = 204.8e9
    # calibrated:
    dequant_ops_per_weight: float = 4.0    # unpack+sub+mul+fma at sub-8-bit
    mem_efficiency: float = 0.55           # achieved stream BW fraction
    thread_scale_tau: float = 0.045        # contention: eff = 1/(1+tau*(T-1))


# bits-per-weight including group scale overhead (llama.cpp-style Q*_0/K
# formats: b bits + fp16 scale per 32-group; Q3/Q5/Q6 carry extra metadata)
BPW: Dict[int, float] = {2: 2.63, 3: 3.44, 4: 4.50, 5: 5.50, 6: 6.56, 8: 8.50}


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    params: float                          # weight count
    d_model: int
    n_layers: int
    ffn_dim: int

    @property
    def gemv_macs_per_token(self) -> float:
        # dense decode: ~2 * params MAC -> params multiply-accumulates
        return self.params


LLAMA2_7B = ModelSpec("llama-2-7b", 6.74e9, 4096, 32, 11008)
LLAMA2_13B = ModelSpec("llama-2-13b", 13.0e9, 5120, 40, 13824)
TINYMISTRAL = ModelSpec("tinymistral-248m", 2.48e8, 1024, 12, 4096)


# ---------------------------------------------------------------------------
# LUT-GEMV cycle model (Fig. 6 reproduction)
# ---------------------------------------------------------------------------

def lut_build_cycles(m: SailMachine, nbw: int, wbits: int) -> float:
    """Cycles to build one group's LUT inside a C-SRAM array.

    2^nbw - nbw - 1 incremental subset-sum adds of (wbits + ceil(log2 nbw))
    wide entries, plus loading/transposing the nbw weight rows, plus the
    calibrated per-group residency/control overhead which the paper's Fig. 6
    attributes to "LUT rebuild" (dominant at small NBW).
    """
    entry_bits = wbits + max(1, math.ceil(math.log2(max(nbw, 2))))
    n_adds = max((1 << nbw) - nbw - 1, 0)
    adds = n_adds * m.add_cycles(entry_bits)
    load = nbw * 2.0  # stream nbw rows through the transposer (512b/row)
    ctrl = m.rebuild_ctrl_cycles * (2.0 / nbw) ** m.rebuild_nbw_exp
    return (adds + load) * m.build_overhead + ctrl


def lookup_cycles(m: SailMachine, wbits: int, kernel_level: bool = False) -> float:
    """One DFM pattern broadcast + LUT row read + shift-add accumulate.

    ``kernel_level=True`` prices the raw in-array operation (SA read + 16-bit
    accumulate), used for kernel-scope comparisons (Fig. 1 / Fig. 12).  The
    default system-level constants are calibrated against Table II / Fig. 6
    and additionally absorb DFM/NoC orchestration, the way the paper's gem5
    NDP characterization does.
    """
    if kernel_level:
        return 2.0 + 17.0 + 0.5 * wbits   # read + adder tree + shift slope
    return m.lookup_base_cycles + m.lookup_per_bit_cycles * wbits


def lut_gemv_cycles(m: SailMachine, batch: int, k: int, n: int, nbw: int,
                    wbits: int, abits: int = 8, threads: int = 1,
                    prt_discount: float = 1.0,
                    kernel_level: bool = False) -> float:
    """Total C-SRAM cycles of a batched [B,K]x[K,N] LUT-GEMV on `threads`
    threads (2 arrays each, 512 N-lanes per array).

    Per N-tile of 512 columns, per K-group of nbw rows: build the LUT once,
    then stream B*abits pattern lookups through it (reused across the whole
    batch and all bit-planes — the paper's central data-reuse claim).
    """
    arrays = threads * m.arrays_per_thread
    eff = 1.0 / (1.0 + m.thread_scale_tau * (threads - 1))
    n_tiles = math.ceil(n / m.array_cols)
    groups = k / nbw
    per_group = (lut_build_cycles(m, nbw, wbits)
                 + batch * abits * lookup_cycles(m, wbits, kernel_level)
                 * prt_discount)
    total_tile_cycles = n_tiles * groups * per_group
    return total_tile_cycles / (arrays * eff)


def lut_build_fraction(m: SailMachine, batch: int, nbw: int, wbits: int,
                       abits: int = 8, kernel_level: bool = False) -> float:
    """Fraction of GEMV cycles spent constructing LUTs (paper: 3%..12%).

    ``kernel_level`` selects the same lookup pricing ``lut_gemv_cycles``
    uses, so the fraction is consistent with the cycle total it describes
    (kernel-level lookups are cheaper, so the build fraction is larger).
    """
    b = lut_build_cycles(m, nbw, wbits)
    l = batch * abits * lookup_cycles(m, wbits, kernel_level)
    return b / (b + l)


def bitserial_gemv_cycles(m: SailMachine, batch: int, k: int, n: int,
                          wbits: int, abits: int = 8,
                          threads: int = 1) -> float:
    """Neural-Cache-style bit-serial GEMV (no LUTs): every MAC is an
    in-SRAM bit-serial multiply + accumulate (Sec. V-A 'Neural Cache')."""
    arrays = threads * m.arrays_per_thread
    n_tiles = math.ceil(n / m.array_cols)
    per_mac = m.mult_cycles(max(wbits, abits)) + m.add_cycles(24)
    return n_tiles * k * batch * per_mac / arrays


# ---------------------------------------------------------------------------
# End-to-end decode throughput (Table II / III reproduction)
# ---------------------------------------------------------------------------

def model_weight_bytes(model: ModelSpec, ql: int) -> float:
    return model.params * BPW[ql] / 8.0


def qtensor_bytes(k: int, n: int, bits: int, group_size: int = 128,
                  copies: int = 1) -> int:
    """Exact bytes of one SAIL-quantized [K, N] weight in the repo's
    QTensor storage: bit-contiguous packed uint32 words + f32 group scales
    (``copies`` folds stacked layers / MoE experts).  This is the byte
    accounting the mixed-precision allocator budgets against — strictly
    monotone in ``bits`` for every group size >= 32 (matches
    ``quant.words_per_group``)."""
    wpg = -(-(bits * group_size) // 32)          # ceil: words per group
    groups = k // group_size
    return copies * (groups * wpg * n * 4 + groups * n * 4)


def resolve_prt_discount(prt, nbw: int, wbits: int, abits: int,
                         calib=None,
                         machine: SailMachine = SailMachine()) -> float:
    """Resolve the ``prt=`` switch into a lookup-cycle discount factor.

      False/None   no PRT (factor 1.0)
      True/"paper" the paper's flat 13.8% reduction
      "measured"   per-precision discount from simulated PRT hit rates on
                   ``calib`` activations (``repro_torch.core.pattern.prt_discount``
                   — synthetic batch when ``calib`` is None)
    """
    if prt in (False, None, "off"):
        return 1.0
    if prt is True or prt == "paper":
        return 1.0 - PAPER_CYCLE_REDUCTION
    if prt == "measured":
        from repro_torch.core import pattern
        return pattern.prt_discount(nbw, abits, wbits, calib,
                                    machine=machine)
    raise ValueError(f"prt must be bool, 'paper' or 'measured', got {prt!r}")


def _best_nbw_and_cycles(k: int, n: int, wbits: int, abits: int,
                         batch: int, threads: int, machine: SailMachine,
                         prt, calib) -> tuple:
    best, best_c = 2, float("inf")
    for nbw in (1, 2, 3, 4):
        disc = resolve_prt_discount(prt, nbw, wbits, abits, calib, machine)
        c = lut_gemv_cycles(machine, batch, k, n, nbw, wbits, abits,
                            threads, disc)
        if c < best_c:
            best, best_c = nbw, c
    return best, best_c


def best_nbw_for_unit(k: int, n: int, wbits: int, abits: int = 8,
                      batch: int = 8, threads: int = 16,
                      machine: SailMachine = SailMachine(),
                      prt=True, calib=None) -> int:
    """Cycle-optimal NBW for ONE [K, N] matrix at its allocated precision.

    A mixed allocation should not inherit the model-global ``best_nbw``:
    the build/lookup trade-off shifts with both the matrix shape (K sets
    the group count the build cost amortizes over) and the (wbits, abits)
    pair — and under ``prt="measured"`` the hit rate itself depends on
    NBW.  Small per-call cost, exhaustive over the 4 NBW values.
    """
    return _best_nbw_and_cycles(k, n, wbits, abits, batch, threads,
                                machine, prt, calib)[0]


def mixed_decode_cycles(units, machine: SailMachine = SailMachine(),
                        batch: int = 8, nbw=4, abits: int = 8,
                        threads: int = 16, prt=True, calib=None) -> float:
    """Projected C-SRAM cycles of one decode iteration under a mixed
    per-matrix bit allocation: each matrix runs LUT-GEMV at its own
    ``(ql, abits)`` (the lutmm instruction's per-call precision fields —
    uniformity is a policy choice, never a hardware requirement).

    ``units``: iterable of (k, n, wbits), (k, n, wbits, copies), or
    (k, n, wbits, abits, copies) — a None abits (f32-activation serving)
    is priced at the global ``abits`` default.
    ``nbw``: a fixed NBW, or "auto" to pick :func:`best_nbw_for_unit`
    per matrix.
    ``prt``: see :func:`resolve_prt_discount`; "measured" replaces the
    flat 13.8% constant with per-(nbw, abits, ql) simulated hit rates on
    ``calib`` activations.
    """
    if prt == "measured":
        from repro_torch.core import pattern
        # per-layer calib mappings collapse to their global fallback here:
        # these units carry no layer identity (the planning facade prices
        # per-layer; see repro_torch.planning.cost.DecodeCostModel)
        calib = pattern.calib_for_layer(pattern.canonical_calib(calib), None)
    total = 0.0
    for u in units:
        k, n, wbits = u[0], u[1], u[2]
        if len(u) >= 5:
            ab = u[3] if u[3] is not None else abits
            copies = u[4]
        else:
            ab = abits
            copies = u[3] if len(u) > 3 else 1
        if nbw == "auto":
            _, unit_cycles = _best_nbw_and_cycles(
                k, n, wbits, ab, batch, threads, machine, prt, calib)
        else:
            disc = resolve_prt_discount(prt, nbw, wbits, ab, calib,
                                        machine)
            unit_cycles = lut_gemv_cycles(machine, batch, k, n, nbw,
                                          wbits, ab, threads, disc)
        total += copies * unit_cycles
    return total


def sail_tokens_per_second(model: ModelSpec, ql: int, threads: int = 16,
                           batch: int = 1, nbw: Optional[int] = None,
                           abits: int = 8, machine: SailMachine = SailMachine(),
                           prt=True, inmem_typeconv: bool = True,
                           use_lut: bool = True, calib=None) -> float:
    """Aggregate decode throughput (tokens/s summed over the batch).

    Tensor-level scheduling loads each layer's weights once per iteration
    and serves the whole batch against them (Sec. III-A), so the DRAM
    stream cost is paid once per iteration while compute scales with B.
    The ping-pong pipeline overlaps the two: t_iter = max(t_dram, t_comp)
    + un-overlapped de-/quant tail.

    ``prt``: True/"paper" applies the published flat 13.8% reduction;
    "measured" simulates the PRT hit rate at this (nbw, abits, ql) on
    ``calib`` activations (see :func:`resolve_prt_discount`).
    """
    m = machine
    if nbw is None:
        nbw = best_nbw(model, ql, threads, batch, abits, m, prt, calib)
    prt_discount = resolve_prt_discount(prt, nbw, ql, abits, calib, m)

    t_dram = model_weight_bytes(model, ql) / (m.dram_bw * m.dram_efficiency)

    # GEMV compute across all layers ~ params MACs; expressed as one big
    # [B, K] x [K, N] with K*N = params and K ~ d_model
    k = model.d_model
    n_total = model.params / k
    if use_lut:
        cycles = lut_gemv_cycles(m, batch, k, n_total, nbw, ql, abits,
                                 threads, prt_discount)
    else:
        cycles = bitserial_gemv_cycles(m, batch, k, n_total, ql, abits,
                                       threads)
    t_comp = cycles / m.freq_hz

    # de-/quantization of activations & outputs: one f32<->int pass per
    # activation element per layer boundary
    act_elems = batch * (model.d_model * 4 + model.ffn_dim) * model.n_layers
    if inmem_typeconv:
        arrays = threads * m.arrays_per_thread
        tc_cycles = act_elems * typeconv.sram_cycles(abits + 9) / (
            arrays * m.array_cols)
        # in-memory conversion also pipelines behind the GEMV
        t_tc_exposed = 0.25 * tc_cycles / m.freq_hz
    else:
        # CPU vector engine: ~8 ops/elem on 128-bit NEON lanes
        cpu = CpuMachine()
        lanes = cpu.simd_bits // 32
        t_tc_exposed = act_elems * 8.0 / (lanes * cpu.fma_per_cycle *
                                          cpu.freq_hz * threads)

    t_iter = max(t_dram, t_comp) + t_tc_exposed
    return batch / t_iter


def best_nbw(model: ModelSpec, ql: int, threads: int, batch: int,
             abits: int = 8, machine: SailMachine = SailMachine(),
             prt=True, calib=None) -> int:
    """SAIL jointly optimizes (NBW, bit-width, batch) (Sec. III-C).

    ``prt``/``calib`` select the pricing mode the candidates are ranked
    under — a measured-mode caller must not have its NBW picked by the
    flat paper discount (the hit rate itself depends on NBW)."""
    best, best_t = 2, -1.0
    for nbw in (1, 2, 3, 4):
        t = sail_tokens_per_second(model, ql, threads, batch, nbw, abits,
                                   machine, prt=prt, calib=calib)
        if t > best_t:
            best, best_t = nbw, t
    return best


# Per-ql effective MAC rates (MAC/s per thread), anchored on the paper's own
# measured llama.cpp 7B single-thread baselines (Table II ARM/AMX 1T columns
# x 6.74e9 params): this is the "calibrated against real inference latency"
# step the paper performs for its gem5 CPU model (Sec. V-A).  The per-ql
# variation IS the sub-8-bit NEON/AMX dequant inefficiency SAIL targets.
ARM_MAC_RATE = {2: 0.68 * 6.74e9, 3: 0.70 * 6.74e9, 4: 0.70 * 6.74e9,
                5: 0.60 * 6.74e9, 6: 0.79 * 6.74e9, 8: 0.66 * 6.74e9}
AMX_MAC_RATE = {2: 2.06 * 6.74e9, 3: 2.02 * 6.74e9, 4: 3.45 * 6.74e9,
                5: 1.30 * 6.74e9, 6: 1.20 * 6.74e9, 8: 2.30 * 6.74e9}
ARM_EFF_BW = 40.0e9     # saturated stream BW implied by 7B-Q8 16T (Table II)
AMX_EFF_BW = 132.0e9    # implied by AMX 7B-Q8 16T
ARM_TAU = 0.0113        # 16T = 85.5% of linear (7B-Q2 column)
AMX_TAU = 0.0214


def arm_tokens_per_second(model: ModelSpec, ql: int, threads: int = 16,
                          batch: int = 1) -> float:
    """ARM Neoverse-N1 + llama.cpp decode model.

    Compute rate per thread is anchored on the paper's measured 1-thread
    baselines (per-ql, capturing NEON sub-byte dequant inefficiency).
    Batching does NOT amortize the weight stream on the CPU baseline:
    "CPU-based platforms show minimal benefit from batching due to memory
    bandwidth saturation" (paper Sec. V-D) — throughput is capped at the
    per-token stream bound regardless of batch.
    """
    eff = 1.0 / (1.0 + ARM_TAU * (threads - 1))
    t_comp = batch * model.gemv_macs_per_token / (
        ARM_MAC_RATE[ql] * threads * eff)
    mem_cap = ARM_EFF_BW / model_weight_bytes(model, ql)  # tokens/s
    return min(batch / t_comp, mem_cap)


def amx_tokens_per_second(model: ModelSpec, ql: int, threads: int = 16,
                          batch: int = 1) -> float:
    """Intel AMX (Emerald Rapids) llama.cpp decode model, anchored the same
    way.  AMX's native int8 tiles show up as the higher Q4/Q8 rates; sub-4-bit
    still pays vector-side dequant (Sec. V-E).  Same batch-saturation
    behaviour as ARM (Sec. V-D)."""
    eff = 1.0 / (1.0 + AMX_TAU * (threads - 1))
    t_comp = batch * model.gemv_macs_per_token / (
        AMX_MAC_RATE[ql] * threads * eff)
    mem_cap = AMX_EFF_BW / model_weight_bytes(model, ql)
    return min(batch / t_comp, mem_cap)


# ---------------------------------------------------------------------------
# Breakdown (Fig. 12) and TPD (Fig. 13 / Table IV)
# ---------------------------------------------------------------------------

# CPU-side exposure when PIM GEMV results round-trip through the cache for
# vector-unit type conversion (the "up to 90% waiting on data movement"
# problem of in-cache PIM [9] that Algorithm 1 removes), per element.
CPU_TC_NS_PER_ELEM = 3.0
# Fig. 12's Baseline is "a real ARM machine" (not the gem5 Neoverse-N1);
# its per-thread GEMV rate is calibrated so full SAIL lands at the
# published 3.81x end-to-end kernel speedup.
FIG12_BASELINE_MAC_RATE = 18.35e9


def gemv_breakdown(k: int = 4096, n: int = 4096, batch: int = 8,
                   ql: int = 4, nbw: int = 4, threads: int = 16,
                   machine: SailMachine = SailMachine()) -> Dict[str, float]:
    """Latency of one Q4 GEMV kernel under the four configurations of
    Fig. 12: Baseline (real ARM CPU), NC (bit-serial in-SRAM), LUT (SAIL
    without in-memory type conversion), LUT+TC (full SAIL).  Returns
    seconds; kernel-level cycle accounting (see ``lookup_cycles``)."""
    m = machine
    macs = batch * k * n
    eff = 1.0 / (1.0 + ARM_TAU * (threads - 1))
    t_base = max(macs / (FIG12_BASELINE_MAC_RATE * threads * eff),
                 k * n * BPW[ql] / 8.0 / ARM_EFF_BW)

    # de-/quant conversions the CPU performs on PIM outputs: one partial
    # sum per (out elem, K-group) plus activation quantization
    conv_elems = batch * n * (k // 256) + batch * k
    t_cpu_tc = conv_elems * CPU_TC_NS_PER_ELEM * 1e-9 / threads
    arrays = threads * m.arrays_per_thread
    t_sram_tc = (conv_elems * typeconv.sram_cycles(17)
                 / (arrays * m.array_cols) / m.freq_hz)

    t_nc = bitserial_gemv_cycles(m, batch, k, n, ql, 8, threads) / m.freq_hz
    t_lut = lut_gemv_cycles(m, batch, k, n, nbw, ql, 8, threads,
                            1.0 - PAPER_CYCLE_REDUCTION,
                            kernel_level=True) / m.freq_hz
    return {
        "baseline": t_base,                    # native f32: no conversions
        "neural_cache": t_nc + t_cpu_tc,
        "lut": t_lut + t_cpu_tc,
        # Algorithm 1 runs in-array and pipelines behind the GEMV; a quarter
        # of its cycles remain exposed at the pipeline tail
        "lut_tc": t_lut + 0.25 * t_sram_tc,
    }


def fig1_efficiency_gain(ql: int, batch: int, nbw: int = None,
                         machine: SailMachine = SailMachine()) -> float:
    """Fig. 1: LUT-based vs bit-serial computing efficiency gain for one
    lutmm_1k-shaped workload at a given quantization level and batch."""
    m = machine
    if nbw is None:
        nbw = min((lut_gemv_cycles(m, batch, 1024, 1024, g, ql,
                                   kernel_level=True), g)
                  for g in (1, 2, 3, 4))[1]
    lut = lut_gemv_cycles(m, batch, 1024, 1024, nbw, ql, kernel_level=True)
    bs = bitserial_gemv_cycles(m, batch, 1024, 1024, ql)
    return bs / lut


# GCP monthly prices, Table IV
MONTHLY_PRICE = {
    "cpu_5c": 292.31,
    "cpu_16c": 665.45,
    "v100_1x": 1861.5,
    "v100_4x": 7446.0,
    "sail_16c": 665.45,   # SAIL = 16-core CPU node + ~2% silicon
}


def tokens_per_dollar(tokens_per_s: float, system: str) -> float:
    """TPD = tokens/s * 30 days / monthly price (Sec. V-H)."""
    return tokens_per_s * 30 * 24 * 3600 / MONTHLY_PRICE[system]


# ---------------------------------------------------------------------------
# Paper-published reference data (for validation benchmarks/tests)
# ---------------------------------------------------------------------------

# Table II: tokens/s, [1, 2, 4, 8, 16] threads
PAPER_TABLE_II = {
    ("7b", 2):  {"arm": [0.68, 1.34, 2.63, 4.97, 9.30],
                 "amx": [2.06, 4.02, 7.65, 14.25, 24.96],
                 "sail": [6.42, 12.62, 24.00, 43.50, 81.63]},
    ("7b", 3):  {"arm": [0.70, 1.38, 2.71, 5.11, 9.62],
                 "amx": [2.02, 3.93, 7.47, 13.69, 24.50],
                 "sail": [5.53, 10.93, 20.87, 38.40, 73.75]},
    ("7b", 4):  {"arm": [0.70, 1.37, 2.67, 5.15, 9.85],
                 "amx": [3.45, 6.72, 11.51, 21.13, 33.55],
                 "sail": [4.82, 9.61, 18.67, 35.17, 72.10]},
    ("7b", 5):  {"arm": [0.60, 1.17, 2.32, 4.48, 8.49],
                 "amx": [1.30, 2.56, 4.84, 9.17, 16.48],
                 "sail": [3.98, 7.96, 15.52, 29.62, 61.84]},
    ("7b", 6):  {"arm": [0.79, 1.20, 2.36, 4.52, 8.31],
                 "amx": [1.20, 2.33, 4.47, 8.10, 14.62],
                 "sail": [3.34, 6.67, 12.97, 24.60, 50.63]},
    ("7b", 8):  {"arm": [0.66, 1.28, 2.51, 4.69, 5.54],
                 "amx": [2.30, 4.51, 7.50, 13.55, 18.39],
                 "sail": [2.60, 5.22, 10.28, 19.86, 43.27]},
    ("13b", 2): {"arm": [0.35, 0.70, 1.38, 2.68, 5.05],
                 "amx": [1.06, 2.06, 3.91, 7.28, 12.75],
                 "sail": [3.77, 7.44, 14.34, 26.63, 52.55]},
    ("13b", 3): {"arm": [0.35, 0.69, 1.36, 2.63, 5.01],
                 "amx": [1.02, 2.01, 3.82, 7.00, 12.62],
                 "sail": [3.67, 7.33, 13.84, 25.70, 51.10]},
    ("13b", 4): {"arm": [0.36, 0.72, 1.41, 2.75, 5.27],
                 "amx": [1.82, 3.53, 5.79, 10.95, 17.42],
                 "sail": [2.81, 5.62, 11.00, 21.06, 45.07]},
    ("13b", 5): {"arm": [0.31, 0.61, 1.20, 2.34, 4.44],
                 "amx": [0.67, 1.32, 2.52, 4.78, 8.56],
                 "sail": [2.32, 4.64, 9.10, 17.60, 38.24]},
    ("13b", 6): {"arm": [0.32, 0.62, 1.23, 2.40, 4.52],
                 "amx": [0.62, 1.18, 2.17, 4.14, 7.25],
                 "sail": [1.94, 3.88, 7.60, 14.61, 31.32]},
    ("13b", 8): {"arm": [0.34, 0.68, 1.29, 2.46, 4.80],
                 "amx": [1.15, 2.20, 3.89, 7.19, 10.07],
                 "sail": [1.51, 3.03, 5.98, 10.75, 26.25]},
}

# Table III: GPU token generation (tokens/s, best batch), paper-measured
PAPER_TABLE_III = {
    # (model, ql): {platform: {ctx: tok/s}}
    ("7b", 4): {"v100_1x": {512: 216.3, 1024: 173.4, 2048: 123.6, 4096: 78.98},
                "v100_2x": {512: 229.3, 1024: 179.6, 2048: 129.7, 4096: 88.02},
                "a100":    {512: 670.7, 1024: 425.8, 2048: 255.8, 4096: 129.3},
                "sail":    {4096: 134.22}},
    ("7b", 8): {"v100_1x": {512: 190.5, 1024: 126.9, 2048: 84.98, 4096: 41.62},
                "v100_2x": {512: 196.3, 1024: 163.3, 2048: 112.6, 4096: 81.90},
                "a100":    {512: 652.4, 1024: 418.2, 2048: 252.7, 4096: 120.4},
                "sail":    {4096: 113.84}},
    ("13b", 4): {"v100_1x": {512: 173.9, 1024: 126.4, 2048: 85.47, 4096: 39.97},
                 "v100_2x": {512: 148.5, 1024: 114.7, 2048: 81.99, 4096: 51.15},
                 "a100":    {512: 442.4, 1024: 278.8, 2048: 117.9, 4096: 87.50},
                 "sail":    {4096: 73.93}},
}

# Fig. 6 quoted anchor points: (batch, nbw, wbits) -> cycles
PAPER_FIG6_ANCHORS = {
    (24, 4, 2): 3.00e6,
    (24, 4, 4): 4.87e6,
    (24, 2, 2): 11.45e6,
}

# Fig. 12: final LUT+TC speedup over ARM baseline
PAPER_FIG12_SPEEDUP = 3.81

# Sec. III-C: online LUT creation overhead range
PAPER_LUT_OVERHEAD = {(8, 2, 2): 0.03, (32, 4, 4): 0.12}


def fig6_workload_cycles(batch: int, nbw: int, wbits: int,
                         machine: SailMachine = SailMachine()) -> float:
    """The DSE workload of Fig. 6: one ``lutmm_1k`` tile —
    [B,1024]x[1024,1024] — on a single thread pair (2 arrays), abits=8.
    (The figure characterizes the new instruction, Sec. IV-A.)"""
    return lut_gemv_cycles(machine, batch, 1024, 1024, nbw, wbits,
                           abits=8, threads=1)


def geomean(xs):
    xs = list(xs)
    return math.exp(sum(math.log(max(x, 1e-12)) for x in xs) / len(xs))
