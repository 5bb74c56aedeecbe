"""Pattern-Aware LUT optimization (SAIL Sec. III-D; port of
``repro.core.pattern``, the same simulation on the port's
``activation_patterns`` and ``quantize_activations``).

Each Data Feeding Module (DFM) holds a 32-entry fully-associative Pattern
Reuse Table (PRT) storing a hash of the NBW-bit input pattern (plus its
group/bit-plane context) and the previous LUT result; a hit bypasses the
C-SRAM read.  The paper reports ~17% of input activation patterns repeating
within computation batches, yielding a 13.8% computation-cycle reduction.

A content-addressable skip has no GPU analogue either (the lanes of a warp
cannot divergently skip work), so the optimization lives in the cost model:
this module measures the *actual* pattern-repeat statistics of activation
tensors under the DFM's access order and converts PRT hit rates into the
cycle discount used by ``repro_torch.core.cost_model``.

Access-order assumption (the paper underspecifies): the DFM walks
bit-plane-major, then batch, then group — consecutive accesses for the same
group across the batch are adjacent, which is the order that makes the
"reuse within the batch" statement strongest.  Keys are (group, pattern):
a hit means the identical LUT entry was fetched recently and its value can
be served from the PRT.
"""
from __future__ import annotations

import dataclasses
import numpy as np

import torch

from repro_torch.core.lut_gemv import activation_patterns

PRT_ENTRIES = 32
PAPER_REPEAT_RATE = 0.17
PAPER_CYCLE_REDUCTION = 0.138

# FreePDK-45nm synthesis numbers from the paper (per PRT incl. adder tree)
PRT_AREA_MM2 = 0.0012
PRT_POWER_MW = 0.25


@dataclasses.dataclass
class PRTStats:
    accesses: int
    hits: int
    unique_patterns: int

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.accesses, 1)


def prt_simulate(patterns: np.ndarray, entries: int = PRT_ENTRIES) -> PRTStats:
    """Simulate one 32-entry fully-associative PRT with FIFO replacement.

    patterns: int array [B, abits, G] from ``activation_patterns`` — the
    stream order is (bit-plane, group, batch): for each bit-plane and group,
    the whole batch streams through, which is where cross-user pattern reuse
    (the paper's 17%) lives.
    """
    b, abits, g = patterns.shape
    # stream[(t, g), b] -> key (group, pattern)
    hits = 0
    accesses = 0
    uniq = set()
    table: list = []  # FIFO of keys
    lookup = set()
    for t in range(abits):
        for gi in range(g):
            for bi in range(b):
                key = (gi, int(patterns[bi, t, gi]))
                uniq.add(key)
                accesses += 1
                if key in lookup:
                    hits += 1
                else:
                    table.append(key)
                    lookup.add(key)
                    if len(table) > entries:
                        evicted = table.pop(0)
                        lookup.discard(evicted)
    return PRTStats(accesses=accesses, hits=hits, unique_patterns=len(uniq))


def measure_repeat_rate(x_q, nbw: int, abits: int = 8,
                        entries: int = PRT_ENTRIES) -> PRTStats:
    """Measure PRT hit statistics for a quantized activation batch.

    x_q: int32 [B, K] quantized activations.
    """
    pats = activation_patterns(_int_tensor(x_q), nbw, abits).numpy()
    return prt_simulate(pats, entries=entries)


def vectorized_repeat_rate(x_q, nbw: int, abits: int = 8) -> float:
    """Fast upper-bound repeat estimate (no capacity misses): the fraction
    of (bit-plane, group) accesses whose pattern already appeared for an
    earlier batch element.  This is the paper's "~17% of input activation
    patterns repeat within computation batches" statistic.
    """
    pats = activation_patterns(_int_tensor(x_q), nbw, abits).numpy()
    b = pats.shape[0]
    if b < 2:
        return 0.0
    repeats = 0
    total = 0
    # within each (T, G) column, count duplicates across the batch
    flat = pats.reshape(b, -1)
    for col in range(flat.shape[1]):
        vals = flat[:, col]
        _, counts = np.unique(vals, return_counts=True)
        repeats += int((counts - 1).sum())
        total += b
    return repeats / max(total, 1)


def cycle_discount(hit_rate: float,
                   paper_rate: float = PAPER_REPEAT_RATE,
                   paper_discount: float = PAPER_CYCLE_REDUCTION) -> float:
    """Convert a PRT hit rate into a compute-cycle discount factor.

    The paper maps a 17% repeat rate to a 13.8% cycle reduction (hits skip
    the C-SRAM read but still traverse the DFM adder tree).  We scale that
    published ratio linearly in the measured hit rate and return the
    multiplicative factor to apply to lookup cycles.
    """
    eff = paper_discount / paper_rate  # cycles saved per unit hit-rate
    return max(0.0, 1.0 - eff * hit_rate)


# ---------------------------------------------------------------------------
# Measured per-precision discount (replaces the flat 13.8% constant when the
# cost model runs with ``prt="measured"``)
# ---------------------------------------------------------------------------

# The weight precision the paper's single published (17%, 13.8%) anchor was
# measured at; the per-hit cycle saving is calibrated there and rescaled to
# other ``ql`` by the lookup-cost ratio (a hit skips a fixed amount of
# C-SRAM work, so cheaper lookups see a LARGER fractional discount).
PAPER_ANCHOR_QL = 4

# Synthetic default calibration activations are capped at this many
# features: PRT hit statistics saturate long before real hidden sizes
# (the 32-entry table thrashes across groups either way) and the stream
# simulation is a Python loop.
_SYNTH_K_CAP = 2048

_HIT_RATE_CACHE: dict = {}
_SYNTH_CACHE: dict = {}
_BATCH_KEY_CACHE: dict = {}


def synthetic_activations(k: int, batch: int = 8,
                          seed: int = 0) -> np.ndarray:
    """Deterministic f32 [batch, k] stand-in activation batch for PRT
    calibration when no held-out activations are provided (matches the
    synthetic data used throughout the repro).  Memoized: the cost model
    resolves a discount per (unit, nbw, abits) and must not regenerate
    the batch thousands of times per calibration."""
    key = (int(k), int(batch), int(seed))
    got = _SYNTH_CACHE.get(key)
    if got is None:
        rng = np.random.default_rng((seed, k, batch))
        got = rng.standard_normal((batch, k)).astype(np.float32)
        got.setflags(write=False)
        _SYNTH_CACHE[key] = got
    return got


def canonical_calib(calib) -> "np.ndarray | dict | None":
    """Normalize a calibration batch to ONE f32 ndarray object.

    Callers that loop over precisions (the joint allocator's cost
    tables, ``mixed_decode_cycles(nbw="auto")``) should canonicalize
    once at their boundary: passing a tensor or non-f32 ndarray
    straight through would re-materialize (and re-fingerprint) the batch
    on every discount lookup, defeating the identity-keyed memoization
    below.  A per-layer mapping ``{layer: batch}`` (see
    the reference's ``planning.tap.ActivationTap.calib``) canonicalizes each
    value; resolve one layer's batch with :func:`calib_for_layer`."""
    if calib is None:
        return None
    if isinstance(calib, dict):
        return {k: _f32(v) for k, v in calib.items()}
    return _f32(calib)


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _int_tensor(x_q) -> torch.Tensor:
    if isinstance(x_q, torch.Tensor):
        return x_q.cpu()
    return torch.from_numpy(np.ascontiguousarray(x_q))


def calib_for_layer(calib, layer):
    """Per-layer calibration mapping -> one batch: the layer's own
    captured activations when present, else the ``None``-keyed global
    fallback.  Plain arrays (and None) pass through."""
    if isinstance(calib, dict):
        got = calib.get(layer)
        return got if got is not None else calib.get(None)
    return calib


def _batch_key(arr: np.ndarray):
    """Content fingerprint of a calibration batch, cached per array
    object (identity-checked via weakref, so id() reuse cannot alias) —
    hashing the same default batch on every discount lookup would
    otherwise dominate the memoized path."""
    import hashlib
    import weakref
    hit = _BATCH_KEY_CACHE.get(id(arr))
    if hit is not None and hit[0]() is arr:
        return hit[1]
    key = (arr.shape, hashlib.sha1(arr.tobytes()).hexdigest()[:16])
    try:
        if len(_BATCH_KEY_CACHE) > 128:   # drop dead-weakref entries
            for k in [k for k, (ref, _) in _BATCH_KEY_CACHE.items()
                      if ref() is None]:
                del _BATCH_KEY_CACHE[k]
        _BATCH_KEY_CACHE[id(arr)] = (weakref.ref(arr), key)
    except TypeError:
        pass
    return key


def prt_hit_rate(nbw: int, abits: int, calib_batch=None,
                 entries: int = PRT_ENTRIES) -> float:
    """Measured PRT hit rate for one (NBW, abits) precision point.

    ``calib_batch``: f32 [B, K] activations (held-out data, or the
    synthetic default).  The batch is quantized per token at ``abits``
    and streamed through the PRT simulator — narrow activation codes
    repeat more often (2^``abits``-ish distinct bit-plane patterns), so
    the hit rate is genuinely per-precision rather than the paper's one
    global 17%.  Results are memoized on (nbw, abits, entries, batch).
    """
    if calib_batch is None:
        calib_batch = synthetic_activations(_SYNTH_K_CAP)
    arr = _f32(calib_batch)
    if arr.ndim != 2:
        raise ValueError(f"calib_batch must be [B, K], got {arr.shape}")
    key = (int(nbw), int(abits), int(entries), _batch_key(arr))
    hit = _HIT_RATE_CACHE.get(key)
    if hit is None:
        from repro_torch.core.quant import quantize_activations
        xq, _ = quantize_activations(torch.tensor(arr), abits)
        stats = measure_repeat_rate(xq, nbw, abits, entries)
        hit = stats.hit_rate
        _HIT_RATE_CACHE[key] = hit
    return hit


def prt_discount(nbw: int, abits: int, ql: int, calib_batch=None,
                 entries: int = PRT_ENTRIES, machine=None) -> float:
    """Measured pattern-aware cycle discount for one (nbw, abits, ql).

    Two per-precision effects compose:

      * the HIT RATE is measured per (nbw, abits) from ``calib_batch``
        via :func:`prt_hit_rate` — narrower activations repeat more;
      * the PER-HIT SAVING is a fixed amount of skipped C-SRAM work,
        calibrated so the paper's anchor (ql=4, 17% hits -> 13.8% fewer
        cycles) is reproduced exactly, then rescaled by the lookup-cost
        ratio: at cheap (low ``ql``) lookups a hit saves a larger
        fraction, at expensive ones a smaller fraction.

    Returns the multiplicative factor applied to lookup cycles.
    """
    from repro_torch.core import cost_model as _cm
    m = machine or _cm.SailMachine()
    hit = prt_hit_rate(nbw, abits, calib_batch, entries)
    saved_per_hit = (PAPER_CYCLE_REDUCTION / PAPER_REPEAT_RATE) * \
        _cm.lookup_cycles(m, PAPER_ANCHOR_QL)
    eff = saved_per_hit / _cm.lookup_cycles(m, ql)
    return max(0.0, 1.0 - eff * hit)
