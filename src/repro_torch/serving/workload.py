"""Trace-driven workload generation for the serving engine (port of
``repro.serving.workload``; numpy only, copied).

A workload is a parameterized, seeded, serializable request trace, and
every claim about a scheduler or a precision plan is made by replaying
the identical trace under each configuration:

  * :class:`LengthDist` — prompt/output token-length distributions
    (constant / uniform / lognormal, clamped to sane token counts);
  * :class:`ArrivalSpec` — the arrival process, measured in ENGINE
    ITERATIONS (wall-clock-free, so replays are deterministic on any
    host): ``fixed`` gaps, ``poisson`` arrivals, ``bursty`` (bursts of
    simultaneous arrivals separated by long exponential gaps), and
    ``diurnal`` (sinusoidally rate-modulated Poisson, generated by
    Lewis thinning);
  * :class:`TraceSpec` — (seed, vocab, n_requests, prompt dist, output
    dist, arrival process): the generator's full parameterization;
  * :class:`Trace` — the materialized request stream.  ``generate(spec)``
    is bit-identical per seed (and to the reference's: the same numpy
    draws in the same order, the same ``trace_hash``), and the JSON
    round-trip stores the materialized requests, so a saved
    ``trace.json`` replays exactly even if the generator's sampling order
    ever changes.

``spec_for_ratio`` builds a spec hitting a requested prefill:decode token
ratio.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np

TRACE_VERSION = 1

_DIST_KINDS = ("constant", "uniform", "lognormal")
_ARRIVAL_PROCESSES = ("fixed", "poisson", "bursty", "diurnal")


@dataclasses.dataclass(frozen=True)
class LengthDist:
    """A token-length distribution.

    ``uniform`` draws integers in [low, high] inclusive; ``lognormal``
    draws ``exp(N(log(mean), sigma))`` rounded to ints (the long-tail
    shape real prompt lengths follow), clamped to [low, high];
    ``constant`` always returns ``low``.
    """

    kind: str = "uniform"
    low: int = 4
    high: int = 13
    mean: float = 8.0
    sigma: float = 0.5

    def __post_init__(self):
        if self.kind not in _DIST_KINDS:
            raise ValueError(f"kind must be one of {_DIST_KINDS}, got {self.kind!r}")
        if self.low < 1:
            raise ValueError(f"low must be >= 1, got {self.low}")
        if self.high < self.low:
            raise ValueError(f"high {self.high} < low {self.low}")
        if self.mean <= 0 or self.sigma < 0:
            raise ValueError(f"bad lognormal params mean={self.mean} sigma={self.sigma}")

    @property
    def expected(self) -> float:
        """Mean length (after clamping, approximately for lognormal)."""
        if self.kind == "constant":
            return float(self.low)
        if self.kind == "uniform":
            return (self.low + self.high) / 2.0
        return float(min(max(self.mean * math.exp(self.sigma**2 / 2), self.low), self.high))

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        if self.kind == "constant":
            return np.full((n,), self.low, np.int64)
        if self.kind == "uniform":
            return rng.integers(self.low, self.high + 1, size=n)
        draws = rng.lognormal(math.log(self.mean), self.sigma, size=n)
        return np.clip(np.rint(draws).astype(np.int64), self.low, self.high)

    def to_json(self) -> Dict[str, Any]:
        return {
            "kind": self.kind,
            "low": self.low,
            "high": self.high,
            "mean": self.mean,
            "sigma": self.sigma,
        }

    @staticmethod
    def from_json(spec: Mapping[str, Any]) -> "LengthDist":
        return LengthDist(
            kind=spec.get("kind", "uniform"),
            low=int(spec.get("low", 4)),
            high=int(spec.get("high", 13)),
            mean=float(spec.get("mean", 8.0)),
            sigma=float(spec.get("sigma", 0.5)),
        )


@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """An arrival process over ENGINE ITERATIONS.

    ``gap`` is the mean inter-arrival gap in iterations for every
    process (so switching processes holds the offered load fixed):

      fixed     request i arrives at ``i * gap``
      poisson   exponential inter-arrivals of mean ``gap``
      bursty    bursts of ``burst`` simultaneous arrivals, separated by
                exponential gaps of mean ``burst * gap``
      diurnal   inhomogeneous Poisson with rate
                ``(1 + amplitude * sin(2*pi*t / period)) / gap``
                (Lewis thinning — a deterministic, seeded ramp up/down)
    """

    process: str = "fixed"
    gap: float = 3.0
    burst: int = 4
    period: float = 64.0
    amplitude: float = 0.8

    def __post_init__(self):
        if self.process not in _ARRIVAL_PROCESSES:
            raise ValueError(
                f"process must be one of {_ARRIVAL_PROCESSES}, got {self.process!r}"
            )
        if self.gap < 0:
            raise ValueError(f"gap must be >= 0, got {self.gap}")
        if self.burst < 1:
            raise ValueError(f"burst must be >= 1, got {self.burst}")
        if self.period <= 0:
            raise ValueError(f"period must be positive, got {self.period}")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError(f"amplitude must be in [0, 1), got {self.amplitude}")

    def arrival_iterations(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Nondecreasing int64 [n] arrival iterations starting at 0."""
        if n == 0:
            return np.zeros((0,), np.int64)
        if self.process == "fixed":
            times = self.gap * np.arange(n, dtype=np.float64)
        elif self.process == "poisson":
            times = np.cumsum(rng.exponential(self.gap, size=n))
            times -= times[0]
        elif self.process == "bursty":
            n_bursts = -(-n // self.burst)
            starts = np.cumsum(rng.exponential(self.gap * self.burst, size=n_bursts))
            starts -= starts[0]
            times = np.repeat(starts, self.burst)[:n]
        else:  # diurnal: Lewis thinning at peak rate (1 + amplitude) / gap
            lam_max = (1.0 + self.amplitude) / max(self.gap, 1e-9)
            t, out = 0.0, []
            while len(out) < n:
                t += rng.exponential(1.0 / lam_max)
                rate = (1.0 + self.amplitude * math.sin(2 * math.pi * t / self.period)) / max(
                    self.gap, 1e-9
                )
                if rng.random() <= rate / lam_max:
                    out.append(t)
            times = np.asarray(out) - out[0]
        return np.floor(times).astype(np.int64)

    def to_json(self) -> Dict[str, Any]:
        return {
            "process": self.process,
            "gap": self.gap,
            "burst": self.burst,
            "period": self.period,
            "amplitude": self.amplitude,
        }

    @staticmethod
    def from_json(spec: Mapping[str, Any]) -> "ArrivalSpec":
        return ArrivalSpec(
            process=spec.get("process", "fixed"),
            gap=float(spec.get("gap", 3.0)),
            burst=int(spec.get("burst", 4)),
            period=float(spec.get("period", 64.0)),
            amplitude=float(spec.get("amplitude", 0.8)),
        )


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """The full parameterization of one synthetic workload."""

    seed: int = 0
    n_requests: int = 16
    vocab: int = 256
    prompt: LengthDist = dataclasses.field(default_factory=LengthDist)
    output: LengthDist = dataclasses.field(
        default_factory=lambda: LengthDist(kind="uniform", low=6, high=12)
    )
    arrival: ArrivalSpec = dataclasses.field(default_factory=ArrivalSpec)
    # Shared system-prompt prefix: every request's prompt starts with the
    # SAME prefix_len sampled tokens (the paged pool's copy-on-write
    # prefix-sharing regime; serve_bench --paged-gate replays these).
    # 0 keeps the generator's legacy sampling order, so pre-existing
    # traces and their pinned hashes are unchanged.
    prefix_len: int = 0

    def __post_init__(self):
        if self.n_requests < 1:
            raise ValueError(f"n_requests must be >= 1, got {self.n_requests}")
        if self.vocab < 2:
            raise ValueError(f"vocab must be >= 2, got {self.vocab}")
        if self.prefix_len < 0:
            raise ValueError(f"prefix_len must be >= 0, got {self.prefix_len}")

    @property
    def prefill_decode_ratio(self) -> float:
        """Expected prompt tokens per generated token."""
        return self.prompt.expected / self.output.expected

    def to_json(self) -> Dict[str, Any]:
        out = {
            "seed": self.seed,
            "n_requests": self.n_requests,
            "vocab": self.vocab,
            "prompt": self.prompt.to_json(),
            "output": self.output.to_json(),
            "arrival": self.arrival.to_json(),
        }
        if self.prefix_len:
            out["prefix_len"] = self.prefix_len
        return out

    @staticmethod
    def from_json(spec: Mapping[str, Any]) -> "TraceSpec":
        return TraceSpec(
            seed=int(spec.get("seed", 0)),
            n_requests=int(spec.get("n_requests", 16)),
            vocab=int(spec.get("vocab", 256)),
            prompt=LengthDist.from_json(spec.get("prompt", {})),
            output=LengthDist.from_json(spec.get("output", {})),
            arrival=ArrivalSpec.from_json(spec.get("arrival", {})),
            prefix_len=int(spec.get("prefix_len", 0)),
        )


@dataclasses.dataclass(frozen=True)
class TraceRequest:
    """One materialized request: the prompt tokens, the generation
    budget, and the engine iteration at which it arrives."""

    prompt: Tuple[int, ...]
    max_new_tokens: int
    arrival_iteration: int

    def to_json(self) -> list:
        return [list(self.prompt), self.max_new_tokens, self.arrival_iteration]

    @staticmethod
    def from_json(spec) -> "TraceRequest":
        return TraceRequest(tuple(int(t) for t in spec[0]), int(spec[1]), int(spec[2]))


@dataclasses.dataclass(frozen=True)
class Trace:
    """A materialized request stream plus the spec that generated it.

    The JSON form stores the requests themselves, so a saved trace
    replays bit-identically regardless of generator evolution; the spec
    rides along as provenance.
    """

    spec: TraceSpec
    requests: Tuple[TraceRequest, ...]

    @property
    def total_prompt_tokens(self) -> int:
        return sum(len(r.prompt) for r in self.requests)

    @property
    def total_new_tokens(self) -> int:
        return sum(r.max_new_tokens for r in self.requests)

    @property
    def trace_hash(self) -> str:
        """Stable content hash — replay artifacts key on it."""
        blob = json.dumps(self.to_json(), sort_keys=True, separators=(",", ":"))
        return hashlib.sha1(blob.encode()).hexdigest()[:12]

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": TRACE_VERSION,
            "spec": self.spec.to_json(),
            "requests": [r.to_json() for r in self.requests],
        }

    @staticmethod
    def from_json(spec: Mapping[str, Any]) -> "Trace":
        version = int(spec.get("version", TRACE_VERSION))
        if version > TRACE_VERSION:
            raise ValueError(f"trace version {version} is newer than {TRACE_VERSION}")
        return Trace(
            spec=TraceSpec.from_json(spec.get("spec", {})),
            requests=tuple(TraceRequest.from_json(r) for r in spec.get("requests", ())),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @staticmethod
    def load(path: str) -> "Trace":
        with open(path) as f:
            return Trace.from_json(json.load(f))


def generate(spec: TraceSpec) -> Trace:
    """Materialize a trace from its spec — bit-identical per seed.

    Sampling order (arrivals, then prompt lengths, then output lengths,
    then the shared prefix when ``prefix_len > 0``, then prompt tokens)
    is fixed: it is part of the reproducibility contract the determinism
    tests pin down.  ``prefix_len=0`` makes no prefix draw at all, so
    legacy specs keep their exact materialized traces and hashes.
    """
    rng = np.random.default_rng(spec.seed)
    arrivals = spec.arrival.arrival_iterations(rng, spec.n_requests)
    plens = spec.prompt.sample(rng, spec.n_requests)
    outs = spec.output.sample(rng, spec.n_requests)
    # shared system prompt: one extra draw AFTER the legacy sampling
    # order, so prefix_len=0 specs generate byte-identical traces to
    # pre-prefix versions of this generator
    prefix: Tuple[int, ...] = ()
    if spec.prefix_len:
        prefix = tuple(int(t) for t in rng.integers(0, spec.vocab, size=spec.prefix_len))
    reqs = []
    for i in range(spec.n_requests):
        prompt = prefix + tuple(
            int(t) for t in rng.integers(0, spec.vocab, size=int(plens[i]))
        )
        reqs.append(
            TraceRequest(
                prompt=prompt,
                max_new_tokens=int(outs[i]),
                arrival_iteration=int(arrivals[i]),
            )
        )
    return Trace(spec=spec, requests=tuple(reqs))


def spec_for_ratio(
    prefill_decode_ratio: float,
    n_requests: int = 16,
    vocab: int = 256,
    seed: int = 0,
    output_tokens: int = 8,
    arrival: Optional[ArrivalSpec] = None,
) -> TraceSpec:
    """A spec whose expected prompt:output token ratio is ``ratio``.

    Holds the decode side at ``output_tokens`` per request and scales
    the prompt distribution: prefill-heavy workloads (ratio >> 1) are
    the regime where Sarathi-style prefill budgeting matters, decode-
    heavy ones (ratio < 1) stress the masked-decode steady state.
    """
    if prefill_decode_ratio <= 0:
        raise ValueError(f"ratio must be positive, got {prefill_decode_ratio}")
    mean_prompt = max(1.0, prefill_decode_ratio * output_tokens)
    lo = max(1, int(round(mean_prompt * 0.5)))
    hi = max(lo, int(round(mean_prompt * 1.5)))
    return TraceSpec(
        seed=seed,
        n_requests=n_requests,
        vocab=vocab,
        prompt=LengthDist(kind="uniform", low=lo, high=hi),
        output=LengthDist(kind="constant", low=output_tokens, high=output_tokens),
        arrival=arrival if arrival is not None else ArrivalSpec(),
    )
