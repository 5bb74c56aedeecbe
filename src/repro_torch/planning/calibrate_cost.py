"""Fit DecodeCostModel constants to *measured* kernel timings (port of
``repro.planning.calibrate_cost``).

It times the bit-serial LUT-GEMV (``core.lut_gemv.lut_gemv``, the one the
reference times) across the (wbits, abits, NBW) grid on a device, fits the
SailMachine dataflow constants (LUT build overhead, per-group control
cost, lookup base and slope, and a fixed dispatch cost per (NBW, abits)
cell) by non-negative least squares in cycle space, and measures the
device's stream bandwidth.  The bit-serial oracle's work varies along the
(nbw, abits) axes the cost model prices (``2**nbw`` LUT entries, ``K/nbw``
groups, ``abits`` bit planes), which is why it is timed and the CUDA
LUT-GEMV, which has no NBW axis, is not.

The fitted constants are an *effective SAIL machine for this host*: the
cycles a SAIL machine at the model's nominal clock would need to match
these timings.  They are not the H100's LUT-GEMV speed, and every
tokens/s priced on them is that effective machine's.  They persist into
``PlanSpec.calibration`` provenance, so a plan records which machine it
was priced for.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import time
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cost_model import SailMachine, lut_gemv_cycles
from repro_torch.device import resolve_device
from repro_torch.planning.cost import (FITTED_FIELDS, dispatch_from_json,
                                       machine_from_json, parse_dispatch)

__all__ = ["CalibrationResult", "DEFAULT_ABITS", "DEFAULT_NBW",
           "DEFAULT_WBITS", "FITTED_FIELDS", "dispatch_from_json",
           "fit_constants", "machine_from_json", "measure_stream_bandwidth",
           "run_calibration", "timeit_s"]

DEFAULT_WBITS = (2, 4, 8)
DEFAULT_ABITS = (4, 6, 8)
DEFAULT_NBW = (1, 2, 3, 4)


def timeit_s(fn, *args, iters: int = 10, device="cpu") -> float:
    """Median wall seconds per call: one warm-up, then each timed call
    bracketed by ``torch.cuda.synchronize`` on a CUDA device."""
    dev = torch.device(device)
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else (lambda: None))
    fn(*args)
    sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        times.append(time.perf_counter() - t0)
    return float(statistics.median(times))


@dataclasses.dataclass(frozen=True)
class CalibrationResult:
    """Fitted machine constants + the measurements behind them."""

    machine_overrides: Dict[str, float]
    points: Tuple[Mapping[str, Any], ...]  # per grid point: config + errors
    shape: Tuple[int, int, int]  # (batch, k, n) timed
    backend: str
    max_rel_err: float
    mean_rel_err: float
    dram_bw_measured: float
    # fitted per-(NBW, abits) fixed dispatch overhead (cycles per call)
    dispatch_cycles: Dict[Tuple[int, int], float] = dataclasses.field(default_factory=dict)

    def machine(self, base: Optional[SailMachine] = None) -> SailMachine:
        base = base if base is not None else SailMachine()
        return dataclasses.replace(base, **self.machine_overrides)

    def cost_model(self, **kwargs):
        from repro_torch.planning.cost import DecodeCostModel

        if self.dispatch_cycles and "dispatch_cycles" not in kwargs:
            kwargs["dispatch_cycles"] = tuple(sorted(self.dispatch_cycles.items()))
        return DecodeCostModel(machine=self.machine(), **kwargs)

    def provenance(self) -> Dict[str, Any]:
        """Compact JSON-safe record for ``PlanSpec.calibration``."""
        out = {
            "machine_overrides": {k: float(v) for k, v in self.machine_overrides.items()},
            "backend": self.backend,
            "shape": list(self.shape),
            "max_rel_err": float(self.max_rel_err),
            "mean_rel_err": float(self.mean_rel_err),
            "dram_bw_measured": float(self.dram_bw_measured),
        }
        if self.dispatch_cycles:
            out["dispatch_cycles"] = {
                f"{nbw}:{ab}": float(v)
                for (nbw, ab), v in sorted(self.dispatch_cycles.items())
            }
        return out

    def to_json(self) -> Dict[str, Any]:
        d = self.provenance()
        d["points"] = [dict(p) for p in self.points]
        return d

    @staticmethod
    def from_json(d: Mapping[str, Any]) -> "CalibrationResult":
        pts = tuple(dict(p) for p in d.get("points", ()))
        return CalibrationResult(
            machine_overrides={k: float(v) for k, v in d["machine_overrides"].items()},
            points=pts,
            shape=tuple(int(s) for s in d["shape"]),
            backend=str(d.get("backend", "unknown")),
            max_rel_err=float(d["max_rel_err"]),
            mean_rel_err=float(d["mean_rel_err"]),
            dram_bw_measured=float(d.get("dram_bw_measured", 0.0)),
            dispatch_cycles=parse_dispatch(d.get("dispatch_cycles", {})),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)

    @staticmethod
    def load(path: str) -> "CalibrationResult":
        with open(path) as f:
            return CalibrationResult.from_json(json.load(f))


def _design_row(
    m: SailMachine, batch: int, k: int, n: int, nbw: int, wbits: int, abits: int
) -> np.ndarray:
    """Feature vector so that cycles = row @ theta with
    theta = [build_overhead, rebuild_ctrl_cycles, lookup_base_cycles,
             lookup_per_bit_cycles] (threads=1, no PRT discount)."""
    import math

    arrays = m.arrays_per_thread
    n_tiles = math.ceil(n / m.array_cols)
    scale = n_tiles * (k / nbw) / arrays
    entry_bits = wbits + max(1, math.ceil(math.log2(max(nbw, 2))))
    n_adds = max((1 << nbw) - nbw - 1, 0)
    adds_load = n_adds * m.add_cycles(entry_bits) + nbw * 2.0
    ctrl_shape = (2.0 / nbw) ** m.rebuild_nbw_exp
    return scale * np.array([adds_load, ctrl_shape, batch * abits, batch * abits * wbits])


def fit_constants(
    points: Sequence[Mapping[str, Any]],
    batch: int,
    k: int,
    n: int,
    machine_base: Optional[SailMachine] = None,
    fit_dispatch: bool = False,
):
    """Least-squares fit of the dataflow constants in cycle space.

    ``points``: dicts with wbits/abits/nbw/t_s.  Cycles are taken at the
    machine's nominal frequency, so the constants become *effective* costs
    for the timed host.  Rows are weighted by 1/measured (relative error);
    negative solutions are clipped and the remaining columns refit.
    ``fit_dispatch=True`` adds one indicator column per (NBW, abits) cell
    and returns ``(constants, dispatch_cycles)``.
    """
    m = machine_base if machine_base is not None else SailMachine()
    feats = [_design_row(m, batch, k, n, p["nbw"], p["wbits"], p["abits"]) for p in points]
    rows = np.stack(feats)
    cells: List[Tuple[int, int]] = []
    if fit_dispatch:
        cells = sorted({(int(p["nbw"]), int(p["abits"])) for p in points})
        ind = np.zeros((rows.shape[0], len(cells)))
        for i, p in enumerate(points):
            ind[i, cells.index((int(p["nbw"]), int(p["abits"])))] = 1.0
        rows = np.concatenate([rows, ind], axis=1)
    target = np.array([p["t_s"] * m.freq_hz for p in points])
    rows = rows / target[:, None]
    target = np.ones_like(target)
    active = list(range(rows.shape[1]))
    theta = np.zeros(rows.shape[1])
    for _ in range(rows.shape[1]):
        sol, *_ = np.linalg.lstsq(rows[:, active], target, rcond=None)
        if (sol >= 0).all():
            theta[active] = sol
            break
        active = [a for a, s in zip(active, sol) if s >= 0]
        if not active:
            break
    constants = {
        "build_overhead": float(theta[0]),
        "rebuild_ctrl_cycles": float(theta[1]),
        "lookup_base_cycles": float(theta[2]),
        "lookup_per_bit_cycles": float(theta[3]),
    }
    if not fit_dispatch:
        return constants
    dispatch = {cell: float(theta[4 + i]) for i, cell in enumerate(cells)}
    return constants, dispatch


def measure_stream_bandwidth(nbytes: int = 64 * 2**20, iters: int = 5,
                             device="cuda") -> float:
    """Stream bandwidth (bytes/s) of ``device``: one read and one write of
    a ``nbytes`` f32 tensor per call."""
    dev = resolve_device(device)
    a = torch.ones((nbytes // 4,), dtype=torch.float32, device=dev)
    t = timeit_s(lambda a: a * 1.0000001, a, iters=iters, device=dev)
    return 2.0 * nbytes / t


def _backend(dev: torch.device) -> str:
    if dev.type == "cuda":
        return f"cuda ({torch.cuda.get_device_name(dev)})"
    return dev.type


def run_calibration(
    batch: int = 8,
    k: int = 512,
    n: int = 256,
    wbits_grid: Sequence[int] = DEFAULT_WBITS,
    abits_grid: Sequence[int] = DEFAULT_ABITS,
    nbw_grid: Sequence[int] = DEFAULT_NBW,
    iters: int = 10,
    machine_base: Optional[SailMachine] = None,
    device="cuda",
) -> CalibrationResult:
    """Time the bit-serial LUT-GEMV grid on ``device``, fit the constants,
    report modeled-vs-measured per grid point.  The integer codes are the
    reference's ``jax.random.randint`` draws (``core.prng``)."""
    from repro_torch.core import lut_gemv as lg
    from repro_torch.core import prng

    dev = resolve_device(device)
    m = machine_base if machine_base is not None else SailMachine()
    raw: List[Dict[str, Any]] = []
    for wbits in wbits_grid:
        qmax = (1 << (wbits - 1)) - 1 if wbits > 1 else 1
        wq = torch.from_numpy(prng.randint(0, (k, n), -qmax, qmax + 1)).to(dev)
        for abits in abits_grid:
            amax = (1 << (abits - 1)) - 1
            xq = torch.from_numpy(
                prng.randint(abits, (batch, k), -amax, amax + 1)).to(dev)
            for nbw in nbw_grid:
                t = timeit_s(
                    lambda x, w, nbw=nbw, abits=abits: lg.lut_gemv(x, w, nbw=nbw, abits=abits),
                    xq,
                    wq,
                    iters=iters,
                    device=dev,
                )
                raw.append(dict(wbits=wbits, abits=abits, nbw=nbw, t_s=t))

    overrides, dispatch = fit_constants(raw, batch, k, n, machine_base=m,
                                        fit_dispatch=True)
    bw = measure_stream_bandwidth(device=dev)
    overrides["dram_bw"] = bw
    overrides["dram_efficiency"] = 1.0  # measured BW is already achieved
    fitted = dataclasses.replace(m, **overrides)

    points = []
    errs = []
    for p in raw:
        wb, ab, nbw = p["wbits"], p["abits"], p["nbw"]
        modeled = lut_gemv_cycles(fitted, batch, k, n, nbw, wb, ab, threads=1)
        modeled += dispatch.get((int(nbw), int(ab)), 0.0)
        measured = p["t_s"] * m.freq_hz
        rel = abs(modeled - measured) / measured
        errs.append(rel)
        points.append(
            dict(
                p,
                measured_cycles=float(measured),
                modeled_cycles=float(modeled),
                rel_err=float(rel),
            )
        )

    return CalibrationResult(
        machine_overrides=overrides,
        points=tuple(points),
        shape=(batch, k, n),
        backend=_backend(dev),
        max_rel_err=float(np.max(errs)),
        mean_rel_err=float(np.mean(errs)),
        dram_bw_measured=bw,
        dispatch_cycles=dispatch,
    )
