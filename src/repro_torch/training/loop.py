"""Fault-tolerant training loop (port of ``repro.training.loop``).

  * periodic and final checkpoints (asynchronous, atomic, garbage
    collected down to ``keep_checkpoints``);
  * preemption: SIGTERM / SIGINT ask for a final checkpoint and a clean
    exit; a restart resumes bit-exact, the data iterator included;
  * straggler watchdog: a step longer than ``watchdog_factor`` times the
    median of the trailing 20 is reported;
  * NaN guard: a non-finite loss skips its update, and once more than
    ``max_nan_skips`` were skipped the loop raises ``FloatingPointError``.

Batches go to the device the parameters live on.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.tree import tree_leaves


@dataclasses.dataclass
class TrainLoopConfig:
    total_steps: int = 200
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    keep_checkpoints: int = 3
    watchdog_factor: float = 5.0
    max_nan_skips: int = 3


class TrainLoop:
    def __init__(self, step_fn: Callable, params, opt_state,
                 data: SyntheticLM, lcfg: TrainLoopConfig):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.lcfg = lcfg
        self.step = 0
        self.metrics_log: list = []
        self._preempted = False
        self._ckpt = (AsyncCheckpointer(lcfg.checkpoint_dir,
                                        lcfg.keep_checkpoints)
                      if lcfg.checkpoint_dir else None)
        self._nan_skips = 0
        self._durations: list = []

    # --- preemption --------------------------------------------------------
    def install_signal_handlers(self) -> None:
        def handler(signum, frame):
            self._preempted = True
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)

    # --- checkpoint/restore -------------------------------------------------
    def maybe_restore(self) -> bool:
        d = self.lcfg.checkpoint_dir
        if not d or latest_step(d) is None:
            return False
        (self.params, self.opt_state), extras = restore(
            d, (self.params, self.opt_state))
        self.step = int(extras.get("step", 0))
        self.data.load_state_dict(extras.get("data", {"step": self.step}))
        return True

    def save(self) -> None:
        if self._ckpt:
            self._ckpt.save(self.step, (self.params, self.opt_state),
                            extras={"step": self.step,
                                    "data": self.data.state_dict()})

    # --- main loop -----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        lcfg = self.lcfg
        dev = tree_leaves(self.params)[0].device
        it = iter(self.data)
        while self.step < lcfg.total_steps and not self._preempted:
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in next(it).items()}
            t0 = time.time()
            new_params, new_opt, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0

            if not np.isfinite(loss):
                self._nan_skips += 1
                print(f"[train] step {self.step}: non-finite loss "
                      f"({loss}); skipping update "
                      f"({self._nan_skips}/{lcfg.max_nan_skips})")
                if self._nan_skips > lcfg.max_nan_skips:
                    raise FloatingPointError(
                        "too many non-finite losses; aborting")
                continue                  # params / opt_state unchanged
            self.params, self.opt_state = new_params, new_opt
            self.step += 1
            self._durations.append(dt)

            if len(self._durations) > 20:
                med = float(np.median(self._durations[-20:]))
                if dt > lcfg.watchdog_factor * med and med > 0:
                    print(f"[watchdog] step {self.step} took {dt:.2f}s "
                          f"(median {med:.2f}s) — straggler suspected")

            if self.step % lcfg.log_every == 0:
                rec = {"step": self.step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "sec_per_step": dt}
                self.metrics_log.append(rec)
                print(f"[train] step {self.step}: loss {loss:.4f} "
                      f"gnorm {rec['grad_norm']:.2f} {dt:.2f}s/step")
            if lcfg.checkpoint_dir and \
                    self.step % lcfg.checkpoint_every == 0:
                self.save()

        if self._preempted:
            print("[train] preemption signal received — final checkpoint")
        self.save()
        if self._ckpt:
            self._ckpt.wait()
        return {"final_step": self.step, "preempted": self._preempted,
                "log": self.metrics_log}
