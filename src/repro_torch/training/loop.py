"""Fault-tolerant training loop (port of ``repro.training.loop``).

  * periodic and final checkpoints (asynchronous, atomic, garbage
    collected down to ``keep_checkpoints``);
  * preemption: SIGTERM / SIGINT ask for a final checkpoint and a clean
    exit; a restart resumes bit-exact, the data iterator included;
  * straggler watchdog: a step longer than ``watchdog_factor`` times the
    median of the trailing 20 is reported;
  * NaN guard: a non-finite loss skips its update, and once more than
    ``max_nan_skips`` were skipped the loop raises ``FloatingPointError``;
  * elastic restore over a mesh (``dp``, the step's ``MeshRank``):
    checkpoints hold full arrays in the reference's layout, written by
    rank 0 after the slices are gathered over both axes (FSDP's and the
    model axis's), and every rank restores the full tree and keeps its
    slice, so a directory written on any ``(data, model)`` mesh (or by
    the reference) resumes on any other.  Every rank of the mesh agrees
    after every step (one small all-reduce) on the stop signal and the
    step's duration, and the loss is the global batch's, so SIGTERM, the
    watchdog and the NaN budget decide alike on every rank and no rank
    leaves the collectives alone.

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
from repro_torch.optim.adamw import AdamWState
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
                 data: SyntheticLM, lcfg: TrainLoopConfig, dp=None):
        self.step_fn = step_fn
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.lcfg = lcfg
        self.dp = dp
        self.step = 0
        self.metrics_log: list = []
        self._preempted = False          # this rank's signal
        self._stop = False               # any rank's, agreed after a step
        self._lead = dp is None or dp.mesh.rank == 0
        self._ckpt = (AsyncCheckpointer(lcfg.checkpoint_dir,
                                        lcfg.keep_checkpoints)
                      if lcfg.checkpoint_dir and self._lead else None)
        self._nan_skips = 0
        self._durations: list = []

    def _stopping(self) -> bool:
        """This rank's signal on one device; every rank's, as agreed after
        the last step, over a mesh."""
        return self._preempted if self.dp is None else self._stop

    def _say(self, msg: str) -> None:
        if self._lead:
            print(msg)

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
        if self.dp is None:
            (self.params, self.opt_state), extras = restore(
                d, (self.params, self.opt_state))
        else:
            # the full tree's template, then this rank's slices
            dp = self.dp
            step = torch.zeros((), dtype=torch.int32, device="meta")
            (params, state), extras = restore(
                d, (dp.template, AdamWState(step, dp.template, dp.template)),
                device=dp.device)
            self.params, self.opt_state = (dp.shard(params),
                                           dp.shard_state(state))
        self.step = int(extras.get("step", 0))
        self.data.load_state_dict(extras.get("data", {"step": self.step}))
        return True

    def save(self) -> None:
        if not self.lcfg.checkpoint_dir:
            return
        tree = (self.params, self.opt_state)
        if self.dp is not None:          # every rank joins the gather
            tree = (self.dp.gather(self.params),
                    self.dp.gather_state(self.opt_state))
        if self._ckpt:
            self._ckpt.save(self.step, tree,
                            extras={"step": self.step,
                                    "data": self.data.state_dict()})

    # --- main loop -----------------------------------------------------------
    def run(self) -> Dict[str, Any]:
        lcfg = self.lcfg
        dev = tree_leaves(self.params)[0].device
        it = iter(self.data)
        while self.step < lcfg.total_steps and not self._stopping():
            batch = {k: torch.from_numpy(np.asarray(v)).to(dev)
                     for k, v in next(it).items()}
            t0 = time.time()
            new_params, new_opt, metrics = self.step_fn(
                self.params, self.opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if self.dp is not None:
                stop, dt = self.dp.all_max([float(self._preempted), dt])
                self._stop = stop > 0

            if not np.isfinite(loss):
                self._nan_skips += 1
                self._say(f"[train] step {self.step}: non-finite loss "
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
                    self._say(f"[watchdog] step {self.step} took "
                              f"{dt:.2f}s (median {med:.2f}s) — straggler "
                              "suspected")

            if self.step % lcfg.log_every == 0:
                rec = {"step": self.step, "loss": loss,
                       "grad_norm": float(metrics["grad_norm"]),
                       "sec_per_step": dt}
                self.metrics_log.append(rec)
                self._say(f"[train] step {self.step}: loss {loss:.4f} "
                      f"gnorm {rec['grad_norm']:.2f} {dt:.2f}s/step")
            if lcfg.checkpoint_dir and \
                    self.step % lcfg.checkpoint_every == 0:
                self.save()

        if self._stopping():
            self._say("[train] preemption signal received — final "
                      "checkpoint")
        self.save()
        if self._ckpt:
            self._ckpt.wait()
        return {"final_step": self.step, "preempted": self._stopping(),
                "log": self.metrics_log}
