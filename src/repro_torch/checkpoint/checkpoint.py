"""Atomic, asynchronous checkpoints of parameter trees (port of the
plain-tree part of ``repro.checkpoint.checkpoint``).

Layout, the reference's:  <dir>/step_<N>/
    manifest.msgpack   step, leaves (id, path, shape, dtype) and extras
    leaf<NNNNN>.npy    one file per tree leaf, the full array
and ``<dir>/LATEST`` (JSON) naming the newest step.  Leaves are numbered
in ``jax.tree_util``'s order and their paths written as its ``keystr``
writes them (``repro_torch.tree``), so a directory written by either
package restores in the other.

A step is written to a temporary directory and renamed into place, so a
preempted writer never corrupts the latest checkpoint.
``AsyncCheckpointer`` copies the tree to host memory, then writes on a
background thread while training goes on.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.tree import (tree_flatten_with_path, tree_map,
                              tree_unflatten)


def _leaf_id(i: int) -> str:
    return f"leaf{i:05d}"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, extras: Optional[Dict] = None,
         process_index: int = 0, process_count: int = 1) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``directory``; returns
    the step's directory."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": [], "extras": extras or {}}
    for i, (path, leaf) in enumerate(tree_flatten_with_path(tree)):
        lid = _leaf_id(i)
        arr = _host(leaf)
        np.save(os.path.join(tmp, lid + ".npy"), arr)
        meta["leaves"].append({"id": lid, "path": path,
                               "shape": list(arr.shape),
                               "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(_msgpack.packb(meta))
    if os.path.isdir(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _update_latest(directory, step)
    return final


def _update_latest(directory: str, step: int) -> None:
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        json.dump({"step": step}, f)
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))


def _load_manifest(directory: str, step: Optional[int] = None) -> Dict:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.msgpack"), "rb") as f:
        return _msgpack.unpackb(f.read())


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        steps = [int(d.split("_")[1]) for d in os.listdir(directory)
                 if d.startswith("step_") and not d.endswith(".tmp")] \
            if os.path.isdir(directory) else []
        return max(steps) if steps else None
    with open(p) as f:
        return int(json.load(f)["step"])


def restore(directory: str, template, step: Optional[int] = None):
    """Restore checkpoint ``step`` (default: the latest) into the
    structure of ``template``.  Each tensor goes to its template leaf's
    device and dtype (a template leaf that is not a tensor gives a CPU
    tensor of the stored dtype).  Returns (tree, extras)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = os.path.join(directory, f"step_{step:08d}")
    meta = _load_manifest(directory, step)
    flat_t = tree_flatten_with_path(template)
    if len(flat_t) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, template "
            f"{len(flat_t)} — structure changed")
    leaves = []
    for (_, tleaf), rec in zip(flat_t, meta["leaves"]):
        arr = np.load(os.path.join(d, rec["id"] + ".npy"))
        tshape = getattr(tleaf, "shape", None)
        if tshape is None:
            tshape = np.shape(tleaf)
        if list(arr.shape) != list(tshape):
            raise ValueError(f"shape mismatch at {rec['path']}: "
                             f"{arr.shape} vs {tuple(tshape)}")
        t = torch.from_numpy(arr)
        if isinstance(tleaf, torch.Tensor):
            t = t.to(device=tleaf.device, dtype=tleaf.dtype)
        leaves.append(t)
    return tree_unflatten(template, leaves), meta.get("extras", {})


def keep_last(directory: str, n: int = 3) -> None:
    """Garbage-collect old checkpoints, keeping the newest n."""
    if not os.path.isdir(directory):
        return
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-n]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


class AsyncCheckpointer:
    """Copy to host memory, then write on a background thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree, extras: Optional[Dict] = None) -> None:
        self.wait()
        host_tree = tree_map(
            lambda a: a.detach().to("cpu", copy=True).numpy()
            if isinstance(a, torch.Tensor) else np.array(a), tree)

        def work():
            try:
                save(self.directory, step, host_tree, extras)
                keep_last(self.directory, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
