"""Atomic, asynchronous checkpoints of parameter trees, raw or quantized
(port of ``repro.checkpoint.checkpoint``).

Layout, the reference's:  <dir>/step_<N>/
    manifest.msgpack   step, leaves (id, path, shape, dtype) and extras
    leaf<NNNNN>.npy    one file per tree leaf, the full array
and ``<dir>/LATEST`` (JSON) naming the newest step.  Leaves are numbered
in ``jax.tree_util``'s order and their paths written as its ``keystr``
writes them (``repro_torch.tree``: a quantized weight's ``.packed``,
``.scales`` and ``.codebook`` are three leaves), so a directory written by
either package restores in the other.  The port carries packed words as
int32 bit patterns and the reference as uint32: ``save`` writes every
``.packed`` leaf as uint32 (the same bytes, ``ndarray.view``) and
``restore`` reads uint32 back as int32 the same way, never by a value
cast.  A leaf that is not an array or a tensor is refused, not pickled.

``save_quantized`` stores the ``QuantPolicy`` spec and the serving
``PlanSpec`` in the extras, so ``restore_quantized`` rebuilds the
quantized tree (per-leaf bits and abits, the ``blocks`` segmentation)
from the raw model's template alone and ``restored_plan`` gives the plan.

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
from repro_torch.device import resolve_device
from repro_torch.tree import (tree_flatten_with_path, tree_map,
                              tree_unflatten)


def _leaf_id(i: int) -> str:
    return f"leaf{i:05d}"


def _check_leaf(path: str, leaf) -> None:
    """Refuse a leaf that ``np.save`` would pickle."""
    if not isinstance(leaf, (torch.Tensor, np.ndarray, np.generic, bool,
                             int, float)):
        raise TypeError(f"checkpoint leaf {path} is a "
                        f"{type(leaf).__name__}, not an array or a tensor")
    if getattr(leaf, "dtype", None) == object:
        raise TypeError(f"checkpoint leaf {path} holds Python objects")


def _host(path: str, leaf) -> np.ndarray:
    """``leaf`` as the array to write: packed words as uint32."""
    if isinstance(leaf, torch.Tensor):
        arr = leaf.detach().cpu().numpy()
    else:
        arr = np.asarray(leaf)
    if path.endswith(".packed") and arr.dtype == np.int32:
        arr = arr.view(np.uint32)
    return arr


def save(directory: str, step: int, tree, extras: Optional[Dict] = None,
         process_index: int = 0, process_count: int = 1) -> str:
    """Write ``tree`` as checkpoint ``step`` under ``directory``; returns
    the step's directory."""
    flat = tree_flatten_with_path(tree)
    for path, leaf in flat:
        _check_leaf(path, leaf)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + f".tmp{process_index}"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": [], "extras": extras or {}}
    for i, (path, leaf) in enumerate(flat):
        lid = _leaf_id(i)
        arr = _host(path, leaf)
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


def restore(directory: str, template, step: Optional[int] = None,
            device=None):
    """Restore checkpoint ``step`` (default: the latest) into the
    structure of ``template``.  Each tensor goes to ``device``, or when
    that is None to its template leaf's device (a template on the meta
    device needs ``device``), as its template leaf's dtype (a template
    leaf that is not a tensor gives a tensor of the stored dtype, uint32
    read as int32).  Returns (tree, extras)."""
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
        if arr.dtype == np.uint32:
            arr = arr.view(np.int32)
        t = torch.from_numpy(arr)
        dev = device
        if dev is None and isinstance(tleaf, torch.Tensor):
            dev = tleaf.device
            if dev.type == "meta":
                raise ValueError(f"{rec['path']}: the template is on the "
                                 "meta device; pass device=")
        if isinstance(tleaf, torch.Tensor):
            t = t.to(device=dev, dtype=tleaf.dtype)
        elif dev is not None:
            t = t.to(dev)
        leaves.append(t)
    return tree_unflatten(template, leaves), meta.get("extras", {})


def save_quantized(directory: str, step: int, qtree, policy,
                   extras: Optional[Dict] = None, plan=None,
                   quant_kv: bool = True) -> str:
    """Save a quantized (possibly mixed-precision) parameter tree.  The
    ``QuantPolicy`` spec rides along in the extras, and the serving
    ``plan`` (a ``PlanSpec``; derived from the policy when None, recording
    ``quant_kv``; none for a policy no plan describes), so
    ``restore_quantized`` needs only the raw model's template."""
    from repro_torch.planning import PlanSpec
    extras = dict(extras or {})
    extras["quant_policy"] = policy.to_spec()
    if plan is None:
        try:
            plan = PlanSpec.from_policy(policy, quant_kv=quant_kv)
        except ValueError:
            plan = None
    if plan is not None:
        extras["plan"] = plan.to_json()
    return save(directory, step, qtree, extras)


def quantized_template(raw_template, policy):
    """The tree ``quantize_params(raw, policy)`` would give, its tensors
    empty on the meta device, by the same rules (``raw_template``: the
    raw tree, real or meta tensors)."""
    from repro_torch.models.sail_linear import quantized_shapes
    return quantized_shapes(raw_template, policy)


def restore_quantized(directory: str, raw_template,
                      step: Optional[int] = None, device="cuda"):
    """Restore a checkpoint written by ``save_quantized`` (either
    package's) onto ``device``, given only the raw model's template: the
    stored policy spec rebuilds the quantized structure.  Returns (tree,
    extras)."""
    from repro_torch.models.sail_linear import QuantPolicy
    if step is None:
        # pin the step once: a save landing mid-restore must not split the
        # manifest and the arrays across two checkpoints
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    spec = _load_manifest(directory, step).get("extras", {}).get(
        "quant_policy")
    if spec is None:
        raise ValueError(f"checkpoint under {directory} was not written "
                         "by save_quantized (no quant_policy in manifest)")
    template = quantized_template(raw_template, QuantPolicy.from_spec(spec))
    return restore(directory, template, step,
                   device=resolve_device(device))


def restored_plan(extras: Dict):
    """The serving ``PlanSpec`` a quantized checkpoint was written under
    (``restore_quantized``'s extras), or None when it has none."""
    from repro_torch.planning import PlanSpec
    spec = extras.get("plan")
    return PlanSpec.from_json(spec) if spec is not None else None


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
            if isinstance(a, torch.Tensor) else
            np.array(a) if isinstance(a, np.ndarray) else a, tree)

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
