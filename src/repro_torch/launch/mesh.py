"""Meshes over ``torch.distributed`` process groups (port of
``repro.launch.mesh``) and the ranks that make them.

The reference's device mesh becomes a grid of processes, one rank per
device.  ``make_mesh(shape, axes)`` lays the running group's ranks out
row-major over ``shape`` and gives each axis the process group of this
rank's line along it (``Mesh.groups``): ``(D, 1)`` over
``("data", "model")`` is data parallelism over D ranks, ``(1, M)``
tensor parallelism over M.  With no process group initialised it is one
process, a mesh of size 1.

``run_ranks`` starts ranks as processes (start method ``spawn``), each
joining the group through a ``file://`` rendezvous in a temporary
directory, so no TCP port is needed.

Transport: gloo, for every rank, on the CPU and on the card.  On a host
with one GPU all ranks share it, and NCCL refuses two ranks on one
device; gloo reduces CUDA tensors through the host.  NCCL with one rank
per GPU is ROADMAP work.  Every group has a timeout, so a rank that
issues a different sequence of collectives fails instead of hanging.

``make_production_mesh`` describes the reference's production pod, (16,
16) over ``("data", "model")`` or (2, 16, 16) with a ``"pod"`` axis, as a
``MeshSpec``: the axis names and sizes that ``auto_microbatches``,
``make_plan`` and ``describe`` read, with no process or group behind
them.
"""
from __future__ import annotations

import dataclasses
import datetime
import itertools
import math
import os
import tempfile
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """A mesh's layout alone: axis names and sizes, no ranks."""
    axis_names: Tuple[str, ...]
    shape: Tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.shape)).get(axis, 1)


@dataclasses.dataclass(frozen=True)
class Mesh(MeshSpec):
    """A grid of ranks: ``ranks[i, j, ...]`` is the rank at those axis
    coordinates, ``groups[axis]`` the process group of this rank's line
    along ``axis`` (None when the axis has size 1: no collective), and
    ``rank`` this process's rank."""
    ranks: np.ndarray
    groups: Dict[str, Any]
    rank: int

    def coord(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        where = np.argwhere(self.ranks == self.rank)[0]
        return int(where[self.axis_names.index(axis)])


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh: 16 x 16 = 256 devices (one pod),
    or 2 x 16 x 16 = 512 (two pods), as a description."""
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_mesh(shape, axes) -> Mesh:
    """A mesh of ``shape`` over the running process group (its world size
    must be the mesh's size), or over this one process when no group is
    initialised (the mesh's size must be 1).  Every rank must call it,
    in the same order: it creates the axes' process groups."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in rank")
    n = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a mesh of {n} ranks {dict(zip(axes, shape))} "
                         f"needs a process group of {n}, got {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = np.arange(n).reshape(shape)
    groups: Dict[str, Any] = {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            groups[axis] = None
            continue
        if shape[i] == n:
            groups[axis] = dist.group.WORLD
            continue
        others = [range(m) for j, m in enumerate(shape) if j != i]
        for rest in itertools.product(*others):
            index = list(rest)
            index.insert(i, slice(None))
            line = [int(r) for r in ranks[tuple(index)]]
            group = dist.new_group(line)
            if rank in line:
                groups[axis] = group
    return Mesh(axis_names=axes, shape=shape, ranks=ranks, groups=groups,
                rank=rank)


def describe(mesh=None) -> str:
    """A mesh's axes and transport (a ``MeshSpec``: its axes and device
    count); given a process group (None: the default one) instead, that
    group's."""
    if isinstance(mesh, Mesh):
        backend = dist.get_backend() if dist.is_initialized() else "none"
        return (f"mesh {dict(zip(mesh.axis_names, mesh.shape))} on "
                f"{mesh.size} ranks ({backend}; this rank {mesh.rank})")
    if isinstance(mesh, MeshSpec):
        return (f"mesh {dict(zip(mesh.axis_names, mesh.shape))} on "
                f"{mesh.size} devices (a description: no ranks)")
    return (f"tp group of {dist.get_world_size(mesh)} ranks over "
            f"{dist.get_backend(mesh)} (this rank {dist.get_rank(mesh)})")


def rank_device(rank: int, device) -> torch.device:
    """Rank ``rank``'s device.  When ``device`` names CUDA, rank 0 takes
    the card it names (``cuda`` alone: ``cuda:0``) and rank r the card r
    places after it, modulo the card count, so ranks share the cards round
    robin; else ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    first = dev.index or 0
    if rank == 0:
        return torch.device("cuda", first)
    return torch.device("cuda", (first + rank) % torch.cuda.device_count())


def _rank_main(rank: int, fn: Callable, world_size: int, init_method: str,
               args: Sequence[Any]) -> None:
    """One spawned rank: join the gloo group (rank 0 makes it), run
    ``fn``, leave the group."""
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence[Any] = (),
              rendezvous_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, *args)`` on ``world_size`` spawned ranks of one gloo
    group and wait for all of them; a rank's failure is raised here.
    ``fn`` must be importable by the spawned processes (a module-level
    function); the rendezvous file goes in ``rendezvous_dir``, or a
    temporary directory removed afterwards."""
    with tempfile.TemporaryDirectory(dir=rendezvous_dir) as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, init, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
