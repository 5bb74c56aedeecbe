"""The tensor-parallel process group (the serving role of
``repro.launch.mesh``).

The reference's ``(1, M)`` mesh becomes a ``torch.distributed`` group of M
ranks, one shard each.  ``run_ranks`` starts them as processes (start
method ``spawn``), each joining the group through a ``file://`` rendezvous
in a temporary directory, so no TCP port is needed.

Transport: gloo, for every rank, on the CPU and on the card.  On a host
with one GPU all ranks share it, and NCCL refuses two ranks on one
device; gloo reduces CUDA tensors through the host.  NCCL with one rank
per GPU is ROADMAP work.  Every group has a timeout, so a rank that
issues a different sequence of collectives fails instead of hanging.

The reference's ``make_production_mesh`` (the 512-device pod) waits for
the port's dry-run tools (ROADMAP, Queue 1 item 6).
"""
from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0


def describe(group=None) -> str:
    return (f"tp group of {dist.get_world_size(group)} ranks over "
            f"{dist.get_backend(group)} (this rank {dist.get_rank(group)})")


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
