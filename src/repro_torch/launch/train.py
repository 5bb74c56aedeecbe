"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
        --steps 1000 --ckpt /path/ckpt [--smoke] [--device cuda|cpu] \\
        [--mesh DxM] [--distributed]

Runs on the card unless ``--device cpu``.  Without ``--mesh`` it trains
on one device.  ``--mesh DxM`` trains over D x M ranks: data-parallel
over D (FSDP, as ``make_plan`` decides) and tensor-parallel over M (the
configs ``launch.steps.tp_train_supported`` accepts: the dense and MoE
decoders; any other raises ``NotImplementedError`` before a rank
starts).  Without
``--distributed`` the launcher spawns the ranks itself
(``launch.mesh.run_ranks``, gloo), sharing the named device's cards
round robin (``rank_device``); each rank draws the single-process global
batch and keeps its data coordinate's rows, so the run is the reference
launcher's on one host with D x M devices.  ``--distributed`` joins the
group that torchrun's environment describes (``env://``: ``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) instead, one process
per device: each data coordinate draws its own host's batch
(``n_hosts`` = D, ``host_id`` = the rank's data coordinate, rank
``d * M + m``), as the reference's ``jax.process_count()`` /
``process_index()`` do with one process per host.

Fault tolerance comes from ``repro_torch.training.loop``: periodic
checkpoints under ``--ckpt`` (full arrays, the reference's layout), a
final one on SIGTERM / SIGINT, and a restart that resumes from the
latest, at any data-parallel width.
"""
from __future__ import annotations

import argparse
import datetime
import os
import sys


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--mesh", default=None,
                    help="DxM rank mesh, e.g. 4x1 (default: one device)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group of torchrun's environment "
                         "(env://)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain PyTorch path")
    return ap


def _config(args):
    import repro_torch.configs as C
    return C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)


def _mesh_shape(text):
    if text is None:
        return None
    d, m = (int(x) for x in text.lower().split("x"))
    return d, m


def _check_model_axis(args, shape) -> None:
    """Refuse a model axis the config cannot shard, before any rank
    starts."""
    from repro_torch.launch.steps import tp_train_supported
    m = shape[1] if shape else 1
    reason = tp_train_supported(_config(args), m)
    if reason is not None:
        raise NotImplementedError(
            f"--mesh {args.mesh}: tensor-parallel training of {args.arch}: "
            f"{reason} (ROADMAP, Queue 1)")


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    shape = _mesh_shape(args.mesh)
    _check_model_axis(args, shape)

    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.launch.mesh import TIMEOUT_S, run_ranks

    resolve_device(args.device)
    if args.distributed:
        dist.init_process_group(
            "gloo", init_method="env://",
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        try:
            d, m = shape or (dist.get_world_size(), 1)
            _train(args, (d, m), n_hosts=d, host_id=dist.get_rank() // m,
                   local_rank=int(os.environ.get("LOCAL_RANK",
                                                 dist.get_rank())))
        finally:
            dist.destroy_process_group()
    elif shape is not None and shape[0] * shape[1] > 1:
        run_ranks(_rank_main, shape[0] * shape[1], args=(argv,))
    else:
        _train(args, shape)


def _rank_main(rank: int, argv) -> None:
    """One spawned rank of ``--mesh DxM``."""
    args = _parser().parse_args(argv)
    _train(args, _mesh_shape(args.mesh), local_rank=rank)


def _train(args, shape, n_hosts: int = 1, host_id: int = 0,
           local_rank: int = 0) -> None:
    import torch

    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import describe, make_mesh, rank_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig
    from repro_torch.tree import tree_leaves

    dev = rank_device(local_rank, args.device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = make_mesh(shape, ("data", "model")) if shape else None
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    cfg = _config(args)
    if mesh is None:
        say(f"one device: {dev}"
            + (f" ({torch.cuda.get_device_name(dev)})"
               if dev.type == "cuda" else ""))
    else:
        say(f"{describe(mesh)}, rank 0 on {dev}")

    built = build_train_step(cfg, mesh=mesh,
                             microbatches=args.microbatches or 1,
                             bf16_compute=False, device=dev,
                             local_batch=n_hosts > 1)
    init = built.meta["init"]
    opt = built.meta["optimizer"]
    dp = built.meta.get("dp")
    params = init(cfg, torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    say(f"{cfg.name}: "
        f"{sum(x.numel() for x in tree_leaves(params)) / 1e6:.1f}M"
        f" params, {args.steps} steps")
    if dp is not None:
        params = dp.shard(params)
    opt_state = opt.init(params)

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch,
        n_hosts=n_hosts, host_id=host_id, frontend=cfg.frontend,
        frontend_tokens=cfg.vision_tokens if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model))

    loop = TrainLoop(built.fn, params, opt_state, data,
                     TrainLoopConfig(total_steps=args.steps,
                                     checkpoint_dir=args.ckpt), dp=dp)
    loop.install_signal_handlers()
    if loop.maybe_restore():
        say(f"resumed from step {loop.step}")
    result = loop.run()
    say(f"finished at step {result['final_step']} "
        f"(preempted={result['preempted']})")


if __name__ == "__main__":
    main()
