"""Training launcher (port of ``repro.launch.train``), one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_2_1b \\
        --steps 1000 --ckpt /path/ckpt [--smoke] [--device cuda|cpu]

Runs on the card unless ``--device cpu``.  Fault tolerance comes from
``repro_torch.training.loop``: periodic checkpoints under ``--ckpt``, a
final one on SIGTERM / SIGINT, and a restart that resumes from the
latest.  The reference's ``--mesh`` and ``--distributed`` belong to
data-parallel training, which the port does not have yet.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the plain PyTorch path")
    args = ap.parse_args(argv)

    import torch

    import repro_torch.configs as C
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig
    from repro_torch.tree import tree_leaves

    dev = resolve_device(args.device)
    cfg = C.get_smoke(args.arch) if args.smoke else C.get_config(args.arch)
    print(f"one device: {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda"
             else ""))

    built = build_train_step(cfg, microbatches=args.microbatches or 1,
                             bf16_compute=False, device=dev)
    init = built.meta["init"]
    opt = built.meta["optimizer"]
    params = init(cfg, torch.Generator(device=dev).manual_seed(0),
                  device=dev)
    opt_state = opt.init(params)
    print(f"{cfg.name}: "
          f"{sum(x.numel() for x in tree_leaves(params)) / 1e6:.1f}M"
          f" params, {args.steps} steps")

    data = SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.global_batch,
        frontend=cfg.frontend,
        frontend_tokens=cfg.vision_tokens if cfg.frontend == "vision" else 0,
        d_model=cfg.d_model))

    loop = TrainLoop(built.fn, params, opt_state, data,
                     TrainLoopConfig(total_steps=args.steps,
                                     checkpoint_dir=args.ckpt))
    loop.install_signal_handlers()
    if loop.maybe_restore():
        print(f"resumed from step {loop.step}")
    result = loop.run()
    print(f"finished at step {result['final_step']} "
          f"(preempted={result['preempted']})")


if __name__ == "__main__":
    main()
