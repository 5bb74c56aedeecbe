"""End-to-end training driver on the H100 port: data pipeline -> train
step -> fault-tolerant loop with checkpointing and resume.

Presets:
  --preset tiny   (default) ~0.1M params, 60 steps, the reference's chunked
                  attention (attn_chunk 64) — demonstrates loss going down;
  --preset 100m   the "~100M model for a few hundred steps" configuration
                  (the real driver config);
  --arch <id>     any registry architecture at smoke scale.

Fault tolerance demo: run, Ctrl-C it mid-way, run again with the same
--ckpt dir — it resumes from the last checkpoint (data state included).

Run:  PYTHONPATH=src python examples_torch/train_lm.py --steps 60
      [--device cpu]

``--device`` defaults to ``cuda`` and raises when torch sees no CUDA
device; ``--device cpu`` runs on the CPU.  In a running process group of
W ranks the mesh is (W, 1) on ("data", "model"); outside one it is one
device.
"""
import argparse
import dataclasses

import torch
import torch.distributed as dist

import repro_torch.configs as C
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.steps import build_train_step
from repro_torch.models import lm
from repro_torch.models.common import ModelConfig
from repro_torch.training.loop import TrainLoop, TrainLoopConfig
from repro_torch.tree import tree_leaves


def preset_cfg(name: str, arch: str) -> ModelConfig:
    if name == "tiny":
        return dataclasses.replace(C.get_smoke(arch), attn_chunk=64)
    if name == "100m":
        # ~100M-param llama-style model (the real driver config)
        return ModelConfig(name="lm-100m", vocab=32000, d_model=640,
                           n_layers=10, n_heads=10, n_kv=5, d_ff=1728,
                           act="swiglu", max_seq=2048)
    raise ValueError(name)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(cfg, device):
    """The mesh over the running process group (or one device) and the
    reference example's train step on it: ``build_train_step``'s defaults
    (``microbatches`` from ``auto_microbatches`` at train_4k) with f32
    compute."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh((world, 1), ("data", "model"))
    print(f"training {cfg.name} on {world} device(s)")
    return build_train_step(cfg, mesh, bf16_compute=False, device=device)


def train(built, params, cfg, args):
    """The fault-tolerant loop over ``params`` (restored from ``--ckpt``
    when it holds a checkpoint); returns the loop's result."""
    opt = built.meta["optimizer"]
    dp = built.meta.get("dp")
    print(f"params: {sum(x.numel() for x in tree_leaves(params))/1e6:.1f}M")
    params = dp.shard(params)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    loop = TrainLoop(built.fn, params, opt.init(params), data,
                     TrainLoopConfig(total_steps=args.steps, log_every=5,
                                     checkpoint_every=20,
                                     checkpoint_dir=args.ckpt), dp=dp)
    loop.install_signal_handlers()
    if loop.maybe_restore():
        print(f"resumed from step {loop.step}")
    result = loop.run()
    first = result["log"][0]["loss"] if result["log"] else float("nan")
    last = result["log"][-1]["loss"] if result["log"] else float("nan")
    print(f"done: step {result['final_step']}  loss {first:.3f} -> "
          f"{last:.3f}")
    return result


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = preset_cfg(args.preset, args.arch)
    built = build(cfg, device)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device)
    return train(built, params, cfg, args)


if __name__ == "__main__":
    main()
