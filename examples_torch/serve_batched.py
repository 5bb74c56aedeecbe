"""Batched serving with the SAIL quantized path (tensor-level scheduling),
on the H100 port.

Quantizes a model to ql bits, serves prompts through the
continuous-batching engine (weights streamed once per iteration, reused
by all active users — the paper's Sec. III-A — with finished slots
back-filled at iteration granularity), and reports the throughput
measured on the device it ran on plus the calibrated SAIL machine
model's projection for the same workload on the paper's hardware.

Run:  PYTHONPATH=src python examples_torch/serve_batched.py --ql 4 --batch 8
      [--device cpu]

``--device`` defaults to ``cuda`` and raises when torch sees no CUDA
device; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse
import time

import numpy as np
import torch

import repro_torch.configs as C
from repro_torch.core import cost_model as cm
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.planning import plan_from_arg
from repro_torch.serving.engine import Engine, EngineConfig
from repro_torch.tree import tree_leaves


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinymistral_248m")
    ap.add_argument("--ql", type=int, default=4)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--plan", default=None,
                    help="precision plan, e.g. rules:mlp=3,attn=5 or "
                         "auto:q4a8,prt=measured, or a plan.json path "
                         "(see repro_torch.planning)")
    ap.add_argument("--full", action="store_true",
                    help="use the full config instead of smoke (slow)")
    ap.add_argument("--mode", choices=("continuous", "batch"),
                    default="continuous")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the kernels' plain versions")
    return ap.parse_args(argv)


def model_config(args):
    return C.get_config(args.arch) if args.full else C.get_smoke(args.arch)


def build_engine(params, cfg, args, device):
    """The quantized continuous-batching engine over ``params`` (int8 KV,
    group 32, 256 cache slots a lane); prints its weights line."""
    plan = plan_from_arg(args.plan) if args.plan is not None else None
    engine = Engine(params, cfg, EngineConfig(
        batch_size=args.batch, cache_len=256, quantize=True, ql=args.ql,
        group_size=32, quant_kv=True, mode=args.mode, plan=plan),
        device=device)
    wdesc = (f"mixed ({args.plan})"
             if engine.stats()["mixed_precision"] else f"Q{args.ql}")
    print(f"serving {cfg.name}: weights {wdesc}, "
          f"compression {engine.compression:.2f}x, int8 KV cache")
    return engine


def prompts(cfg, n):
    """``n`` prompts of 4-11 tokens from ``np.random.default_rng(0)``."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, cfg.vocab, size=rng.integers(4, 12)).tolist()
            for _ in range(n)]


def serve(engine, cfg, args, device):
    """Serve ``args.requests`` prompts of ``args.max_new`` new tokens;
    prints the measured line and the first three completions."""
    for prompt in prompts(cfg, args.requests):
        engine.submit(prompt, max_new_tokens=args.max_new)
    t0 = time.time()
    completions = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    st = engine.stats()
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU")
    print(f"served {st['requests']} requests / "
          f"{st['generated_tokens']} tokens in {dt:.1f}s "
          f"({st['generated_tokens']/dt:.2f} tok/s measured on {where}, "
          f"{st['iterations']} model iterations, "
          f"mean TTFT {st['mean_ttft_s']:.2f}s)")
    for c in completions[:3]:
        print(f"  req {c.uid}: {len(c.tokens)} tokens, "
              f"latency {c.latency_s:.2f}s, first tokens {c.tokens[:8]}")
    return completions


def projection(params, cfg, args):
    """The SAIL machine model's tokens/s for a model of ``params``' size
    at ``args.ql`` and ``args.batch`` on the paper's hardware (a model,
    not a measurement)."""
    model = cm.ModelSpec("arch", sum(x.numel() for x in tree_leaves(params)),
                         cfg.d_model, cfg.n_layers,
                         cfg.d_ff or cfg.d_model * 4)
    proj = cm.sail_tokens_per_second(model, args.ql, threads=16,
                                     batch=args.batch)
    arm = cm.arm_tokens_per_second(model, args.ql, threads=16,
                                   batch=args.batch)
    print(f"SAIL machine-model projection @16T/batch{args.batch}: "
          f"{proj:.1f} tok/s (ARM CPU baseline {arm:.1f} -> "
          f"{proj/arm:.1f}x)")


def run(params, cfg, args, device):
    """Build the engine over ``params``, serve, project; returns the
    engine and its completions."""
    engine = build_engine(params, cfg, args, device)
    completions = serve(engine, cfg, args, device)
    projection(params, cfg, args)
    return engine, completions


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = model_config(args)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device)
    return run(params, cfg, args, device)


if __name__ == "__main__":
    main()
