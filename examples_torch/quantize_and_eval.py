"""Quantization sensitivity sweep (the algorithm-level face of Fig. 9), on
the H100 port.

Trains a small LM briefly, then quantizes it at every supported precision
(Q2..Q8) and reports eval-loss degradation, weight compression, and the
SAIL cost model's projected speedup at that precision — the quality/speed
trade-off the ``ql`` instruction field exposes.  On the card the
quantized eval losses run their matmuls through the LUT-GEMV kernel.

Run:  PYTHONPATH=src python examples_torch/quantize_and_eval.py [--device cpu]

``--device`` defaults to ``cuda`` and raises when torch sees no CUDA
device; ``--device cpu`` runs the kernels' plain versions.
"""
import argparse

import torch

import repro_torch.configs as C
from repro_torch.core import cost_model as cm
from repro_torch.core import sensitivity as sens
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.sail_linear import QuantPolicy, quantize_params, \
    nf_codebook
from repro_torch.optim.adamw import AdamW
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3_2_1b")
    ap.add_argument("--train-steps", type=int, default=30)
    ap.add_argument("--nf", action="store_true",
                    help="use the non-uniform (normal-float) codebook")
    ap.add_argument("--no-alloc", action="store_true",
                    help="skip the sensitivity-allocated mixed rows")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu: the kernels' plain versions")
    return ap.parse_args(argv)


def train_step(params, opt_state, batch, cfg, opt, device):
    """One AdamW step on ``lm.loss_fn``'s gradient; returns (params,
    opt_state, loss)."""
    fp = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = tree_leaves(fp)
    with torch.enable_grad():
        loss, _ = lm.loss_fn(fp, batch, cfg, device=device)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, gs)])
    upd, opt_state, _ = opt.update(grads, opt_state, params)
    return opt.apply(params, upd), opt_state, loss.detach()


def train(params, cfg, data, steps, device):
    """``steps`` steps of AdamW(3e-3) on ``data``; prints the last loss and
    returns the trained tree."""
    opt = AdamW(learning_rate=3e-3)
    opt_state = opt.init(params)
    for _ in range(steps):
        params, opt_state, loss = train_step(params, opt_state,
                                             data.next_batch(), cfg, opt,
                                             device)
    print(f"trained {steps} steps, loss {float(loss):.3f}")
    return params


def eval_loss(params, batch, cfg, device) -> float:
    with torch.no_grad():
        return float(lm.loss_fn(params, batch, cfg, device=device)[0])


def sweep(params, cfg, eval_batch, nf, device):
    """The f32 row and one row per width Q8..Q2; returns the f32 loss."""
    base_loss = eval_loss(params, eval_batch, cfg, device)
    print(f"\n{'ql':>3s} {'eval loss':>10s} {'delta':>8s} {'compress':>9s} "
          f"{'SAIL 7B-proj tok/s':>18s}")
    print(f"{'f32':>3s} {base_loss:10.4f} {'-':>8s} {'1.0x':>9s} {'-':>18s}")
    for ql in (8, 6, 5, 4, 3, 2):
        cb = nf_codebook(ql, device) if nf else None
        qp, b0, b1 = quantize_params(
            params, QuantPolicy(bits=ql, group_size=32, min_size=1024,
                                codebook=cb))
        qloss = eval_loss(qp, eval_batch, cfg, device)
        proj = cm.sail_tokens_per_second(cm.LLAMA2_7B, ql, 16, 8)
        print(f"Q{ql:>2d} {qloss:10.4f} {qloss-base_loss:+8.4f} "
              f"{b0/b1:8.1f}x {proj:18.1f}")
    return base_loss


def allocated_row(params, cfg, eval_batch, nf, base_loss, device):
    """Sensitivity-allocated mixed precision at the uniform-4 byte budget:
    same weight bytes, lower degradation (SAIL's "optimal bit precision
    varies across layers")."""
    base = QuantPolicy(bits=4, group_size=32, min_size=1024,
                       codebook=nf_codebook if nf else None)
    pol, _ = sens.calibrate_policy(params, cfg, base, match_uniform=4,
                                   tokens=eval_batch["tokens"][:, :-1])
    qp, b0, b1 = quantize_params(params, pol)
    qloss = eval_loss(qp, eval_batch, cfg, device)
    print(f"mix {qloss:10.4f} {qloss-base_loss:+8.4f} {b0/b1:8.1f}x "
          f"{'(allocated at the Q4 byte budget)':>18s}")


def run(params, cfg, args, device):
    """Train ``params`` for ``args.train_steps`` steps, then the sweep and
    (unless ``--no-alloc``) the allocated row; returns the trained tree."""
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=64,
                                  global_batch=8))
    params = train(params, cfg, data, args.train_steps, device)
    eval_batch = data.next_batch()
    base_loss = sweep(params, cfg, eval_batch, args.nf, device)
    if not args.no_alloc:
        allocated_row(params, cfg, eval_batch, args.nf, base_loss, device)
    return params


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = C.get_smoke(args.arch)
    params = lm.init_params(cfg, torch.Generator(device).manual_seed(0),
                            device)
    return run(params, cfg, args, device)


if __name__ == "__main__":
    main()
