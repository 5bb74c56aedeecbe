"""int8 + per-tensor-scale compression of what crosses the wire, and the
gradient all-reduce with error feedback (port of ``repro.dist.compress``).

``_quantize_dequantize`` is the format: one absmax over the WHOLE tensor,
``scale = absmax / 127`` (1 / 127 for an all-zero tensor), codes rounded
half to even and clipped to +-127, and the tensor comes back as ``codes *
scale``.  Bit-equal to the reference.  Serving's ``tp_all_reduce`` sends
partial sums in it at wire 8.

``make_compressed_allreduce(group)`` is the reference's data-parallel
gradient exchange: each call quantizes ``grad + err`` per leaf, takes the
mean of the dequantized values over the group and keeps the residual
``x - y`` as the next call's error state (1-bit-Adam style), so the
applied gradient is unbiased over time.  As in the reference, what is
reduced is the dequantized f32 tensor: the numerics of a compressed
exchange, not its byte count (sending the int8 codes is ROADMAP work).
Both of its roundings are the reference's compiled step's: the residual
is rounded once (XLA contracts ``x - codes * scale`` into a fused
multiply-add), and the ranks' values are summed in rank order (XLA's CPU
all-reduce order), so codes, residual and mean are bit-equal to the
reference's on the CPU.  To fix the order, each rank's tensor is gathered
by one all-reduce of a zero-filled ``[world, ...]`` buffer (exact: one
nonzero term per element) and summed locally; that moves ``world`` times
the bytes of a plain all-reduce.  No path of the port calls this function
yet; that cost must go before a train step does (ROADMAP, Queue 1 item 7).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


def _quantize(x: torch.Tensor):
    """(int8 codes, f32 scale) of ``x``: one scale for the whole tensor.
    The divisor 127 is a tensor on ``x``'s device: torch's CUDA division by
    a Python scalar multiplies by its reciprocal, one rounding off the
    reference's quotient."""
    absmax = x.abs().amax()
    scale = (torch.where(absmax == 0, torch.ones_like(absmax), absmax)
             / absmax.new_tensor(127.0))
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def _quantize_dequantize(x: torch.Tensor) -> torch.Tensor:
    codes, scale = _quantize(x)
    return codes.to(torch.float32) * scale


def init_error_state(grads):
    """Zero residuals (f32) matching the gradient tree."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


def make_compressed_allreduce(group=None):
    """``fn(grads, err) -> (mean, new_err)`` over ``group`` (None: the
    default group): per leaf, ``x = g + e`` in f32, ``y`` its int8
    quantize-dequantize, ``mean`` the sum of the ranks' ``y`` in rank order
    over ``world`` and ``new_err = x - y``; one all-reduce per leaf."""
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def fn(grads, err):
        means, errs = [], []
        for g, e in zip(tree_leaves(grads), tree_leaves(err)):
            x = g.to(torch.float32) + e
            codes, scale = _quantize(x)
            # in f64 the product (7 + 24 bits) and the difference are
            # exact: one rounding, the fused multiply-add's
            errs.append((x.double() - codes.double() * scale.double())
                        .to(torch.float32))
            ys = x.new_zeros((world,) + tuple(x.shape))
            ys[rank] = codes.to(torch.float32) * scale
            dist.all_reduce(ys, op=dist.ReduceOp.SUM, group=group)
            total = ys[0]
            for r in range(1, world):
                total = total + ys[r]
            means.append(total / world)
        return tree_unflatten(grads, means), tree_unflatten(grads, errs)

    return fn
