"""Public wrapper for the LUT-GEMV: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, and the int-activation dispatch — when
the QTensor carries ``abits`` the activations are quantized per token
and the integer path runs (reference ``lut_gemv/ops.py:96-99``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant import QTensor, quantize_activations
from repro_torch.kernels._build import route
from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda, \
    lut_matmul_int_cuda
from repro_torch.kernels.lut_gemv.ref import lut_matmul_ref, \
    lut_matmul_ref_int


def lut_matmul(x: torch.Tensor, qt: QTensor,
               plan_rows: Optional[int] = None,
               k_sharded: bool = False) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(qt) in f32, the SAIL serving matmul.
    ``plan_rows``: on the card, split K as for a call of that many rows, so
    each row's sum is bit-equal to that call's (speculative verify sums its
    B x (k+1) rows as the decode step's B rows); the plain version has no
    split.  ``k_sharded``: x is a rank's K-slice of a row-parallel input
    (its activation scale is the group's, ``quantize_activations``)."""
    if qt.abits is not None and x.is_floating_point():
        x_q, x_scale = quantize_activations(x, qt.abits, k_sharded)
        return lut_matmul_quantized(x_q, x_scale, qt, plan_rows)
    if route(x) == "cuda":
        return lut_matmul_cuda(x, qt, plan_rows)
    return lut_matmul_ref(x, qt)


def lut_matmul_quantized(x_q: torch.Tensor, x_scale: torch.Tensor,
                         qt: QTensor,
                         plan_rows: Optional[int] = None) -> torch.Tensor:
    """y[M, N] = (x_q @ dequant(qt)) * x_scale — the int-activation path.
    x_q int32 codes and x_scale f32 [M, 1] from ``quantize_activations``."""
    abits = qt.abits if qt.abits is not None else 8
    if route(x_q) == "cuda":
        return lut_matmul_int_cuda(x_q, x_scale, qt, abits, plan_rows)
    return lut_matmul_ref_int(x_q, x_scale, qt)
