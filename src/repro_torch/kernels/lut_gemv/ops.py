"""Public wrapper for the LUT-GEMV: the CUDA kernel for CUDA tensors, the
plain version for CPU tensors, and the int-activation dispatch — when
the QTensor carries ``abits`` the activations are quantized per token
and the integer path runs (reference ``lut_gemv/ops.py:96-99``)."""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, quantize_activations
from repro_torch.kernels._build import route
from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda, \
    lut_matmul_int_cuda
from repro_torch.kernels.lut_gemv.ref import lut_matmul_ref, \
    lut_matmul_ref_int


def lut_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(qt) in f32, the SAIL serving matmul."""
    if qt.abits is not None and x.is_floating_point():
        x_q, x_scale = quantize_activations(x, qt.abits)
        return lut_matmul_quantized(x_q, x_scale, qt)
    if route(x) == "cuda":
        return lut_matmul_cuda(x, qt)
    return lut_matmul_ref(x, qt)


def lut_matmul_quantized(x_q: torch.Tensor, x_scale: torch.Tensor,
                         qt: QTensor) -> torch.Tensor:
    """y[M, N] = (x_q @ dequant(qt)) * x_scale — the int-activation path.
    x_q int32 codes and x_scale f32 [M, 1] from ``quantize_activations``."""
    abits = qt.abits if qt.abits is not None else 8
    if route(x_q) == "cuda":
        return lut_matmul_int_cuda(x_q, x_scale, qt, abits)
    return lut_matmul_ref_int(x_q, x_scale, qt)
