"""Plain PyTorch versions of the LUT-GEMV kernel: dequantize, then one
f32 matmul (TF32 must be off on the card: the caller sets
``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default)."""
from __future__ import annotations

import torch

from repro_torch.core.quant import QTensor, dequantize


def lut_matmul_ref(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(qt)[K, N] in f32 accumulation."""
    return torch.matmul(x.to(torch.float32), dequantize(qt))


def lut_matmul_ref_int(x_q: torch.Tensor, x_scale: torch.Tensor,
                       qt: QTensor) -> torch.Tensor:
    """Int-activation version: y = (x_q @ dequant(qt)) * x_scale — the
    scale multiplies after the integer-code matmul, as the kernel does."""
    return torch.matmul(x_q.to(torch.float32), dequantize(qt)) * x_scale
