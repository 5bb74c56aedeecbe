"""Public wrapper for the Algorithm-1 conversion: the CUDA kernel for a
CUDA tensor, the plain version for a CPU tensor."""
from __future__ import annotations

import torch

from repro_torch.kernels._build import route
from repro_torch.kernels.typeconv.kernel import int_to_f32_cuda
from repro_torch.kernels.typeconv.ref import int_to_f32_plain


def int_to_f32(a: torch.Tensor, n: int = 25) -> torch.Tensor:
    """Convert ints (|a| < 2**(n-1), n <= 25) to float32 with Algorithm 1."""
    if route(a) == "cuda":
        return int_to_f32_cuda(a, n)
    return int_to_f32_plain(a, n)
