"""Launch wrapper for the CUDA Algorithm-1 kernel (``csrc/typeconv.cu``).

Replaces ``int_to_f32_pallas`` (``src/repro/kernels/typeconv/kernel.py:75``).
The device function in ``csrc/typeconv.cuh`` is the same code the
integer LUT-GEMV inlines.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build


@functools.cache
def _fn():
    """The C entry point with its signature declared (once)."""
    fn = _build.load("typeconv").repro_int_to_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def int_to_f32_cuda(a: torch.Tensor, n: int) -> torch.Tensor:
    """int32 CUDA tensor (|a| < 2**(n-1)) -> float32, Algorithm 1 on the
    card.  Raises on anything the kernel does not take."""
    if a.device.type != "cuda" or a.dtype != torch.int32:
        raise ValueError(f"int_to_f32_cuda takes an int32 CUDA tensor, got "
                         f"{a.dtype} on {a.device}")
    if not a.is_contiguous():
        raise ValueError("int_to_f32_cuda needs a contiguous tensor")
    if not 2 <= n <= 25:
        raise ValueError("Algorithm 1 requires 2 <= n <= 25")
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    fn = _fn()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.launches["int_to_f32"] += 1
    _build.check(fn(a.data_ptr(), out.data_ptr(), a.numel(), n, stream),
                 "int_to_f32")
    return out
