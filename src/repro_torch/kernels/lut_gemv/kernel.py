"""Launch wrapper for the CUDA LUT-GEMV (``csrc/lut_gemv.cu``).

Replaces ``lut_matmul_pallas`` (``src/repro/kernels/lut_gemv/kernel.py:138``)
and ``lut_matmul_int_pallas`` (``kernel.py:174``).  The kernel tiles and
masks the ragged M/N edges itself, so nothing is padded here (the TPU's
``pick_blocks`` / VMEM sizing has no counterpart).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.core.quant import KERNEL_BITS, SUPPORTED_ABITS, QTensor, \
    words_per_group
from repro_torch.kernels import _build

MAX_GROUP = 256      # x staging in shared memory: 4 warps x 8 rows x G floats


@functools.cache
def _fn():
    """The C entry point with its signature declared (once)."""
    fn = _build.load("lut_gemv").repro_lut_matmul
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_weight(qt: QTensor, k: int, device) -> None:
    if qt.bits not in KERNEL_BITS:
        raise ValueError(f"bits={qt.bits} not in {KERNEL_BITS}")
    if qt.k != k:
        raise ValueError(f"x has K={k}, weight has K={qt.k}")
    if qt.group_size > MAX_GROUP or qt.k % qt.group_size:
        raise ValueError(f"group_size={qt.group_size} must divide K and be "
                         f"<= {MAX_GROUP}")
    rows = (qt.k // qt.group_size) * words_per_group(qt.bits, qt.group_size)
    want = {"packed": (torch.int32, (rows, qt.n)),
            "scales": (torch.float32, (qt.k // qt.group_size, qt.n)),
            "codebook": (torch.float32, (1 << qt.bits,))}
    for name, (dtype, shape) in want.items():
        t = getattr(qt, name)
        if t.device != device or t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"qt.{name} must be {dtype} {shape} on {device}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"qt.{name} must be contiguous")


def _launch(x, xq, xs, qt: QTensor, m: int, k: int, abits: int,
            device) -> torch.Tensor:
    y = torch.empty((m, qt.n), dtype=torch.float32, device=device)
    fn = _fn()
    stream = torch.cuda.current_stream(device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    name = "lut_matmul_int" if abits else "lut_matmul"
    _build.launches[name] += 1
    _build.check(fn(ptr(x), ptr(xq), ptr(xs), qt.packed.data_ptr(),
                    qt.scales.data_ptr(), qt.codebook.data_ptr(),
                    y.data_ptr(), m, k, qt.n, qt.group_size,
                    words_per_group(qt.bits, qt.group_size), qt.bits, abits,
                    stream), name)
    return y


def lut_matmul_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(qt) on the card; x f32 contiguous."""
    if x.device.type != "cuda" or x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"lut_matmul_cuda takes f32 [M, K] on CUDA, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not x.is_contiguous():
        raise ValueError("lut_matmul_cuda needs a contiguous x")
    m, k = x.shape
    _check_weight(qt, k, x.device)
    return _launch(x, None, None, qt, m, k, 0, x.device)


def lut_matmul_int_cuda(x_q: torch.Tensor, x_scale: torch.Tensor,
                        qt: QTensor, abits: Optional[int]) -> torch.Tensor:
    """y = (x_q @ dequant(qt)) * x_scale on the card; x_q int32 [M, K]
    ``abits``-bit codes widened in-kernel by Algorithm 1, x_scale f32
    [M, 1]."""
    if abits not in SUPPORTED_ABITS:
        raise ValueError(f"abits={abits} not in {SUPPORTED_ABITS}")
    if (x_q.device.type != "cuda" or x_q.dtype != torch.int32
            or x_q.ndim != 2):
        raise ValueError(f"lut_matmul_int_cuda takes int32 [M, K] on CUDA, "
                         f"got {x_q.dtype} {tuple(x_q.shape)} on {x_q.device}")
    m, k = x_q.shape
    if (x_scale.device != x_q.device or x_scale.dtype != torch.float32
            or tuple(x_scale.shape) != (m, 1)):
        raise ValueError(f"x_scale must be f32 [{m}, 1] on {x_q.device}")
    if not (x_q.is_contiguous() and x_scale.is_contiguous()):
        raise ValueError("lut_matmul_int_cuda needs contiguous inputs")
    _check_weight(qt, k, x_q.device)
    return _launch(None, x_q, x_scale, qt, m, k, abits, x_q.device)
