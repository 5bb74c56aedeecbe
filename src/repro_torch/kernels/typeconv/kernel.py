"""Launch wrapper for the CUDA Algorithm-1 kernel (``csrc/typeconv.cu``).

Replaces ``int_to_f32_pallas`` (``src/repro/kernels/typeconv/kernel.py:75``).
The device function in ``csrc/typeconv.cuh`` is the same code the
integer LUT-GEMV inlines.  The kernel has one instance per n in
[MIN_N, MAX_N]; its grid (``grid``, pure Python) takes the card's SM count
and the instance's occupancy from the runtime.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

THREADS = 256          # csrc/typeconv.cu: THREADS
MIN_N, MAX_N = 2, 25   # csrc/typeconv.cu: one instance per n in this range


def grid(numel: int, sms: int, per_sm: int) -> int:
    """Blocks of one launch over ``numel`` elements: one 16-byte vector per
    thread, at most the ``sms * per_sm`` blocks the card holds at once
    (each thread then loops over several vectors)."""
    return max(1, min(-(-numel // (4 * THREADS)), sms * per_sm))


def out_offset(ptr: int) -> int:
    """Elements to skip in the output buffer so that it lies at the same
    offset modulo 16 bytes as an int32 input at address ``ptr``: the
    kernel's scalar head then aligns both to 16 bytes."""
    return (ptr % 16) // 4


@functools.cache
def _fn():
    """The C entry point with its signature declared (once)."""
    fn = _build.load("typeconv").repro_int_to_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def occupancy(n: int) -> int:
    """Blocks of the n instance one SM of the current card holds at once,
    as the CUDA runtime reports them."""
    fn = _build.load("typeconv").repro_int_to_f32_occupancy
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    blocks = fn(n)
    if blocks < 0:
        _build.check(-blocks, "int_to_f32 occupancy")
    return blocks


@functools.cache
def _card(index: int, n: int):
    """(SM count, resident blocks of the n instance) of CUDA device
    ``index``."""
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        return sms, occupancy(n)


def int_to_f32_cuda(a: torch.Tensor, n: int) -> torch.Tensor:
    """int32 CUDA tensor (|a| < 2**(n-1)), contiguous, at any offset ->
    float32, Algorithm 1 on the card.  Raises on anything the kernel does
    not take; dtype, layout and n are checked before the device."""
    if a.dtype != torch.int32:
        raise ValueError(f"int_to_f32_cuda takes int32, got {a.dtype}")
    if not a.is_contiguous():
        raise ValueError("int_to_f32_cuda needs a contiguous tensor")
    if not MIN_N <= n <= MAX_N:
        raise ValueError("Algorithm 1 requires 2 <= n <= 25")
    if a.device.type != "cuda":
        raise ValueError(f"int_to_f32_cuda takes a CUDA tensor, got one on "
                         f"{a.device}")
    off = out_offset(a.data_ptr())
    out = torch.empty(a.numel() + off, dtype=torch.float32,
                      device=a.device)[off:].view(a.shape)
    if a.numel() == 0:
        return out
    index = a.device.index if a.device.index is not None \
        else torch.cuda.current_device()
    blocks = grid(a.numel(), *_card(index, n))
    fn = _fn()
    stream = torch.cuda.current_stream(a.device).cuda_stream
    _build.launches["int_to_f32"] += 1
    _build.check(fn(a.data_ptr(), out.data_ptr(), a.numel(), n, blocks,
                    stream), "int_to_f32")
    return out
