"""Launch wrapper for the CUDA decode attention (``csrc/decode_attn.cu``).

Replaces ``decode_attention_pallas``
(``src/repro/kernels/decode_attn/kernel.py:79``) in its ``lengths`` mode,
and the reference decode step's jnp ``_decode_attend``
(``src/repro/models/blocks.py:236``) in its ring mode.  The kernel masks
the ragged S edge itself, so nothing is padded.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

MAX_GD = 1024        # (H / KV) * D accumulators spread over 128 threads
TB = 128             # positions per chunk and threads per block (the .cu)
MAX_SMEM = 48 << 10  # dynamic shared memory a launch gets without opting in


def smem_bytes(g: int, d: int) -> int:
    """Dynamic shared memory of one block: the group's queries [G, D], the
    chunk's scores [G, TB] and the running max, sum and rescale [3, G]."""
    return 4 * (g * d + g * TB + 3 * g)


@functools.cache
def _fn():
    """The C entry point with its signature declared (once)."""
    fn = _build.load("decode_attn").repro_decode_attention
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor,
                          k_scale: Optional[torch.Tensor],
                          v_scale: Optional[torch.Tensor],
                          window: Optional[int], ring: bool) -> torch.Tensor:
    """q f32 [B, H, D]; k, v [B, S, KV, D] int8 (with f32 scales
    [B, S, KV, 1]) or f32; lens int32 [B] — lengths, or absolute positions
    when ``ring``.  Returns f32 [B, H, D]."""
    dev = q.device
    if q.dtype != torch.float32 or q.ndim != 3:
        raise ValueError(f"q must be f32 [B, H, D], got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, h, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k must be [B, S, KV, D] matching q, got "
                         f"{tuple(k.shape)}")
    s, kv = k.shape[1], k.shape[2]
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError("k and v must share shape and dtype")
    if h % kv or (h // kv) * d > MAX_GD:
        raise ValueError(f"H={h}, KV={kv}, D={d}: need H % KV == 0 and "
                         f"(H/KV)*D <= {MAX_GD}")
    if smem_bytes(h // kv, d) > MAX_SMEM:
        raise ValueError(f"G={h // kv}, D={d}: a block needs "
                         f"{smem_bytes(h // kv, d)} bytes of shared memory, "
                         f"more than the {MAX_SMEM} a launch gets")
    quantized = k_scale is not None
    if quantized:
        if k.dtype != torch.int8 or v_scale is None:
            raise ValueError("scaled K/V must be int8 with both scales")
        for sc in (k_scale, v_scale):
            if (sc.dtype != torch.float32 or tuple(sc.shape) != (b, s, kv, 1)
                    or sc.device != dev or not sc.is_contiguous()):
                raise ValueError(f"K/V scales must be contiguous f32 "
                                 f"[{b}, {s}, {kv}, 1] on {dev}")
    elif k.dtype != torch.float32:
        raise ValueError(f"unscaled K/V must be f32, got {k.dtype}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (b,):
        raise ValueError(f"lens must be int32 [{b}]")
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"device {dev}")
    for t in (q, k, v, lens):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("decode_attention_cuda needs contiguous "
                             "tensors on one CUDA device")
    if ring and (window is None or window <= 0):
        raise ValueError("ring mode needs the effective window (> 0)")
    out = torch.empty((b, h, d), dtype=torch.float32, device=dev)
    fn = _fn()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    _build.launches["decode_attention"] += 1
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale),
                    ptr(v_scale), lens.data_ptr(), out.data_ptr(), b, h, kv,
                    s, d, 0 if window is None else int(window),
                    int(quantized), int(ring), stream), "decode_attention")
    return out
