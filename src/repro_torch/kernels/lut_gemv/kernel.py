"""Launch wrapper for the CUDA LUT-GEMV (``csrc/lut_gemv.cu``).

Replaces ``lut_matmul_pallas`` (``src/repro/kernels/lut_gemv/kernel.py:138``)
and ``lut_matmul_int_pallas`` (``kernel.py:174``).  The kernel tiles and
masks the ragged M/N edges itself, so nothing is padded here (the TPU's
``pick_blocks`` / VMEM sizing has no counterpart).

``plan`` is the launch plan as a pure function of the shapes and the
card: how the K-slabs split across the blocks of a thread-block cluster,
the grid and the shared memory.  The wrapper checks the shapes and the
tensors before it looks at the device, so a shape the kernel cannot take
raises ``ValueError`` before any launch; on the card it plans with the
card's SM count and the kernel's occupancy as the CUDA runtime reports
them.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import torch

from repro_torch.core.quant import KERNEL_BITS, SUPPORTED_ABITS, QTensor, \
    words_per_group
from repro_torch.kernels import _build

# The kernel's tile constants, as ``csrc/lut_gemv.cu`` defines them (a CPU
# test holds the two in step).
MT = 8               # rows of x per block
BN = 128             # output columns per block
WARPS = 4            # warps per block; each streams its own slabs
SLAB = 32            # K-elements per slab
NSTAGE = 4           # shared-memory stages per warp
MAX_SPLITS = 16      # a tile's splits form one thread-block cluster
MAX_GROUP = 256      # the reference kernel's bound on G (its kernel.py:20)
MAX_GRID_YZ = 65535
# The card the CPU plans for (an H100 SXM); on the card the wrapper reads
# both from the CUDA runtime.
SMS = 132            # streaming multiprocessors
SM_SMEM = 228 << 10  # shared memory of one SM
TARGET_PER_SM = 2    # blocks per SM a decode call aims for
TARGET_BLOCKS = TARGET_PER_SM * SMS


def smem_bytes(bits: int) -> int:
    """Dynamic shared memory of one block (``smem_bytes<BITS>`` in the .cu):
    every warp's ring of stages — packed rows [bits, BN], a scale row [BN]
    and an x slice [SLAB, MT].  The codebook is static shared memory."""
    stage = bits * BN + BN + SLAB * MT
    return 4 * WARPS * NSTAGE * stage


def resident_blocks(bits: int, abits: int = 0, regs: int = 128) -> int:
    """Blocks an SM holds at once, as the CPU models it: by shared memory
    (the rings, the static codebook and x table, 1 KB the card reserves
    per block), by the 64K registers (``regs`` per thread, allocated per
    warp in units of 256) and by the SM's 2048 threads.  The CPU plans
    with 128 registers, the most any instance uses; a card test holds the
    model, with the instance's own count, against the runtime's
    occupancy."""
    static = 4 * (1 << bits) + 4 * (1 << abits if abits else 1)
    by_smem = SM_SMEM // (smem_bytes(bits) + static + 1024)
    by_regs = 65536 // (-(-regs * 32 // 256) * 256) // WARPS
    return max(1, min(by_smem, by_regs, 2048 // (32 * WARPS)))


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut.  A slab is 32 K-elements of one group
    (``bits`` packed rows); split ``s`` of every output tile holds slabs
    ``[s * slab_base + min(s, slab_rem), ...)``, ``slab_base + (s <
    slab_rem)`` of them, and its warp ``w`` a contiguous share of those
    (``warp_share``)."""
    m: int
    k: int
    n: int
    slabs_per_group: int     # ceil(G / 32)
    slabs: int               # (K / G) * slabs_per_group
    col_tiles: int
    row_tiles: int
    splits: int
    slab_base: int
    slab_rem: int
    chunk: int               # outputs of a tile each split sums
    magic: int               # ceil(2**32 / slabs_per_group)
    smem: int

    @property
    def tiles(self) -> int:
        return self.col_tiles * self.row_tiles

    @property
    def blocks(self) -> int:
        return self.tiles * self.splits

    def split_slabs(self, s: int):
        """(first slab, count) of split ``s``, as the kernel computes it."""
        return (s * self.slab_base + min(s, self.slab_rem),
                self.slab_base + (1 if s < self.slab_rem else 0))

    def group_of(self, j: int) -> int:
        """The group of slab ``j`` by the kernel's multiply-shift."""
        return (j * self.magic) >> 32


def warp_share(count: int, w: int):
    """(offset, count) of warp ``w``'s slabs among a block's ``count``."""
    q, r = count >> 2, count & 3
    return w * q + min(w, r), q + (1 if w < r else 0)


def check_shape(m: int, k: int, group: int, bits: int) -> None:
    """Raise ``ValueError`` for a shape the kernel cannot take."""
    if bits not in KERNEL_BITS:
        raise ValueError(f"bits={bits} not in {KERNEL_BITS}")
    if not 1 <= group <= MAX_GROUP or k % group:
        raise ValueError(f"group_size={group} must divide K={k} and be in "
                         f"[1, {MAX_GROUP}]")
    if -(-m // MT) > MAX_GRID_YZ:
        raise ValueError(f"M={m} needs {-(-m // MT)} row tiles, more than "
                         f"the grid's {MAX_GRID_YZ}")
    if (k // group) * -(-group // SLAB) >= 1 << 24:
        raise ValueError(f"K={k}: more slabs than the kernel's slab-to-group "
                         f"map covers")


def with_splits(p: Plan, splits: int) -> Plan:
    """``p`` with its slabs cut into ``splits`` balanced splits."""
    return dataclasses.replace(
        p, splits=splits, slab_base=p.slabs // splits,
        slab_rem=p.slabs % splits, chunk=-(-MT * BN // splits))


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, group: int, bits: int, sms: int = SMS,
         resident: Optional[int] = None) -> Plan:
    """The launch plan for y[m, n] = x[m, k] @ W on a card of ``sms`` SMs
    that each hold ``resident`` blocks of the kernel at once (by default
    the CPU's model of an H100, ``resident_blocks(bits)``); raises
    ``ValueError`` for a shape the kernel cannot take.

    Splits: the fewest that give the call ``TARGET_PER_SM`` blocks per SM,
    but no more than one wave of resident blocks holds (on the H100 a
    second, partial wave made lm_head slower than one split), no more than
    a cluster holds (``MAX_SPLITS``) and no more than one per slab."""
    check_shape(m, k, group, bits)
    if resident is None:
        resident = resident_blocks(bits)
    spg = -(-group // SLAB)
    slabs = (k // group) * spg
    col_tiles, row_tiles = -(-n // BN), -(-m // MT)
    tiles = max(col_tiles * row_tiles, 1)
    splits = max(1, min(-(-TARGET_PER_SM * sms // tiles),
                        resident * sms // tiles, MAX_SPLITS, slabs))
    p = Plan(m=m, k=k, n=n, slabs_per_group=spg, slabs=slabs,
             col_tiles=col_tiles, row_tiles=row_tiles, splits=1,
             slab_base=slabs, slab_rem=0, chunk=MT * BN,
             magic=-(-(1 << 32) // spg), smem=smem_bytes(bits))
    return with_splits(p, splits)


@functools.cache
def _fn():
    """The C entry point with its signature declared (once)."""
    fn = _build.load("lut_gemv").repro_lut_matmul
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
                   + [ctypes.c_ulonglong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def occupancy(bits: int, abits: int):
    """(blocks of the (bits, abits) instance one SM of the current card
    holds at once, its dynamic shared memory in bytes, its registers per
    thread), as the CUDA runtime reports them."""
    fn = _build.load("lut_gemv").repro_lut_matmul_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    smem, regs = ctypes.c_int(0), ctypes.c_int(0)
    blocks = fn(bits, abits, ctypes.byref(smem), ctypes.byref(regs))
    if blocks < 0:
        _build.check(-blocks, "lut_matmul occupancy")
    return blocks, smem.value, regs.value


@functools.cache
def _card(index: int, bits: int, abits: int):
    """(SM count, resident blocks of the instance) of CUDA device
    ``index``: the plan's card."""
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        return sms, occupancy(bits, abits)[0]


def _card_plan(m: int, k: int, qt: QTensor, abits: int, device) -> Plan:
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return plan(m, k, qt.n, qt.group_size, qt.bits,
                *_card(index, qt.bits, abits))


def _check_weight(qt: QTensor, k: int, device) -> None:
    if qt.k != k:
        raise ValueError(f"x has K={k}, weight has K={qt.k}")
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


def _launch(x, xq, xs, qt: QTensor, p: Plan, abits: int,
            device) -> torch.Tensor:
    y = torch.empty((p.m, p.n), dtype=torch.float32, device=device)
    fn = _fn()
    stream = torch.cuda.current_stream(device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    name = "lut_matmul_int" if abits else "lut_matmul"
    _build.launches[name] += 1
    key = (qt.bits, abits)
    _build.lut_instances[key] = _build.lut_instances.get(key, 0) + 1
    _build.check(fn(ptr(x), ptr(xq), ptr(xs), qt.packed.data_ptr(),
                    qt.scales.data_ptr(), qt.codebook.data_ptr(),
                    y.data_ptr(), p.m, p.k, p.n,
                    qt.group_size, words_per_group(qt.bits, qt.group_size),
                    qt.bits, abits, p.splits, p.slab_base, p.slab_rem,
                    p.slabs_per_group, p.chunk, p.magic, stream), name)
    return y


def lut_matmul_cuda(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y[M, N] = x[M, K] @ dequant(qt) on the card; x f32 contiguous."""
    if x.dtype != torch.float32 or x.ndim != 2:
        raise ValueError(f"lut_matmul_cuda takes f32 [M, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    m, k = x.shape
    check_shape(m, k, qt.group_size, qt.bits)
    _check_weight(qt, k, x.device)
    if x.device.type != "cuda":
        raise ValueError(f"lut_matmul_cuda takes tensors on CUDA, got "
                         f"{x.device}")
    if not x.is_contiguous():
        raise ValueError("lut_matmul_cuda needs a contiguous x")
    return _launch(x, None, None, qt, _card_plan(m, k, qt, 0, x.device), 0,
                   x.device)


def lut_matmul_int_cuda(x_q: torch.Tensor, x_scale: torch.Tensor,
                        qt: QTensor, abits: Optional[int]) -> torch.Tensor:
    """y = (x_q @ dequant(qt)) * x_scale on the card; x_q int32 [M, K]
    ``abits``-bit codes widened in-kernel by Algorithm 1, x_scale f32
    [M, 1]."""
    if abits not in SUPPORTED_ABITS:
        raise ValueError(f"abits={abits} not in {SUPPORTED_ABITS}")
    if x_q.dtype != torch.int32 or x_q.ndim != 2:
        raise ValueError(f"lut_matmul_int_cuda takes int32 [M, K], got "
                         f"{x_q.dtype} {tuple(x_q.shape)}")
    m, k = x_q.shape
    check_shape(m, k, qt.group_size, qt.bits)
    if (x_scale.device != x_q.device or x_scale.dtype != torch.float32
            or tuple(x_scale.shape) != (m, 1)):
        raise ValueError(f"x_scale must be f32 [{m}, 1] on {x_q.device}")
    _check_weight(qt, k, x_q.device)
    if x_q.device.type != "cuda":
        raise ValueError(f"lut_matmul_int_cuda takes tensors on CUDA, got "
                         f"{x_q.device}")
    if not (x_q.is_contiguous() and x_scale.is_contiguous()):
        raise ValueError("lut_matmul_int_cuda needs contiguous inputs")
    return _launch(None, x_q, x_scale, qt,
                   _card_plan(m, k, qt, abits, x_q.device), abits,
                   x_q.device)
