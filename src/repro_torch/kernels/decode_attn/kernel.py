"""Launch wrapper for the CUDA decode attention (``csrc/decode_attn.cu``).

Replaces ``decode_attention_pallas``
(``src/repro/kernels/decode_attn/kernel.py:79``) in its ``lengths`` mode,
the reference decode step's jnp ``_decode_attend``
(``src/repro/models/blocks.py:236``) in its ring mode, and in its table
mode the paged decode step's gather of a lane's blocks followed by
``_decode_attend`` (``src/repro/models/blocks.py:191-216``): ring validity
over a block pool read through each lane's block table in place.  The
kernel masks the ragged edges itself, so nothing is padded.

``plan`` is the launch plan as a pure function of the shapes and the card:
the lane layout of a row, the bytes of one staging copy (16, 8, or 4 for
the int8 rows of a narrow head, D 12 or 20, which are only 4-byte
aligned), the rows of one shared-memory stage, the shared memory, and how
many splits of S (a thread-block cluster) each (sequence, kv head) gets.
The functions below it are the kernel's index arithmetic written out in
Python (the valid range of a sequence, the rows of a split and of a warp),
so that the CPU tests can check it.  The wrapper
checks the shapes and the tensors before it looks at the device, so a shape
the kernel cannot take raises ``ValueError`` before any launch; on the card
it plans with the clusters of the instance the CUDA runtime says the card
holds at once.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

# The kernel's constants, as ``csrc/decode_attn.cu`` defines them (a CPU
# test holds the two in step).
WARPS = 16           # warps per block; each streams its own rows
WARPS_G16 = 8        # warps per block for G > 8 (their registers)
NSTAGE = 4           # shared-memory stages per warp
MAX_TW = 32          # rows per stage
MAX_SPLITS = 16      # a (sequence, kv head)'s splits form one cluster
MAX_G = 16           # query heads per kv head
MAX_D = 128          # head width, a multiple of 4
MAX_E = 16           # row elements per lane, int8 K/V
MAX_E_F32 = 8        # row elements per lane, f32 K/V
MIN_E = 4
LANE_REGS = 32       # q-slice registers per lane: G rounded up times E
MAX_SMEM = 163840    # dynamic shared memory a plan may ask for
# The plan's own choices.
STAGE_BYTES = 2048   # a stage holds the most rows that fit in this (>= a pass)
MIN_SPLIT_ROWS = 512  # no more splits than leave each this many valid rows
MAX_GRID_YZ = 65535
# The card the CPU plans for (an H100 SXM); on the card the wrapper asks
# the CUDA runtime how many clusters it holds at once.
SM_SMEM = 228 << 10  # shared memory of one SM
MODEL_REGS = 128     # registers per thread the CPU models (every instance to G = 8)
# clusters of 1, 2, 4, 8, 16 blocks an H100 SXM holds at once at one block
# per SM, as the CUDA runtime reported them (PERF.md)
H100_CLUSTERS = (132, 66, 30, 15, 7)


def _pow2ceil(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _pow2floor(x: int) -> int:
    return 1 << (max(1, x).bit_length() - 1)


def warps_of(gm: int) -> int:
    """Warps per block of the instance (``warps_of<GM>`` in the .cu)."""
    return WARPS_G16 if gm > 8 else WARPS


def lane_elems(gm: int, quantized: bool) -> int:
    """Row elements one lane holds (``lane_elems<GM, QUANT>`` in the
    .cu)."""
    return min(MAX_E if quantized else MAX_E_F32, max(MIN_E, LANE_REGS // gm))


def check_shape(b: int, h: int, kv: int, d: int, s: int) -> None:
    """Raise ``ValueError`` for a shape the kernel cannot take."""
    if kv < 1 or h % kv:
        raise ValueError(f"H={h}, KV={kv}: need H % KV == 0")
    if not 1 <= h // kv <= MAX_G:
        raise ValueError(f"G = H/KV = {h // kv}: the kernel takes 1 to {MAX_G} "
                         f"query heads per kv head")
    if d % 4 or not 4 <= d <= MAX_D:
        raise ValueError(f"D={d}: the kernel takes head widths that are a "
                         f"multiple of 4 up to {MAX_D}")
    if not 1 <= s < 1 << 30:
        raise ValueError(f"S={s}: the kernel takes 1 <= S < 2^30 cache slots")
    if kv > MAX_GRID_YZ or b > MAX_GRID_YZ:
        raise ValueError(f"B={b}, KV={kv}: more than the grid's {MAX_GRID_YZ}")


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call is cut.  A row of D elements is read by ``lanes``
    lanes of ``elems`` elements each (zero-padded to ``padded_row`` bytes
    in shared memory), so a warp takes ``rows_per_pass`` rows at once; a
    stage holds ``tw`` rows of K and V and their scale pairs.  The valid
    rows of each (sequence, kv head) are cut into ``splits`` chunks
    (``split_rows``), one block each, and a chunk into the block's warps
    (``warp_share``).  A row is staged by ``copies`` copies of
    ``copy_bytes`` each, the last ones zero-filled past the row."""
    b: int
    kv: int
    g: int
    d: int
    s: int
    quantized: bool
    gm: int                  # G rounded up to a power of two (the instance)
    elems: int
    lanes: int
    tw: int
    padded_row: int          # bytes
    stage_bytes: int
    smem: int
    nmax: int                # the most valid rows a sequence can have
    splits: int
    copy_bytes: int          # bytes per staging copy: 16, 8 or 4

    @property
    def copies(self) -> int:
        """Copies per padded row (a power of two)."""
        return self.padded_row // self.copy_bytes

    @property
    def warps(self) -> int:
        return warps_of(self.gm)

    @property
    def rows_per_pass(self) -> int:
        return 32 // self.lanes

    @property
    def blocks(self) -> int:
        return self.b * self.kv * self.splits

    @property
    def lg_splits(self) -> int:
        return self.splits.bit_length() - 1


def copy_bytes(d: int, quantized: bool) -> int:
    """Bytes per staging copy of a K/V row: the largest of 16, 8 and 4 that
    divides the row's bytes (f32 rows at D % 4 = 0 always take 16; int8
    rows of a narrow head, D % 8 != 0, take 4)."""
    row = d * (1 if quantized else 4)
    return next(c for c in (16, 8, 4) if row % c == 0)


def tiles(g: int, d: int, quantized: bool) -> Tuple[int, int, int, int, int,
                                                    int, int]:
    """(gm, elems, lanes, tw, padded row bytes, stage bytes, shared memory)
    of one block: its warps' rings of NSTAGE stages, or the space the
    combine of the warps' and the block's partials needs, whichever is
    larger."""
    gm = _pow2ceil(g)
    elems = lane_elems(gm, quantized)
    lanes = _pow2ceil(-(-d // elems))
    padded = lanes * elems * (1 if quantized else 4)
    per_row = 2 * padded + (8 if quantized else 0)
    tw = min(MAX_TW, max(32 // lanes, _pow2floor(STAGE_BYTES // per_row)))
    stage = tw * per_row
    warps = warps_of(gm)
    combine = 4 * (warps + 1) * gm * (lanes * elems + 2)
    return gm, elems, lanes, tw, padded, stage, max(warps * NSTAGE * stage,
                                                    combine)


def resident_blocks(smem: int, warps: int, regs: int = MODEL_REGS) -> int:
    """Blocks an SM holds at once, as the CPU models it: by shared memory
    (1 KB of it reserved per block), by the 64K registers (``regs`` per
    thread, allocated per warp in units of 256) and by the SM's 2048
    threads.  A card test holds the model, with the instance's own register
    count, against the runtime's occupancy."""
    by_smem = SM_SMEM // (smem + 1024)
    by_regs = 65536 // (-(-regs * 32 // 256) * 256) // warps
    return max(1, min(by_smem, by_regs, 2048 // (32 * warps)))


def with_splits(p: Plan, splits: int) -> Plan:
    """``p`` with each sequence's rows cut into ``splits`` (a power of two
    up to ``MAX_SPLITS``)."""
    if splits < 1 or splits > MAX_SPLITS or splits & (splits - 1):
        raise ValueError(f"splits={splits}: a power of two up to "
                         f"{MAX_SPLITS}")
    return dataclasses.replace(p, splits=splits)


def model_clusters(resident: int) -> Tuple[int, ...]:
    """Clusters of 1, 2, 4, 8 and 16 blocks an H100 SXM holds at once, as
    the CPU models it: ``resident`` times what it holds at one block per SM
    (``H100_CLUSTERS``; a cluster's blocks share one GPC, so large clusters
    leave SMs over).  On the card the wrapper asks the runtime."""
    return tuple(resident * c for c in H100_CLUSTERS)


@functools.lru_cache(maxsize=4096)
def plan(b: int, h: int, kv: int, d: int, s: int, window: Optional[int],
         ring: bool, quantized: bool,
         clusters: Optional[Tuple[int, ...]] = None) -> Plan:
    """The launch plan for one call on a card that holds ``clusters[i]``
    clusters of 2^i blocks of the instance at once (by default the CPU's
    model of an H100); raises ``ValueError`` for a shape the kernel cannot
    take.

    Splits: a power of two (the chunk of a split is a shift), the most that
    keep the grid in one wave: every (sequence, kv head)'s cluster resident
    at once.  No more than ``MAX_SPLITS`` (a cluster), than leave
    ``MIN_SPLIT_ROWS`` rows to each split of the longest valid range the
    shapes allow, or than the outputs a cluster's blocks share out."""
    check_shape(b, h, kv, d, s)
    g = h // kv
    gm, elems, lanes, tw, padded, stage, smem = tiles(g, d, quantized)
    if clusters is None:
        clusters = model_clusters(resident_blocks(smem, warps_of(gm)))
    nmax = min(s, window) if window is not None and window > 0 else s
    cap = min(MAX_SPLITS, _pow2ceil(-(-nmax // MIN_SPLIT_ROWS)),
              gm * lanes * elems)
    splits = 1
    while splits * 2 <= cap and b * kv <= clusters[splits.bit_length()]:
        splits *= 2
    return Plan(b=b, kv=kv, g=g, d=d, s=s, quantized=quantized, gm=gm,
                elems=elems, lanes=lanes, tw=tw, padded_row=padded,
                stage_bytes=stage, smem=smem, nmax=nmax, splits=splits,
                copy_bytes=copy_bytes(d, quantized))


# --- the kernel's index arithmetic, written out --------------------------

def s_magic(s: int) -> int:
    """floor((2^32 - 1) / S): the kernel's reciprocal of S."""
    return (2 ** 32 - 1) // s


def mod_s(p: int, s: int) -> int:
    """p mod S as the kernel takes it: a multiply-high by ``s_magic`` gives
    the quotient or one less, and one compare corrects it."""
    quot = (p * s_magic(s)) >> 32
    r = p - quot * s
    return r - s if r >= s else r


def valid_range(length: int, s: int, window: Optional[int],
                ring: bool) -> Tuple[int, int]:
    """(n, start) of a sequence (``valid_range`` in the .cu): its n valid
    slots are ``start, start + 1, ...`` taken mod S.  Lengths mode: slots
    ``[max(0, L - w), min(L, S))``; ring mode (``length`` is the absolute
    position p): the ``min(p + 1, w, S)`` newest slots, ending at p mod
    S."""
    w = 0 if window is None else window
    if ring:
        if length < 0:
            return 0, 0
        n = min(length, min(w, s) - 1) + 1
        start = mod_s(length, s) - n + 1
        return n, start + s if start < 0 else start
    hi = min(length, s)
    lo = max(0, length - w) if w > 0 else 0
    return (hi - lo, lo) if hi > lo else (0, 0)


def slot_of(start: int, j: int, s: int) -> int:
    """The slot of logical row j (``row_of`` in the .cu)."""
    slot = start + j
    return slot - s if slot >= s else slot


def bs_magic(bs: int) -> int:
    """floor((2^32 - 1) / BS): the kernel's reciprocal of the block size."""
    return (2 ** 32 - 1) // bs


def table_row(table, slot: int, bs: int) -> int:
    """Table mode's pool row of ``slot`` for a lane whose block table is
    ``table`` (``row_of`` in the .cu, before the kv head): the block
    ``slot / BS`` by a multiply-high that is exact or one low, corrected by
    one compare."""
    blk = (slot * bs_magic(bs)) >> 32
    off = slot - blk * bs
    if off >= bs:
        off, blk = off - bs, blk + 1
    return int(table[blk]) * bs + off


def split_rows(n: int, splits: int, split: int) -> Tuple[int, int]:
    """(first row, count) of split ``split`` of n valid rows."""
    lg = splits.bit_length() - 1
    chunk = (n + splits - 1) >> lg
    first = split * chunk
    return first, max(0, min(chunk, n - first))


def warp_share(count: int, w: int, warps: int) -> Tuple[int, int]:
    """(offset, count) of warp ``w``'s rows among a block's ``count``,
    shared by ``warps`` warps."""
    lg = warps.bit_length() - 1
    q, r = count >> lg, count & (warps - 1)
    return w * q + min(w, r), q + (1 if w < r else 0)


# --- the launch ------------------------------------------------------------

@functools.cache
def _fn():
    """The C entry point with its signature declared (once)."""
    fn = _build.load("decode_attn").repro_decode_attention
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 18
                   + [ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def occupancy(gm: int, quantized: bool, smem: int):
    """(blocks of the (gm, quantized) instance one SM of the current card
    holds at once with ``smem`` bytes of dynamic shared memory, its
    registers per thread), as the CUDA runtime reports them."""
    fn = _build.load("decode_attn").repro_decode_attention_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    regs = ctypes.c_int(0)
    blocks = fn(gm, int(quantized), smem, ctypes.byref(regs))
    if blocks < 0:
        _build.check(-blocks, "decode_attention occupancy")
    return blocks, regs.value


def max_clusters(gm: int, quantized: bool, splits: int, smem: int) -> int:
    """Clusters of ``splits`` blocks of the instance the current card holds
    at once, as the CUDA runtime reports them."""
    fn = _build.load("decode_attn").repro_decode_attention_clusters
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    n = fn(gm, int(quantized), splits, smem)
    if n < 0:
        _build.check(-n, "decode_attention clusters")
    return n


@functools.cache
def _card(index: int, gm: int, quantized: bool, smem: int):
    """Clusters of 1, 2, ... 16 blocks of the instance CUDA device
    ``index`` holds at once: the plan's card."""
    with torch.cuda.device(index):
        return tuple(max_clusters(gm, quantized, 1 << lg, smem)
                     for lg in range(MAX_SPLITS.bit_length()))


def card_plan(b: int, h: int, kv: int, d: int, s: int, window: Optional[int],
              ring: bool, quantized: bool, device) -> Plan:
    """``plan`` with the clusters the card holds at once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    g = h // kv
    gm, _, _, _, _, _, smem = tiles(g, d, quantized)
    return plan(b, h, kv, d, s, window, ring, quantized,
                _card(index, gm, quantized, smem))


def _check(q, k, v, lens, k_scale, v_scale, window, ring, tables=None):
    """Shapes, types and layout; returns (b, h, kv, d, s).  Table mode
    (``tables`` given): k, v are a block pool [NB, BS, KV, D], tables an
    int32 [B, mbs] on q's device, S = mbs * BS; its entries are not read
    back (the engine keeps them in [0, NB))."""
    if q.dtype != torch.float32 or q.ndim != 3:
        raise ValueError(f"q must be f32 [B, H, D], got {q.dtype} "
                         f"{tuple(q.shape)}")
    b, h, d = q.shape
    dev = q.device
    if tables is None:
        if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d:
            raise ValueError(f"k must be [B, S, KV, D] matching q, got "
                             f"{tuple(k.shape)}")
        s, kv = k.shape[1], k.shape[2]
    else:
        if k.ndim != 4 or k.shape[0] < 1 or k.shape[1] < 1 \
                or k.shape[3] != d:
            raise ValueError(f"table mode: k must be a block pool "
                             f"[NB, BS, KV, D] matching q, got "
                             f"{tuple(k.shape)}")
        if (tables.dtype != torch.int32 or tables.ndim != 2
                or tables.shape[0] != b or tables.shape[1] < 1
                or not tables.is_contiguous() or tables.device != dev):
            raise ValueError(f"table mode: tables must be a contiguous int32 "
                             f"[{b}, mbs] on {dev}, got {tables.dtype} "
                             f"{tuple(tables.shape)} on {tables.device}")
        if not ring:
            raise ValueError("table mode takes ring validity (ring=True)")
        s, kv = tables.shape[1] * k.shape[1], k.shape[2]
    rows = tuple(k.shape[:2])
    if v.shape != k.shape or v.dtype != k.dtype:
        raise ValueError("k and v must share shape and dtype")
    check_shape(b, h, kv, d, s)
    if k_scale is not None:
        if k.dtype != torch.int8 or v_scale is None:
            raise ValueError("scaled K/V must be int8 with both scales")
        for sc in (k_scale, v_scale):
            if (sc.dtype != torch.float32 or tuple(sc.shape) != rows + (kv, 1)
                    or sc.device != dev or not sc.is_contiguous()):
                raise ValueError(f"K/V scales must be contiguous f32 "
                                 f"{list(rows + (kv, 1))} on {dev}")
    elif k.dtype != torch.float32:
        raise ValueError(f"unscaled K/V must be f32, got {k.dtype}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (b,):
        raise ValueError(f"lens must be int32 [{b}]")
    if ring and (window is None or window <= 0):
        raise ValueError("ring mode needs the effective window (> 0)")
    return b, h, kv, d, s


def decode_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          lens: torch.Tensor,
                          k_scale: Optional[torch.Tensor],
                          v_scale: Optional[torch.Tensor],
                          window: Optional[int], ring: bool,
                          tables: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Three modes; q f32 [B, H, D] and the output f32 [B, H, D] in each.

    * lengths (``ring=False``): k, v [B, S, KV, D] int8 (with f32 scales
      [B, S, KV, 1]) or f32; lens int32 [B] the valid lengths; ``window``
      the last ``window`` positions only (None: all);
    * ring (``ring=True``): the same cache as a ring; lens int32 [B] the
      absolute positions; ``window`` the effective window (the model's,
      else the ring size);
    * table (``ring=True`` and ``tables``): k, v a block pool
      [NB, BS, KV, D] (scales [NB, BS, KV, 1]), ``tables`` int32 [B, mbs]
      each lane's physical blocks, every entry in [0, NB); ring validity
      over the lane's logical view of S = mbs * BS slots.

    Shapes, types and layout are checked (``ValueError``) before the
    device; table entries are not read back (a sync)."""
    b, h, kv, d, s = _check(q, k, v, lens, k_scale, v_scale, window, ring,
                            tables)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got "
                         f"device {dev}")
    for t in (q, k, v, lens) + (() if tables is None else (tables,)):
        if t.device != dev or not t.is_contiguous():
            raise ValueError("decode_attention_cuda needs contiguous "
                             "tensors on one CUDA device")
    if q.data_ptr() % 16 or k.data_ptr() % 4 or v.data_ptr() % 4:
        raise ValueError("decode_attention_cuda needs q 16-byte aligned and "
                         "K/V 4-byte aligned")
    p = card_plan(b, h, kv, d, s, window, ring, k_scale is not None, dev)
    return _launch(q, k, v, lens, k_scale, v_scale, window, ring, p, tables)


def _launch(q, k, v, lens, k_scale, v_scale, window, ring, p: Plan,
            tables=None) -> torch.Tensor:
    """One launch of checked tensors under plan ``p``; table mode counts in
    ``launches["decode_attention_table"]`` as well as in the total."""
    b, h, d = q.shape
    # the plan's copies, narrower where K or V starts off their alignment
    cb = p.copy_bytes
    while k.data_ptr() % cb or v.data_ptr() % cb:
        cb //= 2
    lg_cpr = (p.padded_row // cb).bit_length() - 1
    out = torch.empty((b, h, d), dtype=torch.float32, device=q.device)
    fn = _fn()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptr = lambda t: None if t is None else t.data_ptr()
    bs = 1 if tables is None else k.shape[1]
    _build.launches["decode_attention"] += 1
    if tables is not None:
        _build.launches["decode_attention_table"] += 1
    _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale),
                    ptr(v_scale), lens.data_ptr(), ptr(tables),
                    out.data_ptr(), b, h, p.kv, p.s, d,
                    0 if window is None else int(window), int(p.quantized),
                    int(ring), p.gm, p.lg_splits, p.lanes.bit_length() - 1,
                    p.tw.bit_length() - 1, lg_cpr, cb.bit_length() - 1,
                    p.stage_bytes, p.smem, bs, p.s // bs, s_magic(p.s),
                    bs_magic(bs), math.log2(math.e) / math.sqrt(d), stream),
                 "decode_attention")
    return out
