"""The port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX reference's Pallas kernels in interpret mode
and their jnp oracles, over the reference tests' grids."""
import dataclasses
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import quant as jq
from repro.kernels.decode_attn import ops as jda_ops
from repro.kernels.lut_gemv import ops as jlut_ops
from repro.kernels.lut_gemv import ref as jlut_ref
from repro.models import blocks as jblocks
from repro.models.common import ModelConfig as JModelConfig
from repro_torch.core import quant as tq
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import kernel as tda_kernel
from repro_torch.kernels.decode_attn import ops as tda_ops
from repro_torch.kernels.decode_attn import ref as tda_ref
from repro_torch.kernels.lut_gemv import kernel as tlut_kernel
from repro_torch.kernels.lut_gemv import ops as tlut_ops
from repro_torch.kernels.typeconv import kernel as ttc_kernel
from repro_torch.models import blocks as tblocks
from repro_torch.models.common import ModelConfig as TModelConfig

LUT_TOL = dict(rtol=1e-5, atol=1e-4)      # tests/test_kernels.py:26
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)     # tests/test_kernels.py:80


def _qtensors(w: np.ndarray, bits: int, group: int, abits=None):
    ref = dataclasses.replace(jq.quantize(jnp.asarray(w), bits, group),
                              abits=abits)
    got = dataclasses.replace(tq.quantize(torch.from_numpy(w), bits, group),
                              abits=abits)
    return ref, got


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("mkn", [(8, 256, 128), (3, 130, 70), (16, 512, 384),
                                 (1, 64, 512)])
def test_lut_matmul_matches_pallas_and_oracle(bits, mkn):
    m, k, n = mkn
    gs = 64
    kk = -(-k // gs) * gs
    rng = np.random.default_rng(10 * bits + m)
    w = rng.standard_normal((kk, n)).astype(np.float32)
    x = rng.standard_normal((m, kk)).astype(np.float32)
    ref, got = _qtensors(w, bits, gs)
    y = tlut_ops.lut_matmul(torch.from_numpy(x), got).numpy()
    y_pallas = jlut_ops.lut_matmul(jnp.asarray(x), ref, backend="pallas",
                                   interpret=True)
    np.testing.assert_allclose(y, np.asarray(y_pallas), **LUT_TOL)
    np.testing.assert_allclose(
        y, np.asarray(jlut_ref.lut_matmul_ref(jnp.asarray(x), ref)), **LUT_TOL)


@pytest.mark.parametrize("wbits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("abits", [4, 6, 8, None])
def test_int_path_matches_pallas(wbits, abits):
    """tests/test_int_act_path.py:39-55's grid: the activations are
    quantized per token and the integer-code path runs."""
    m, k, n = 8, 256, 256
    rng = np.random.default_rng(wbits)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref, got = _qtensors(w, wbits, 64, abits)
    y = tlut_ops.lut_matmul(torch.from_numpy(x), got).numpy()
    y_pallas = jlut_ops.lut_matmul(jnp.asarray(x), ref, backend="pallas",
                                   interpret=True)
    assert y.shape == (m, n)
    np.testing.assert_allclose(y, np.asarray(y_pallas), **LUT_TOL)


@pytest.mark.parametrize("wbits", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("abits", [4, 6, 8])
def test_int_path_bit_equal_on_integer_data(wbits, abits):
    """Integer codebook and unit scales make every product and partial sum
    an exact integer, so the port, the Pallas kernel and the oracle must
    agree bit for bit whatever their summation order."""
    m, k, n, gs = 8, 256, 96, 64
    rng = np.random.default_rng(wbits * 10 + abits)
    codes = rng.integers(0, 1 << wbits, size=(k, n))
    book = np.arange(1 << wbits, dtype=np.float32) - (1 << (wbits - 1))
    ones = np.ones((k // gs, n), np.float32)
    ref = jq.QTensor(packed=jq.pack_grouped(jnp.asarray(codes, jnp.uint32),
                                            wbits, gs),
                     scales=jnp.asarray(ones), codebook=jnp.asarray(book),
                     bits=wbits, group_size=gs, k=k, abits=abits)
    got = tq.QTensor(packed=tq.pack_grouped(torch.from_numpy(codes), wbits,
                                            gs),
                     scales=torch.from_numpy(ones),
                     codebook=torch.from_numpy(book), bits=wbits,
                     group_size=gs, k=k, abits=abits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = tlut_ops.lut_matmul(torch.from_numpy(x), got).numpy()
    y_pallas = jlut_ops.lut_matmul(jnp.asarray(x), ref, backend="pallas",
                                   interpret=True)
    np.testing.assert_array_equal(y, np.asarray(y_pallas))
    xq, xs = tq.quantize_activations(torch.from_numpy(x), abits)
    np.testing.assert_array_equal(
        tlut_ops.lut_matmul_quantized(xq, xs, got).numpy(), y)


@pytest.mark.parametrize("abits", [4, 8])
def test_int_path_unaligned_shapes(abits):
    m, k, n = 3, 96, 100
    rng = np.random.default_rng(abits)
    w = rng.standard_normal((k, n)).astype(np.float32)
    x = rng.standard_normal((m, k)).astype(np.float32)
    ref, got = _qtensors(w, 4, 32, abits)
    y = tlut_ops.lut_matmul(torch.from_numpy(x), got).numpy()
    xq, xs = jq.quantize_activations(jnp.asarray(x), abits)
    np.testing.assert_allclose(
        y, np.asarray(jlut_ref.lut_matmul_ref_int(xq, xs, ref)), **LUT_TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 48])
def test_decode_attention_matches_pallas(quantized, window):
    b, h, kv, d, s = 2, 8, 2, 64, 200
    rng = np.random.default_rng(int(quantized) + (window or 0))
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    lengths = np.array([150, 200], np.int32)
    if quantized:
        k, ks = (np.asarray(a) for a in jq.quantize_kv(jnp.asarray(k)))
        v, vs = (np.asarray(a) for a in jq.quantize_kv(jnp.asarray(v)))
    else:
        ks = vs = None
    ref = jda_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs), window=window,
        backend="pallas", bs=64)
    t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    got = tda_ops.decode_attention(t(q), t(k), t(v), t(lengths), t(ks),
                                   t(vs), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **ATTN_TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("window", [None, 48])
def test_ring_attention_matches_decode_attend(quantized, window):
    """Ring mode on a ring that has wrapped (positions past S) holds the
    reference decode step's ``_decode_attend`` validity and values."""
    b, h, kv, d, s = 4, 8, 2, 16, 64
    rng = np.random.default_rng(3 + int(quantized))
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    position = np.array([5, 63, 70, 200], np.int32)
    jcfg = JModelConfig(d_model=h * d, n_heads=h, n_kv=kv, window=window)
    tcfg = TModelConfig(d_model=h * d, n_heads=h, n_kv=kv, window=window)
    if quantized:
        kq, ks = tq.quantize_kv(torch.from_numpy(k))
        vq, vs = tq.quantize_kv(torch.from_numpy(v))
        kf, vf = tq.dequantize_kv(kq, ks).numpy(), tq.dequantize_kv(
            vq, vs).numpy()
        got = tda_ops.decode_attention_ring(
            torch.from_numpy(q[:, 0]), kq, vq, torch.from_numpy(position),
            window or s, ks, vs)
    else:
        kf, vf = k, v
        got = tda_ops.decode_attention_ring(
            torch.from_numpy(q[:, 0]), torch.from_numpy(k),
            torch.from_numpy(v), torch.from_numpy(position), window or s)
    ref = jblocks._decode_attend(jnp.asarray(q), jnp.asarray(kf),
                                 jnp.asarray(vf), jnp.asarray(position), jcfg,
                                 s)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, 0], **ATTN_TOL)
    plain = tblocks._decode_attend(torch.from_numpy(q), torch.from_numpy(kf),
                                   torch.from_numpy(vf),
                                   torch.from_numpy(position), tcfg, s)
    np.testing.assert_allclose(plain.numpy(), np.asarray(ref), **ATTN_TOL)


def test_cpu_calls_launch_nothing_and_other_devices_raise():
    _build.reset_launches()
    x = torch.randn(4, 64)
    qt = tq.quantize(torch.randn(64, 32), 4, 32)
    tlut_ops.lut_matmul(x, qt)
    tlut_ops.lut_matmul(x, dataclasses.replace(qt, abits=8))
    assert all(v == 0 for v in _build.launches.values())
    with pytest.raises(ValueError, match="device"):
        tlut_ops.lut_matmul(torch.empty((4, 64), device="meta"), qt)


# tinymistral_248m's weight matmuls (K, N); blocks per call at M = 8, G = 128
# on the CPU's model of an H100.  The three narrow shapes stay below two
# blocks per SM because a tile's splits form one cluster of at most 16
# blocks; lm_head keeps one split because a second split would need a
# second, partial wave (PERF.md's split sweep times both choices).
TINYMISTRAL_BLOCKS = {(1024, 256): 32, (1024, 1024): 128, (1024, 4096): 288,
                      (4096, 1024): 128, (1024, 32005): 251}


@pytest.mark.parametrize("k, n", sorted(TINYMISTRAL_BLOCKS))
def test_lut_gemv_plan_covers_balances_and_fills(k, n):
    """The launch plan over M in {1, 8, 9, 64}, every G the reference takes
    and every bit width: splits and warps tile the slabs in order, each
    exactly once; splits differ by at most one slab; the kernel's
    multiply-shift maps every slab to its group; a call reaches two blocks
    per SM unless one more split would overflow a cluster, the slabs or one
    wave of resident blocks; shared memory fits."""
    kern = tlut_kernel
    for m in (1, 8, 9, 64):
        for group in (32, 64, 128, 256):
            for bits in tq.KERNEL_BITS:
                p = kern.plan(m, k, n, group, bits)
                seen, counts = [], []
                for s in range(p.splits):
                    first, count = p.split_slabs(s)
                    counts.append(count)
                    for w in range(kern.WARPS):
                        off, c = kern.warp_share(count, w)
                        seen.extend(range(first + off, first + off + c))
                assert seen == list(range(p.slabs))
                assert max(counts) - min(counts) <= 1
                assert p.slabs == (k // group) * -(-group // 32)
                assert [p.group_of(j) for j in range(p.slabs)] == [
                    j // p.slabs_per_group for j in range(p.slabs)]
                assert p.row_tiles == -(-m // 8) and p.col_tiles == -(-n // 128)
                wave = kern.resident_blocks(bits) * kern.SMS
                assert 1 <= p.splits <= kern.MAX_SPLITS
                assert p.blocks <= wave or p.splits == 1
                assert (p.blocks >= kern.TARGET_BLOCKS
                        or p.splits == min(p.slabs, kern.MAX_SPLITS)
                        or (p.splits + 1) * p.tiles > wave)
                assert p.smem + 4 * (1 << bits) <= 227 * 1024
    assert kern.plan(8, k, n, 128, 4).blocks == TINYMISTRAL_BLOCKS[k, n]


def test_lut_gemv_tile_constants_match_the_kernel_source():
    """The plan's tile constants are the ones ``csrc/lut_gemv.cu`` is
    compiled with."""
    src = (_build.CSRC / "lut_gemv.cu").read_text()
    defined = {name: int(value) for name, value in re.findall(
        r"^constexpr int (\w+) = (\d+);", src, re.M)}
    assert {name: defined.get(name) for name in
            ("MT", "BN", "WARPS", "SLAB", "NSTAGE", "MAX_SPLITS")} == {
        "MT": tlut_kernel.MT, "BN": tlut_kernel.BN,
        "WARPS": tlut_kernel.WARPS, "SLAB": tlut_kernel.SLAB,
        "NSTAGE": tlut_kernel.NSTAGE, "MAX_SPLITS": tlut_kernel.MAX_SPLITS}


@pytest.mark.parametrize("m, k, group, bits, fits", [
    (8, 1024, 128, 4, True), (64, 256, 256, 8, True), (3, 96, 48, 5, True),
    (8, 1024, 512, 4, False), (8, 1000, 96, 4, False), (8, 256, 64, 7, False),
    (8 * 65536, 64, 64, 4, False)])
def test_lut_gemv_wrapper_refuses_what_cannot_launch(m, k, group, bits, fits):
    """Shapes the plan refuses (G > 256 or not dividing K, bits the kernel
    has no instance for, more row tiles than the grid holds) raise a
    ValueError before the device check and launch nothing; shapes it takes
    stop only at the device check (these tensors are on ``meta``)."""
    _build.reset_launches()
    n = 40
    rows = (k // group) * (-(-7 * group // 32))
    qt = tq.QTensor(packed=torch.empty((rows, n), dtype=torch.int32,
                                       device="meta"),
                    scales=torch.empty((k // group, n), device="meta"),
                    codebook=torch.empty((1 << bits,), device="meta"),
                    bits=bits, group_size=group, k=k)
    if fits:
        rows = (k // group) * tq.words_per_group(bits, group)
        qt = dataclasses.replace(qt, packed=torch.empty(
            (rows, n), dtype=torch.int32, device="meta"))
    match = "CUDA" if fits else "group_size|bits|grid"
    with pytest.raises(ValueError, match=match):
        tlut_kernel.lut_matmul_cuda(torch.empty((m, k), device="meta"), qt)
    with pytest.raises(ValueError, match=match):
        tlut_kernel.lut_matmul_int_cuda(
            torch.empty((m, k), dtype=torch.int32, device="meta"),
            torch.empty((m, 1), device="meta"), qt, 8)
    assert _build.launches["lut_matmul"] == 0
    assert _build.launches["lut_matmul_int"] == 0


@pytest.mark.parametrize("g, d, fits", [(4, 32, True), (32, 32, False),
                                        (128, 8, False), (9, 128, True),
                                        (16, 120, True), (1, 8, True),
                                        (4, 12, True), (1, 20, True),
                                        (4, 10, False), (17, 64, False),
                                        (4, 136, False)])
def test_decode_attention_wrapper_refuses_what_cannot_launch(g, d, fits):
    """Shapes the kernel has no path for (more than 16 query heads per kv
    head, a head width that is not a multiple of 4 up to 128) raise a
    ValueError before any launch; shapes it takes pass the shape checks and
    stop only at the device check (these tensors are on ``meta``)."""
    _build.reset_launches()
    kv = 2
    q = torch.empty((1, kv * g, d), device="meta")
    k = torch.empty((1, 16, kv, d), device="meta")
    lens = torch.empty((1,), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA" if fits else "G = H/KV|D="):
        tda_kernel.decode_attention_cuda(q, k, k, lens, None, None, None,
                                         ring=False)
    assert _build.launches["decode_attention"] == 0


# (G, D) of every attention config in src/repro/configs at full width;
# xLSTM keeps no KV cache (its D is 256); and the narrow heads of the smoke
# configs (llama2_13b's D 20 at G 1, starcoder2_7b's D 12 at G 3)
CONFIG_HEADS = sorted({(c.n_heads // c.n_kv, c.head_dim)
                       for c in map(jconfigs.get_config, jconfigs.ARCHS)
                       if c.family != "ssm"}
                      | {(g, d) for g in (1, 3) for d in (12, 20)})


def _rows_covered(p, n):
    """The logical rows the plan's splits, warps and stage tiles visit for a
    sequence of n valid rows, in visiting order."""
    seen = []
    for split in range(p.splits):
        first, count = tda_kernel.split_rows(n, p.splits, split)
        for w in range(p.warps):
            off, c = tda_kernel.warp_share(count, w, p.warps)
            for t in range(-(-c // p.tw)):
                j0 = first + off + t * p.tw
                seen.extend(range(j0, j0 + min(p.tw, c - t * p.tw)))
    return seen


@pytest.mark.parametrize("g, d", CONFIG_HEADS)
def test_decode_attention_plan_covers_fits_and_stays_in_a_wave(g, d):
    """Over S in {1, 7, 512, 4096}, both modes and K/V types and three
    batch shapes: the splits, warps and stage tiles visit every valid row
    of a sequence exactly once, in order, for every row count the shapes
    allow (sampled); a row is covered by its lanes, a stage by whole warp
    passes; the shared memory fits; the splits are a power of two no larger
    than a cluster or the outputs its blocks share out, and all clusters
    are resident at once on the CPU's model of an H100."""
    kern = tda_kernel
    for quantized in (True, False):
        for s in (1, 7, 512, 4096):
            for ring, window in ((True, 4096), (True, 100), (False, None),
                                 (False, 64)):
                for b, kv in ((8, 8), (1, 1), (3, 2)):
                    p = kern.plan(b, kv * g, kv, d, s, window, ring,
                                  quantized)
                    assert p.lanes * p.elems >= d and p.lanes <= 32
                    assert p.padded_row == p.lanes * p.elems * (
                        1 if quantized else 4)
                    # whole copies per row, none straddling a row's end
                    row = d * (1 if quantized else 4)
                    assert row % p.copy_bytes == 0
                    assert p.padded_row % p.copy_bytes == 0
                    assert p.copies & (p.copies - 1) == 0
                    assert p.copy_bytes == (4 if quantized and d % 8
                                            else 8 if quantized and d % 16
                                            else 16)
                    assert p.rows_per_pass <= p.tw <= kern.MAX_TW
                    assert p.tw % p.rows_per_pass == 0
                    assert p.stage_bytes % 16 == 0
                    assert kern.NSTAGE * p.warps * p.stage_bytes <= p.smem
                    assert p.smem <= kern.MAX_SMEM
                    assert p.smem + 1024 <= kern.SM_SMEM
                    assert 1 <= p.splits <= kern.MAX_SPLITS
                    assert p.splits & (p.splits - 1) == 0
                    assert p.splits <= p.gm * p.lanes * p.elems
                    resident = kern.resident_blocks(p.smem, p.warps)
                    assert (p.splits == 1 or b * kv <= kern.model_clusters(
                        resident)[p.lg_splits])
                    assert p.nmax == (min(s, window) if window else s)
                    for n in sorted({*range(min(p.nmax, 40) + 1),
                                     p.nmax - 1, p.nmax} - {-1}):
                        assert _rows_covered(p, n) == list(range(n))
    # tinymistral's decode call: one split at the engine's ring of 512
    # slots, two at S = 4096 (64 clusters of 2 at one block per SM)
    assert kern.plan(8, 32, 8, 32, 512, 4096, True, True).blocks == 64
    assert kern.plan(8, 32, 8, 32, 4096, 4096, True, True).blocks == 128


def test_decode_attention_constants_match_the_kernel_source():
    """The plan's constants are the ones ``csrc/decode_attn.cu`` is
    compiled with."""
    src = (_build.CSRC / "decode_attn.cu").read_text()
    defined = {name: int(value) for name, value in re.findall(
        r"^constexpr int (\w+) = (\d+);", src, re.M)}
    names = ("WARPS", "WARPS_G16", "NSTAGE", "MAX_TW", "MAX_SPLITS", "MAX_G",
             "MAX_D", "MAX_E", "MAX_E_F32", "MIN_E", "LANE_REGS", "MAX_SMEM")
    assert {n: defined.get(n) for n in names} == {
        n: getattr(tda_kernel, n) for n in names}


@pytest.mark.parametrize("s", [1, 7, 64, 512])
def test_decode_attention_valid_range_matches_the_masks(s):
    """The kernel's valid range, written out in Python, against the plain
    versions' masks, exhaustively: ring mode for every position in
    [0, 3S) and window in {1, 100, S, 4096} (the slots, and that logical
    row j holds position p - n + 1 + j, oldest first); lengths mode for
    every length in [0, 3S) with no window or those windows.  p mod S by
    the kernel's multiply-high holds for large positions too."""
    kern = tda_kernel
    pos = torch.arange(3 * s, dtype=torch.int32)
    for w in (1, 100, s, 4096):
        want = tda_ref.ring_valid(pos, s, w).numpy()
        for p in range(3 * s):
            n, start = kern.valid_range(p, s, w, ring=True)
            got = np.zeros(s, bool)
            for j in range(n):
                slot = kern.slot_of(start, j, s)
                got[slot] = True
                assert p - (p % s - slot) % s == p - n + 1 + j
            np.testing.assert_array_equal(got, want[p])
    slots = np.arange(s)
    for w in (None, 1, 100, s, 4096):
        for length in range(3 * s):
            n, start = kern.valid_range(length, s, w, ring=False)
            got = np.zeros(s, bool)
            got[[kern.slot_of(start, j, s) for j in range(n)]] = True
            want = slots < length
            if w is not None:
                want &= slots >= length - w
            np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(s)
    for p in [*rng.integers(0, 2 ** 31 - 1, 2000), 2 ** 31 - 1, s - 1, s]:
        assert kern.mod_s(int(p), s) == int(p) % s


def test_kernel_build_needs_nvcc(monkeypatch):
    """Without the CUDA toolkit the build raises instead of falling back;
    the libraries are keyed by a hash of their sources."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    assert _build.library_path("lut_gemv").name.startswith("liblut_gemv-")
    assert _build.library_path("lut_gemv") != _build.library_path("typeconv")
    if not _build.library_path("typeconv").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build(["typeconv"])


def test_typeconv_wrapper_refuses_before_the_device_check():
    """dtype, layout and n are refused with a ValueError before the device
    check (so here, on CPU and ``meta`` tensors), and nothing launches."""
    _build.reset_launches()
    f = ttc_kernel.int_to_f32_cuda
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="int32"):
            f(torch.zeros(8, device=dev), 8)
        with pytest.raises(ValueError, match="int32"):
            f(torch.zeros(8, dtype=torch.int64, device=dev), 8)
        with pytest.raises(ValueError, match="contiguous"):
            f(torch.zeros((4, 6), dtype=torch.int32, device=dev).t(), 8)
        with pytest.raises(ValueError, match="contiguous"):
            f(torch.zeros(16, dtype=torch.int32, device=dev)[::2], 8)
        for n in (1, 26):
            with pytest.raises(ValueError, match="2 <= n <= 25"):
                f(torch.zeros(8, dtype=torch.int32, device=dev), n)
        with pytest.raises(ValueError, match="CUDA"):
            f(torch.zeros(8, dtype=torch.int32, device=dev), 8)
    assert _build.launches["int_to_f32"] == 0


def test_typeconv_grid_and_output_alignment():
    """One 16-byte vector per thread up to a full wave of the card, and an
    output buffer at the input's offset modulo 16 bytes."""
    g = ttc_kernel.grid
    assert g(64 * 4096, 132, 8) == 256           # 65536 vectors, 256 a block
    assert g(4096 * 4096, 132, 8) == 132 * 8     # a wave; threads loop
    assert g(777, 132, 8) == 1 and g(1, 132, 8) == 1
    assert g(257 * 4, 132, 8) == 2              # 257 vectors
    assert g(10 ** 9, 100, 3) == 300
    for ptr, off in ((0, 0), (4, 1), (8, 2), (12, 3), (1 << 40, 0),
                     ((1 << 40) + 20, 1)):
        assert ttc_kernel.out_offset(ptr) == off
        assert (ptr - 4 * off) % 16 == 0


def test_typeconv_constants_match_the_kernel_source():
    src = (_build.CSRC / "typeconv.cu").read_text()
    defined = {name: int(value) for name, value in re.findall(
        r"^constexpr int (\w+) = (\d+);", src, re.M)}
    names = ("THREADS", "MIN_N", "MAX_N")
    assert {n: defined.get(n) for n in names} == {
        n: getattr(ttc_kernel, n) for n in names}


# Runs typeconv.cuh's device function on the host: the CUDA qualifiers and
# the bitcast intrinsic are defined away, and every n-bit value is checked
# against the compiler's own int -> float cast, bit for bit.
_HOST_HARNESS = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <utility>
#define __device__
#define __forceinline__ inline
static inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
#include "typeconv.cuh"

template <int N> long mismatches() {
  long bad = 0;
  const int32_t lim = 1 << (N - 1);
  for (int32_t a = -lim + 1; a < lim; ++a) {
    const float got = sail_int_to_f32<N>(a), want = static_cast<float>(a);
    bad += std::memcmp(&got, &want, 4) != 0;
  }
  return bad;
}

template <int... I> long run(int n, std::integer_sequence<int, I...>) {
  long r = -1;
  ((n == I + 2 ? (r = mismatches<I + 2>(), 0) : 0), ...);
  return r;
}

int main(int argc, char** argv) {
  const int n = std::atoi(argv[1]);
  std::printf("%ld\n", run(n, std::make_integer_sequence<int, 24>{}));
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_typeconv(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler to run typeconv.cuh on the CPU")
    d = tmp_path_factory.mktemp("typeconv_host")
    (d / "harness.cpp").write_text(_HOST_HARNESS)
    exe = d / "harness"
    subprocess.run([cxx, "-O2", "-std=c++17", "-I", str(_build.CSRC), "-o",
                    str(exe), str(d / "harness.cpp")], check=True,
                   capture_output=True, timeout=120)
    return exe


@pytest.mark.parametrize("n", range(ttc_kernel.MIN_N, ttc_kernel.MAX_N + 1))
def test_typeconv_device_function_bit_equal_on_the_host(host_typeconv, n):
    """The CUDA kernel's arithmetic (``csrc/typeconv.cuh``, the bit-parallel
    Algorithm 1 the card runs) is bit-equal to a cast for every value of
    every n the kernel has an instance for: 2**n - 1 values each."""
    out = subprocess.run([str(host_typeconv), str(n)], check=True,
                         capture_output=True, text=True, timeout=60)
    assert int(out.stdout) == 0
