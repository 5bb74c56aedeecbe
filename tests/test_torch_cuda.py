"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Marked ``cuda``: they skip where torch sees no CUDA device (the
kernels have no interpret mode) and run on an H100 with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core.quant import QTensor, _uniform_codebook, \
    quantize_activations, quantize_kv, words_per_group
from repro_torch.kernels import _build
from repro_torch.kernels.decode_attn import kernel as da_kernel
from repro_torch.kernels.decode_attn import ref as da_ref
from repro_torch.kernels.decode_attn.kernel import decode_attention_cuda
from repro_torch.kernels.lut_gemv import ref as lut_ref
from repro_torch.kernels.lut_gemv import kernel as lut_kernel
from repro_torch.kernels.lut_gemv.kernel import lut_matmul_cuda, \
    lut_matmul_int_cuda
from repro_torch.kernels.typeconv import kernel as tc_kernel
from repro_torch.kernels.typeconv.kernel import int_to_f32_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _qt(gen, k, n, bits, group, integer=False):
    rows = (k // group) * words_per_group(bits, group)
    packed = torch.randint(-2**31, 2**31, (rows, n), dtype=torch.int64,
                           device="cuda", generator=gen).to(torch.int32)
    if integer:
        scales = torch.ones((k // group, n), device="cuda")
        book = torch.arange(1 << bits, device="cuda",
                            dtype=torch.float32) - (1 << (bits - 1))
    else:
        scales = torch.rand((k // group, n), device="cuda", generator=gen)
        book = _uniform_codebook(bits, device="cuda")
    return QTensor(packed=packed, scales=scales, codebook=book, bits=bits,
                   group_size=group, k=k)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("mkn", [(8, 1024, 256), (3, 192, 70), (37, 256, 33)])
def test_lut_matmul_kernel_matches_plain(gen, bits, mkn):
    m, k, n = mkn
    group = 64
    qt = _qt(gen, k, n, bits, group)
    x = torch.randn((m, k), device="cuda", generator=gen)
    before = _build.launches["lut_matmul"]
    y = lut_matmul_cuda(x, qt)
    assert _build.launches["lut_matmul"] == before + 1
    torch.testing.assert_close(y, lut_ref.lut_matmul_ref(x, qt), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("abits", [4, 6, 8])
def test_int_kernel_bit_equal_on_integer_data(gen, bits, abits):
    m, k, n = 9, 512, 100
    qt = _qt(gen, k, n, bits, 128, integer=True)
    xq, xs = quantize_activations(
        torch.randn((m, k), device="cuda", generator=gen), abits)
    y = lut_matmul_int_cuda(xq, xs, qt, abits)
    assert torch.equal(y, lut_ref.lut_matmul_ref_int(xq, xs, qt))


# (M, K, N, G): one group; a slab count the splits do not divide; partial
# slabs (32 does not divide G); N not a multiple of the 128-column tile;
# M = 1, 9 (a ragged row tile) and 64 (prefill, no split)
EDGE_SHAPES = [(8, 128, 300, 128), (8, 1024, 4096, 128), (5, 480, 200, 48),
               (8, 512, 333, 64), (1, 1024, 1024, 128), (9, 256, 129, 64),
               (64, 1024, 1024, 128)]


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("mkng", EDGE_SHAPES)
def test_lut_kernels_on_edge_shapes(gen, bits, mkng):
    """Both flavours where the launch plan has edges: the f32 path within
    the reference tolerance, the int path on integer data bit-equal."""
    m, k, n, group = mkng
    qt = _qt(gen, k, n, bits, group)
    x = torch.randn((m, k), device="cuda", generator=gen)
    torch.testing.assert_close(lut_matmul_cuda(x, qt),
                               lut_ref.lut_matmul_ref(x, qt), rtol=1e-5,
                               atol=1e-4)
    qi = _qt(gen, k, n, bits, group, integer=True)
    xq, xs = quantize_activations(x, 8)
    assert torch.equal(lut_matmul_int_cuda(xq, xs, qi, 8),
                       lut_ref.lut_matmul_ref_int(xq, xs, qi))


@pytest.mark.parametrize("mkng", [(8, 1024, 256, 128), (8, 4096, 1024, 128),
                                  (64, 1024, 333, 64)])
def test_lut_kernels_deterministic_and_graph_safe(gen, mkng):
    """Two calls on the same inputs are bit-identical (the cluster sums the
    splits in a fixed order), and a CUDA-graph replay equals the eager
    call."""
    m, k, n, group = mkng
    qt = _qt(gen, k, n, 4, group)
    x = torch.randn((m, k), device="cuda", generator=gen)
    xq, xs = quantize_activations(x, 8)
    calls = (lambda: lut_matmul_cuda(x, qt),
             lambda: lut_matmul_int_cuda(xq, xs, qt, 8))
    for fn in calls:
        first = fn()
        assert torch.equal(fn(), first)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        for _ in range(3):
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, first)
        assert torch.equal(fn(), first)


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 5, 6, 8])
def test_lut_plan_model_matches_the_card(gen, bits):
    """The CPU's model of the card (shared memory per block, resident
    blocks per SM from it and the instance's registers) is what the CUDA
    runtime reports for every instance, and no instance uses more than the
    128 registers the CPU plans with; the wrapper plans with the card's
    own SM count and occupancy."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for abits in (0, 4, 6, 8):
        blocks, smem, regs = lut_kernel.occupancy(bits, abits)
        assert smem == lut_kernel.smem_bytes(bits)
        assert regs <= 128
        assert blocks == lut_kernel.resident_blocks(bits, abits, regs)
        assert blocks >= lut_kernel.resident_blocks(bits, abits)
        assert lut_kernel._card(0, bits, abits) == (sms, blocks)


def _attn_inputs(gen, b, kv, g, d, s, quantized):
    q = torch.randn((b, kv * g, d), device="cuda", generator=gen)
    k = torch.randn((b, s, kv, d), device="cuda", generator=gen)
    v = torch.randn((b, s, kv, d), device="cuda", generator=gen)
    ks = vs = None
    if quantized:
        (k, ks), (v, vs) = quantize_kv(k), quantize_kv(v)
    return q, k, v, ks, vs


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("ring", [False, True])
@pytest.mark.parametrize("d", [8, 32, 64, 120, 128])
@pytest.mark.parametrize("g", [1, 4, 9])
@pytest.mark.parametrize("s", [1, 300, 512, 4096])
def test_decode_attention_kernel_matches_plain(gen, quantized, ring, d, g, s):
    """Every head width and group size the repo's configs have, over short
    and long caches.  Lengths mode: an empty lane (L = 0), one slot, half
    and all of S, with and without a window; the plain version gives NaN
    for the empty lane (softmax over no slot), the kernel zeros, as the
    Pallas kernel's max(l, 1e-30) does.  Ring mode: positions before the
    ring wraps (p < S) and after, under a short and the model's window."""
    b, kv = 4, 2
    q, k, v, ks, vs = _attn_inputs(gen, b, kv, g, d, s, quantized)
    if ring:
        pos = torch.tensor([0, s // 2, s + 5, 3 * s + s // 3],
                           dtype=torch.int32, device="cuda")
        for window in (200, 4096):
            got = decode_attention_cuda(q, k, v, pos, ks, vs, window,
                                        ring=True)
            want = da_ref.decode_attention_ring_ref(q, k, v, pos, window, ks,
                                                    vs)
            torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    else:
        lens = torch.tensor([0, 1, (s + 1) // 2, s], dtype=torch.int32,
                            device="cuda")
        for window in (64, None):
            got = decode_attention_cuda(q, k, v, lens, ks, vs, window,
                                        ring=False)
            want = da_ref.decode_attention_ref(q, k, v, lens, ks, vs, window)
            assert torch.equal(got[0], torch.zeros_like(got[0]))
            torch.testing.assert_close(got[1:], want[1:], rtol=2e-5,
                                       atol=2e-5)


# (B, KV, G, D, S, ring, quantized): the main path's call (tinymistral,
# wrapped positions), a long ring, f32 K/V with G 9 and D 120
GRAPH_CASES = [(8, 8, 4, 32, 512, True, True), (8, 8, 4, 32, 4096, True, True),
               (3, 2, 9, 120, 300, False, False)]


@pytest.mark.parametrize("case", GRAPH_CASES)
def test_decode_attention_deterministic_and_graph_safe(gen, case):
    """Two calls on the same inputs are bit-identical (the splits of a
    sequence meet in a fixed order), and a CUDA-graph replay equals the
    eager call."""
    b, kv, g, d, s, ring, quantized = case
    q, k, v, ks, vs = _attn_inputs(gen, b, kv, g, d, s, quantized)
    lens = torch.randint(0, 3 * s, (b,), device="cuda", generator=gen,
                         dtype=torch.int32)
    window = 4096 if ring else None
    fn = lambda: decode_attention_cuda(q, k, v, lens, ks, vs, window,
                                       ring=ring)
    first = fn()
    assert torch.equal(fn(), first)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)


def _paged(gen, b, kv, g, d, s, bs, quantized):
    """A block pool of the lanes' blocks, shuffled with gaps, plus a trash
    block (the last), and [B, mbs] tables (mbs = ceil(S / BS)): the last
    lane's entries all trash, at a frozen position.  Positions never wrap
    (paged lanes): 0, one block, the last slot of the lane, then spread."""
    mbs = -(-s // bs)
    nb = 2 * b * mbs
    q, k, v, ks, vs = _attn_inputs(gen, 1, kv, g, d, (nb + 1) * bs,
                                   quantized)
    pool = lambda a: None if a is None else a.reshape(
        (nb + 1, bs) + tuple(a.shape[2:]))
    perm = torch.randperm(nb, device="cuda", generator=gen)
    tables = perm[:b * mbs].reshape(b, mbs).to(torch.int32).contiguous()
    tables[-1] = nb
    pos = [0, bs, mbs * bs - 1] + [97 * i % (mbs * bs) for i in range(3, b)]
    pos = torch.tensor(pos[:b - 1] + [5], dtype=torch.int32, device="cuda")
    q = torch.randn((b, kv * g, d), device="cuda", generator=gen)
    return q, pool(k), pool(v), pool(ks), pool(vs), tables, pos


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [32, 128])
@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("s", [512, 4096])
@pytest.mark.parametrize("bs", [8, 12, 16])
def test_decode_attention_table_mode_matches_plain_and_ring(gen, quantized,
                                                            d, g, s, bs):
    """Table mode against its plain version (the reference's gather, then
    ring attention) at 2e-5, and bit-equal to ring mode on the same rows
    laid out contiguously: at the same S the two modes run one plan and
    one row order, so only ``row_of`` differs.  The trash lane is compared
    too (dead values, but the same ones)."""
    b, kv = 4, 2
    q, k, v, ks, vs, tables, pos = _paged(gen, b, kv, g, d, s, bs, quantized)
    g_ = lambda a: None if a is None else da_ref.gather_blocks(a, tables)
    for window in (100, 4096):
        before = dict(_build.launches)
        got = decode_attention_cuda(q, k, v, pos, ks, vs, window, ring=True,
                                    tables=tables)
        assert _build.launches["decode_attention_table"] == \
            before["decode_attention_table"] + 1
        want = da_ref.decode_attention_paged_ref(q, k, v, pos, tables,
                                                 window, ks, vs)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        ring = decode_attention_cuda(q, g_(k), g_(v), pos, g_(ks), g_(vs),
                                     window, ring=True)
        assert torch.equal(got, ring)


@pytest.mark.parametrize("bs", [8, 12, 16])
def test_decode_attention_table_mode_deterministic_and_graph_safe(gen, bs):
    """At tinymistral's widths (B 8, KV 8, G 4, D 32, int8) and S 512 and
    4096: two calls are bit-identical, and a CUDA-graph replay equals the
    eager call after the tables change in place (the engine's one copy_
    per step)."""
    for s in (512, 4096):
        q, k, v, ks, vs, tables, pos = _paged(gen, 8, 8, 4, 32, s, bs, True)
        fn = lambda: decode_attention_cuda(q, k, v, pos, ks, vs, 4096,
                                           ring=True, tables=tables)
        first = fn()
        assert torch.equal(fn(), first)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        tables.copy_(tables.flip(0))
        flipped = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, flipped)


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_plan_model_matches_the_card(gen, g, quantized):
    """The CPU's model of the card (resident blocks from shared memory, the
    instance's warps and its registers) is what the CUDA runtime reports
    for every instance, at every head width's shared memory; the wrapper
    plans with the card's own cluster counts, and its grid at
    tinymistral's batch stays in one wave: every cluster resident at
    once."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for d in (8, 32, 120, 128):
        gm, *_, smem = da_kernel.tiles(g, d, quantized)
        blocks, regs = da_kernel.occupancy(gm, quantized, smem)
        assert blocks == da_kernel.resident_blocks(
            smem, da_kernel.warps_of(gm), regs)
        clusters = tuple(da_kernel.max_clusters(gm, quantized, 1 << i, smem)
                         for i in range(da_kernel.MAX_SPLITS.bit_length()))
        assert clusters[0] == sms * blocks
        assert da_kernel._card(0, gm, quantized, smem) == clusters
        for s in (512, 4096):
            p = da_kernel.card_plan(8, 8 * g, 8, d, s, 4096, True, quantized,
                                    torch.device("cuda", 0))
            assert p.b * p.kv <= clusters[p.lg_splits]


@pytest.mark.parametrize("size, offset", [(1000, 0), (777, 0), (1000, 1),
                                          (777, 2), (4099, 3),
                                          ((1 << 23) + 5, 1)])
@pytest.mark.parametrize("n", range(2, 26))
def test_typeconv_kernel_bit_equal(gen, n, size, offset):
    """Every n the kernel has an instance for, 0 and +-(2**(n-1) - 1) at both
    ends, a count that is not a multiple of 4 (the scalar tail) and a view
    at an odd element offset (the scalar head, and an output buffer at the
    same offset modulo 16 bytes); 2**23 + 5 elements give each thread of
    a full wave more than 4 vectors, so the unrolled iterations run too."""
    lim = 1 << (n - 1)
    buf = torch.randint(-lim + 1, lim, (offset + size,), device="cuda",
                        generator=gen, dtype=torch.int32)
    a = buf[offset:]
    ends = torch.tensor([0, lim - 1, -(lim - 1)], dtype=torch.int32,
                        device="cuda")
    a[:3], a[-3:] = ends, ends
    before = _build.launches["int_to_f32"]
    out = int_to_f32_cuda(a, n)
    assert _build.launches["int_to_f32"] == before + 1
    assert out.shape == a.shape and out.is_contiguous()
    assert (out.data_ptr() - a.data_ptr()) % 16 == 0
    assert torch.equal(out, a.float())


@pytest.mark.parametrize("n", range(2, 26))
def test_typeconv_grid_fills_the_card(gen, n):
    """Each instance holds at least 1024 threads on an SM (its 16-byte
    loads need many in flight), and a large call launches one full wave."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = tc_kernel.occupancy(n)
    assert per_sm * tc_kernel.THREADS >= 1024
    assert tc_kernel._card(0, n) == (sms, per_sm)
    assert tc_kernel.grid(1 << 24, sms, per_sm) == sms * per_sm


def test_kernels_refuse_what_they_do_not_take(gen):
    qt = _qt(gen, 256, 64, 4, 64)
    with pytest.raises(ValueError):
        lut_matmul_cuda(torch.randn((4, 256), device="cuda").t().contiguous()
                        .t(), qt)                # not contiguous
    with pytest.raises(ValueError):
        lut_matmul_cuda(torch.randn((4, 128), device="cuda"), qt)   # K
    with pytest.raises(ValueError):
        int_to_f32_cuda(torch.zeros(4, device="cuda"), 8)           # dtype


# --- mixed-precision plans: the instances a plan puts on the path ----------

MODEL_KN = [(1024, 1024), (1024, 256), (4096, 1024), (1024, 4096)]


@pytest.mark.parametrize("bits", [5, 6])
@pytest.mark.parametrize("kn", MODEL_KN)
def test_lut_matmul_b5_b6_at_the_model_shapes(gen, bits, kn):
    """The 5- and 6-bit instances (codes straddle words) at tinymistral's
    decode shapes, group 128, each launch counted under its instance."""
    k, n = kn
    qt = _qt(gen, k, n, bits, 128)
    x = torch.randn((8, k), device="cuda", generator=gen)
    before = _build.lut_instances.get((bits, 0), 0)
    y = lut_matmul_cuda(x, qt)
    assert _build.lut_instances[(bits, 0)] == before + 1
    torch.testing.assert_close(y, lut_ref.lut_matmul_ref(x, qt), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
@pytest.mark.parametrize("kn", MODEL_KN)
def test_int_path_abits6_on_quantized_data(gen, bits, kn):
    """The 6-bit activation instances (a 64-entry Algorithm-1 table) on
    activations quantized from f32, as the model feeds them, within
    chip_smoke's tolerance for quantized data."""
    k, n = kn
    qt = _qt(gen, k, n, bits, 128)
    xq, xs = quantize_activations(
        torch.randn((8, k), device="cuda", generator=gen), 6)
    assert int(xq.abs().max()) <= 31
    y = lut_matmul_int_cuda(xq, xs, qt, 6)
    torch.testing.assert_close(y, lut_ref.lut_matmul_ref_int(xq, xs, qt),
                               rtol=1e-4, atol=1e-4)


def _plan_s_model():
    """tinymistral smoke at 4 layers, random weights (seed 0), and plan S
    of tests/test_torch_plan.py: three segments, f32 KV."""
    import dataclasses
    import repro_torch.configs as TC
    from repro_torch.models import lm
    cfg = dataclasses.replace(TC.get_smoke("tinymistral_248m"), n_layers=4)
    raw = lm.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    per = lambda a, b, c: [a, b, b, c]
    attn = [f"['blocks']['attn']['{m}']" for m in ("wq", "wk", "wv", "wo")]
    mlp = [f"['blocks']['mlp']['{m}']" for m in ("w_gate", "w_up")]
    w = {p: per(8, 4, 6) for p in attn}
    w.update({p: per(5, 3, 4) for p in mlp})
    w["['blocks']['mlp']['w_down']"] = per(6, 4, 8)
    w["['lm_head']"] = 6
    plan = {"mode": "auto", "weight_bits": 4, "kv_bits": 32,
            "weights_per_unit": w}
    return cfg, raw, plan


def test_segmented_decode_on_the_card_matches_the_cpu(gen):
    from repro_torch.models import lm
    from repro_torch.models.sail_linear import QuantPolicy, map_tensors, \
        quantize_params
    from repro_torch.planning import as_plan
    cfg, raw, plan = _plan_s_model()
    policy = as_plan(plan).to_policy(QuantPolicy(bits=4, group_size=32,
                                                 min_size=1024))
    cpu, _, _ = quantize_params(raw, policy)
    assert len(cpu["blocks"]) == 3
    card = map_tensors(cpu, lambda t: t.cuda())
    prompt = torch.randint(0, cfg.vocab, (2, 9), generator=torch.Generator()
                           .manual_seed(1))
    lengths = [9, 6]
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        logits, cache = lm.prefill(params, prompt, cfg, 32, False, lengths,
                                   device=dev)
        steps = [logits.cpu()]
        tok = torch.argmax(logits, -1)[:, None]
        _build.reset_launches()
        for _ in range(3):
            logits, cache = lm.decode_step(params, tok, cache, cfg, False,
                                           device=dev)
            steps.append(logits.cpu())
            tok = torch.argmax(logits, -1)[:, None]
        out[dev] = torch.stack(steps)
    # per step: layer 0 at attn 8 / gate, up 5 / down 6; layers 1-2 at
    # 4 / 3 / 4; layer 3 at 6 / 4 / 8; lm_head 6: 29 calls, 3 steps
    assert _build.lut_instances == {(8, 0): 3 * 5, (5, 0): 3 * 2,
                                    (6, 0): 3 * 6, (4, 0): 3 * 12,
                                    (3, 0): 3 * 4}
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)
    assert torch.equal(out["cuda"].argmax(-1), out["cpu"].argmax(-1))


def test_engine_with_f32_kv_ring_equals_paged(gen):
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw, plan = _plan_s_model()
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5], [2, 7, 1]]
    tokens = {}
    for name, extra in (("ring", {}), ("paged", dict(
            kv_block_size=8, kv_pool_blocks=32, share_prefix=False))):
        eng = Engine(raw, cfg, EngineConfig(
            batch_size=4, cache_len=64, group_size=32, plan=plan, **extra),
            device="cuda")
        assert eng.kv_bits == 32
        assert eng.cache["layers"]["k"].dtype == torch.float32
        uids = [eng.submit(p, 6) for p in prompts]
        _build.reset_launches()
        eng.run()
        tokens[name] = [eng.completions[u].tokens for u in uids]
        table = _build.launches["decode_attention_table"]
        assert (table > 0) == (name == "paged")
        assert _build.launches["decode_attention"] >= 4 * \
            eng.stats()["decode_iterations"]
    assert tokens["ring"] == tokens["paged"]


def test_probe_scores_on_the_card_match_the_cpu(gen):
    """The Planner's output, activation and KV probes on the card against
    the CPU at the CPU tests' tolerances (output scores rtol 1e-4,
    activation scores 1e-3, atol 1e-9; KV per layer 1e-3), the same
    allocation from both sets of scores, and the engine solving an
    unsolved plan on the card to the CPU's plan."""
    from repro_torch.core import sensitivity as sens
    from repro_torch.models.sail_linear import QuantPolicy, map_tensors
    from repro_torch.serving.engine import Engine, EngineConfig
    cfg, raw, _ = _plan_s_model()
    card_raw = map_tensors(raw, lambda t: t.cuda())
    base = QuantPolicy(bits=4, group_size=32, min_size=1024)
    toks = sens.calibration_tokens(cfg.vocab)
    got = {}
    for dev, params in (("cpu", raw), ("cuda", card_raw)):
        _build.reset_launches()
        got[dev] = (sens.output_sensitivity(params, cfg, toks, base),
                    sens.activation_sensitivity(params, cfg, toks, base),
                    sens.kv_sensitivity(params, cfg, toks))
    # the probes run plain matmuls; only the KV probe's decode steps launch
    # decode attention (a reference step and one per layer, over an f32
    # cache, each through every layer)
    assert _build.launches["lut_matmul"] == 0
    assert _build.launches["decode_attention"] == \
        (1 + cfg.n_layers) * cfg.n_layers
    for kind, rtol in ((0, 1e-4), (1, 1e-3)):
        for key, errs in got["cpu"][kind].items():
            for b, c in errs.items():
                assert got["cuda"][kind][key][b] == pytest.approx(
                    c, rel=rtol, abs=1e-9), (key, b)
    torch.testing.assert_close(torch.tensor(got["cuda"][2]["per_layer"]),
                               torch.tensor(got["cpu"][2]["per_layer"]),
                               rtol=1e-3, atol=0)
    reps = [sens.calibrate_policy(raw, cfg, base, scores=s, act_scores=a,
                                  match_uniform=4, abits_candidates=(4, 6, 8),
                                  tokens=toks)[1].bits_by_unit
            for s, a, _ in got.values()]
    assert reps[0] == reps[1]
    hashes = {}
    for dev in ("cpu", "cuda"):
        eng = Engine(raw, cfg, EngineConfig(batch_size=2, cache_len=32,
                                            group_size=32,
                                            plan="auto:q4a8,kv=auto"),
                     device=dev)
        hashes[dev] = eng.stats()["plan_hash"]
    assert hashes["cpu"] == hashes["cuda"]


@pytest.mark.parametrize("vocab", [97, 32005])
def test_sampling_draw_on_the_card_matches_the_cpu(gen, vocab):
    """The engine's sampler on the card against the CPU on the same logits,
    uids and indices: the 32-bit words and the uniforms bit-equal, the
    Gumbel noise within 4 ulp at max(|g|, 1), the tokens equal."""
    import numpy as np
    from repro_torch.core import prng
    logits = torch.randn((8, vocab), device="cuda", generator=gen) * 3
    uids = np.array([0, 1, 2, 3, 70000, 9, 10, 2**32 - 1], np.int64)
    indices = np.array([0, 1, 2, 3, 66000, 5, 6, 7], np.int64)
    card = prng.draw_rows(logits, uids, indices, 7, 0.7)
    cpu = prng.draw_rows(logits.cpu(), uids, indices, 7, 0.7)
    assert torch.equal(card.bits.cpu(), cpu.bits)
    assert torch.equal(card.uniform.cpu().view(torch.int32),
                       cpu.uniform.view(torch.int32))
    want = cpu.gumbel.double()
    scale = torch.from_numpy(np.spacing(np.maximum(
        cpu.gumbel.abs().numpy(), np.float32(1))).astype(np.float64))
    assert ((card.gumbel.cpu().double() - want).abs() / scale).max() <= 4
    assert torch.equal(card.tokens.cpu(), cpu.tokens)


# --- tensor parallelism: the shapes one rank of tp = 2 or 4 runs -------------

# (K, N) of the block matrices on one rank of full-width tinymistral:
# wq, wk / wv, wo, w_gate / w_up, w_down at tp 2, then at tp 4
TP_KN = [(1024, 512), (1024, 128), (512, 1024), (1024, 2048), (2048, 1024),
         (1024, 256), (1024, 64), (256, 1024)]


@pytest.mark.parametrize("kn", TP_KN)
def test_lut_kernels_at_the_tp_shard_shapes(gen, kn):
    """Both LUT-GEMV flavours at a rank's decode shapes (M 8, b 4, G 128;
    wo's K is 4 groups at tp 2 and 2 at tp 4): the f32 one at the
    reference tests' tolerance, the int one (8-bit activations quantized
    from f32) at chip_smoke's tolerance for quantized data."""
    k, n = kn
    qt = _qt(gen, k, n, 4, 128)
    x = torch.randn((8, k), device="cuda", generator=gen)
    torch.testing.assert_close(lut_matmul_cuda(x, qt),
                               lut_ref.lut_matmul_ref(x, qt), rtol=1e-5,
                               atol=1e-4)
    xq, xs = quantize_activations(x, 8)
    torch.testing.assert_close(lut_matmul_int_cuda(xq, xs, qt, 8),
                               lut_ref.lut_matmul_ref_int(xq, xs, qt),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kv", [4, 2])
@pytest.mark.parametrize("quantized", [False, True])
def test_decode_attention_at_the_tp_shard_heads(gen, kv, quantized):
    """Decode attention over a rank's kv heads (4 at tp 2, 2 at tp 4; G 4,
    D 32, 8 lanes, S 512) in ring mode, wrapped and not, and in table mode
    (block size 16), each at 2e-5 of its plain version."""
    b, g, d, s = 8, 4, 32, 512
    q, k, v, ks, vs = _attn_inputs(gen, b, kv, g, d, s, quantized)
    pos = torch.tensor([0, 1, 40, 255, 511, 512, 700, 2000],
                       dtype=torch.int32, device="cuda")
    got = decode_attention_cuda(q, k, v, pos, ks, vs, 4096, ring=True)
    want = da_ref.decode_attention_ring_ref(q, k, v, pos, 4096, ks, vs)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    q, k, v, ks, vs, tables, pos = _paged(gen, b, kv, g, d, s, 16, quantized)
    got = decode_attention_cuda(q, k, v, pos, ks, vs, 4096, ring=True,
                                tables=tables)
    want = da_ref.decode_attention_paged_ref(q, k, v, pos, tables, 4096, ks,
                                             vs)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("d", [12, 20])
@pytest.mark.parametrize("g", [1, 2, 3])
def test_decode_attention_narrow_heads(gen, quantized, d, g):
    """The narrow heads of the smoke configs (D 12 and 20, a multiple of 4
    and not of 8: an int8 row is only 4-byte aligned, so it is staged by
    4-byte copies) in lengths, ring and table mode, each at 2e-5 of its
    plain version; table mode bit-equal to ring mode on the same rows."""
    b, kv, s = 4, 2, 300
    q, k, v, ks, vs = _attn_inputs(gen, b, kv, g, d, s, quantized)
    assert da_kernel.plan(b, kv * g, kv, d, s, None, False,
                          quantized).copy_bytes == (4 if quantized else 16)
    lens = torch.tensor([0, 1, 150, 300], dtype=torch.int32, device="cuda")
    for window in (64, None):
        got = decode_attention_cuda(q, k, v, lens, ks, vs, window, ring=False)
        want = da_ref.decode_attention_ref(q, k, v, lens, ks, vs, window)
        torch.testing.assert_close(got[1:], want[1:], rtol=2e-5, atol=2e-5)
    pos = torch.tensor([0, 150, 305, 1000], dtype=torch.int32, device="cuda")
    for window in (100, 4096):
        got = decode_attention_cuda(q, k, v, pos, ks, vs, window, ring=True)
        want = da_ref.decode_attention_ring_ref(q, k, v, pos, window, ks, vs)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    q, k, v, ks, vs, tables, pos = _paged(gen, b, kv, g, d, 512, 16,
                                          quantized)
    g_ = lambda a: None if a is None else da_ref.gather_blocks(a, tables)
    got = decode_attention_cuda(q, k, v, pos, ks, vs, 4096, ring=True,
                                tables=tables)
    want = da_ref.decode_attention_paged_ref(q, k, v, pos, tables, 4096, ks,
                                             vs)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
    assert torch.equal(got, decode_attention_cuda(
        q, g_(k), g_(v), pos, g_(ks), g_(vs), 4096, ring=True))


# (K, N) of llama2_7b's weight matrices: wq / wk / wv / wo, w_gate / w_up,
# lm_head, w_down
LLAMA2_7B_KN = [(4096, 4096), (4096, 11008), (4096, 32000), (11008, 4096)]


@pytest.mark.parametrize("m", [8, 64])
@pytest.mark.parametrize("kn", LLAMA2_7B_KN)
def test_lut_kernels_at_the_llama2_7b_shapes(gen, m, kn):
    """Both LUT-GEMV flavours at llama2_7b's shapes (b 4, G 128), at M 8
    (a decode step) and 64 (a prefill), against their plain versions: the
    other shape tests' tolerances at K 4096, and at K 11008 an absolute
    tolerance grown with K (the two sum K products in another f32 order,
    so their difference can grow with K; at atol 1e-4 one output in
    ~30000, an output of |y| 4.6 out of a sum of 11008 terms, parts by
    1.5e-4)."""
    k, n = kn
    atol = 1e-4 * k / 4096
    qt = _qt(gen, k, n, 4, 128)
    x = torch.randn((m, k), device="cuda", generator=gen)
    torch.testing.assert_close(lut_matmul_cuda(x, qt),
                               lut_ref.lut_matmul_ref(x, qt), rtol=1e-5,
                               atol=atol)
    xq, xs = quantize_activations(x, 8)
    torch.testing.assert_close(lut_matmul_int_cuda(xq, xs, qt, 8),
                               lut_ref.lut_matmul_ref_int(xq, xs, qt),
                               rtol=1e-4, atol=atol)


def test_train_step_on_the_card_matches_the_cpu(gen):
    """One ``build_train_step`` step of tinymistral smoke from the same
    weights on the card and on the CPU: the loss and the grad norm within
    1e-5 relative, and every updated parameter within two learning rates
    of the CPU's (an Adam step moves an element by at most about lr, so
    a gradient near 0 whose sign differs parts by up to 2 lr; TF32 off,
    as above)."""
    import repro_torch.configs as TC
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    from repro_torch.tree import tree_leaves

    cfg = TC.get_smoke("tinymistral_248m")
    raw = params_to_numpy(lm.init_params(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    batch = {k: torch.from_numpy(v) for k, v in SyntheticLM(DataConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4)).next_batch().items()}
    out = {}
    for dev in ("cuda", "cpu"):
        built = build_train_step(cfg, microbatches=1, bf16_compute=False,
                                 device=dev)
        params = params_from_numpy(raw, device=dev)
        state = built.meta["optimizer"].init(params)
        params, state, m = built.fn(params, state, batch)
        out[dev] = (params, {k: float(v) for k, v in m.items()})
    (pc, mc), (pp, mp) = out["cuda"], out["cpu"]
    for key in ("loss", "grad_norm"):
        assert abs(mc[key] - mp[key]) <= 1e-5 * abs(mp[key]), key
    assert mc["step"] == mp["step"] == 1
    lr = float(built.meta["optimizer"].lr(torch.tensor(1)))
    for a, b in zip(tree_leaves(pc), tree_leaves(pp)):
        assert a.device.type == "cuda" and not a.requires_grad
        assert float((a.cpu() - b).abs().max()) <= 2 * lr + 1e-6 * float(
            b.abs().max())
