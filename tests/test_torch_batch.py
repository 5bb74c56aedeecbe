"""Run-to-completion ``mode="batch"`` and unquantized serving in the port
against the JAX reference on tinymistral smoke (token-identical
completions, the reference's errors, warnings and stats), the rest of
``core/scheduler.py`` (``admit`` / ``step_complete``, the SAIL tensor
schedule and ping-pong pipeline model), the rest of ``core/quant.py``
(field packing and integer quantization, bit for bit) and
``serving/workload.py`` (the same traces and ``trace_hash``), and the
launcher's ``--mode batch``.  Every input comes from a fixed numpy seed."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.core import quant as jq
from repro.core import scheduler as jsched
from repro.models import lm as jlm
from repro.serving import workload as jwl
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import quant as tq
from repro_torch.core import scheduler as tsched
from repro_torch.serving import workload as twl
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5], [2, 7, 1]]
ENGINE = dict(batch_size=4, cache_len=64, group_size=32, quant_kv=True)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke():
    cfg = JC.get_smoke(ARCH)
    params = jlm.init_params(jax.random.PRNGKey(0), cfg)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return cfg, TC.get_smoke(ARCH), params, carried


def _serve(engine, prompts=PROMPTS, max_new=6):
    uids = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run()
    return {u: engine.completions[u].tokens for u in uids}


def _pair(smoke, **kw):
    jcfg, tcfg, params, carried = smoke
    fields = {**ENGINE, **kw}
    return (JEngine(params, jcfg, JEngineConfig(**fields)),
            TEngine(carried, tcfg, TEngineConfig(**fields), device="cpu"))


STATS = ("requests", "generated_tokens", "iterations", "prefill_iterations",
         "decode_iterations", "prefill_tokens", "peak_active", "kv_bits",
         "weight_compression", "mixed_precision", "plan_hash", "plan_mode",
         "plan_calibrated", "measured_tps", "planned_tps", "modeled_run_tps",
         "drift", "block_pool")


def _same_stats(teng, jeng, keys=STATS):
    st, jst = teng.stats(), jeng.stats()
    for key in keys:
        if key in ("measured_tps", "planned_tps", "modeled_run_tps",
                   "drift"):
            assert (st[key] is None) == (jst[key] is None), key
            if key == "planned_tps" and st[key] is not None:
                assert st[key] == pytest.approx(jst[key], rel=1e-9)
        else:
            assert st[key] == jst[key], key


# --- run-to-completion --------------------------------------------------------

@pytest.mark.parametrize("kw", [
    pytest.param(dict(plan="uniform:4"), id="uniform:4"),
    pytest.param(dict(plan="uniform:4a8", quant_kv=False),
                 id="uniform:4a8-f32kv"),
    pytest.param(dict(plan="uniform:4", temperature=0.7, seed=7),
                 id="uniform:4-T0.7"),
])
def test_batch_mode_matches_reference_and_continuous(smoke, kw):
    """tests/test_engine_continuous.py:29 on both packages: batch mode
    gives the reference's batch tokens and the port's continuous ones."""
    jeng, teng = _pair(smoke, mode="batch", **kw)
    got = _serve(teng)
    assert got == _serve(jeng)
    assert all(len(t) == 6 for t in got.values())
    _same_stats(teng, jeng)
    assert teng.stats()["measured_tps"] is None    # no masked decode steps
    _, cont = _pair(smoke, mode="continuous", **kw)
    assert _serve(cont) == got


def test_batch_mode_cohorts_eos_and_zero_budget(smoke):
    """A second cohort, a request with max_new_tokens=0 (an empty
    completion, tests/test_engine_continuous.py:172) and an EOS stop,
    each as the reference serves them."""
    jeng, teng = _pair(smoke, mode="batch", batch_size=2, plan="uniform:4")
    ref = _serve(jeng, PROMPTS[:1], max_new=0)
    got = _serve(teng, PROMPTS[:1], max_new=0)
    assert got == ref and list(got.values()) == [[]]
    assert _serve(teng, PROMPTS[1:], 5) == _serve(jeng, PROMPTS[1:], 5)
    _same_stats(teng, jeng)
    # EOS: the first token any request generates stops it
    eos = _serve(_pair(smoke, mode="batch", plan="uniform:4")[1])[1][0]
    jeng, teng = _pair(smoke, mode="batch", plan="uniform:4", eos_token=eos)
    got = _serve(teng)
    assert got == _serve(jeng) and got[1] == [eos]


def test_batch_mode_streams_tokens(smoke):
    _, teng = _pair(smoke, mode="batch", batch_size=2, plan="uniform:4")
    seen = []
    uids = [teng.submit(p, 3, on_token=lambda u, t: seen.append((u, t)))
            for p in PROMPTS[:3]]
    teng.run()
    for u in uids:
        assert [t for v, t in seen if v == u] == teng.completions[u].tokens
    assert teng.sched.idle() and teng.stats()["peak_active"] == 2


# --- unquantized serving ------------------------------------------------------

@pytest.mark.parametrize("kw", [
    pytest.param(dict(quant_kv=False), id="f32kv"),
    pytest.param(dict(quant_kv=True), id="int8kv"),
    pytest.param(dict(quant_kv=True, kv_block_size=8), id="int8kv-paged"),
    pytest.param(dict(quant_kv=False, mode="batch"), id="f32kv-batch"),
    pytest.param(dict(quant_kv=True, temperature=0.7, seed=7),
                 id="int8kv-T0.7"),
])
def test_unquantized_matches_reference(smoke, kw):
    """quantize=False (tests/test_mixed_precision.py:369,
    tests/test_block_pool.py:275): the raw f32 tree served through plain
    products gives the reference's tokens and stats."""
    jeng, teng = _pair(smoke, quantize=False, **kw)
    got = _serve(teng, max_new=8)
    assert got == _serve(jeng, max_new=8)
    _same_stats(teng, jeng)
    st = teng.stats()
    assert st["plan_hash"] is None and st["planned_tps"] is None
    assert st["weight_compression"] == 1.0 and teng.quant_policy is None
    assert isinstance(teng.params["blocks"]["mlp"]["w_up"], torch.Tensor)


def test_mode_and_quantize_errors(smoke):
    """tests/test_planning.py:450, :482 and tests/test_block_pool.py:275
    on the port: a plan needs quantize=True, the tap is ignored (with a
    warning) in batch mode, the paged pool refuses batch mode, and
    apply_plan / replan name quantize=True."""
    jcfg, tcfg, params, carried = smoke
    for kw in (dict(plan="uniform:4"), dict(bit_policy="uniform:4")):
        with pytest.raises(ValueError, match="quantize=True"):
            JEngine(params, jcfg, JEngineConfig(quantize=False, **kw))
        with pytest.raises(ValueError, match="quantize=True"):
            TEngine(carried, tcfg, TEngineConfig(quantize=False, **kw),
                    device="cpu")
    for make in (lambda **k: JEngine(params, jcfg, JEngineConfig(**k)),
                 lambda **k: TEngine(carried, tcfg, TEngineConfig(**k),
                                     device="cpu")):
        with pytest.warns(UserWarning, match="tap_capacity is ignored"):
            eng = make(**ENGINE, mode="batch", tap_capacity=8)
        assert eng.tap is None
        with pytest.raises(ValueError, match="requires mode='continuous'"):
            make(batch_size=2, cache_len=64, quantize=False, mode="batch",
                 kv_block_size=8)
        eng = make(**ENGINE, quantize=False, tap_capacity=8)
        with pytest.raises(ValueError, match="quantize=True"):
            eng.apply_plan("uniform:4")
        with pytest.raises(ValueError, match="quantize=True"):
            eng.replan()
        eng = make(**ENGINE, plan="uniform:4")
        with pytest.raises(ValueError, match="mode='continuous'"):
            eng.replan()
    with pytest.raises(ValueError, match="mode="):
        TEngine(carried, tcfg, TEngineConfig(mode="paged"), device="cpu")
    # a draft plan and tensor-parallel serving need the continuous engine
    # (the reference's gates)
    with pytest.raises(ValueError, match="requires mode='continuous'"):
        TEngine(carried, tcfg, TEngineConfig(
            **ENGINE, plan="uniform:4,draft=q2a8:k4", mode="batch"),
            device="cpu")
    with pytest.raises(ValueError, match="tensor-parallel serving requires "
                                         "mode='continuous'"):
        TEngine(carried, tcfg, TEngineConfig(plan="uniform:4,tp=2",
                                             mode="batch"), device="cpu")


# --- core/scheduler.py --------------------------------------------------------

def _sched_state(s):
    return ([(r.uid, r.state, r.generated, r.done) for r in s.running],
            [(r.uid, r.state, r.generated, r.done) for r in s.finished],
            [r.uid for r in s.waiting])


@pytest.mark.parametrize("n,target", [(4, 2), (1, 1), (12, 5), (7, 3)])
def test_admit_and_step_complete_match_reference(n, target):
    """tests/test_scheduler.py:40-63's batch interface, op for op."""
    rng = np.random.default_rng(n * 10 + target)
    scheds = []
    for mod in (jsched, tsched):
        s = mod.IterationScheduler(target_batch=target)
        for i in range(n):
            s.submit(mod.Request(uid=i, prompt_len=4,
                                 max_new_tokens=int(rng.integers(1, 4))))
        rng = np.random.default_rng(n * 10 + target)
        scheds.append(s)
    guard = 0
    while not scheds[0].idle():
        batches = [[r.uid for r in s.admit()] for s in scheds]
        assert batches[0] == batches[1]
        done = batches[0][:1] if guard % 3 == 2 else []
        for s in scheds:
            s.step_complete(done)
        assert _sched_state(scheds[1]) == _sched_state(scheds[0])
        guard += 1
        assert guard < 100
    assert scheds[1].idle() and len(scheds[1].finished) == n


@pytest.mark.parametrize("layers,buffer", [
    ([[("w1", 100), ("w2", 50)], [("w3", 120)], [("w4", 60)]], 400),
    ([[("big1", 150), ("big2", 150)]], 400),
    ([[("a", 90), ("b", 90), ("c", 90), ("d", 30)], [("e", 500)],
      [("f", 10), ("g", 20)]], 200),
])
def test_tensor_schedule_matches_reference(layers, buffer):
    ref = jsched.plan_tensor_schedule(layers, buffer)
    got = tsched.plan_tensor_schedule(layers, buffer)
    assert got.n_phases == ref.n_phases
    assert ([dataclasses.astuple(p) for p in got.placements]
            == [dataclasses.astuple(p) for p in ref.placements])
    for phase in range(ref.n_phases):
        assert ([p.name for p in got.residency(phase)]
                == [p.name for p in ref.residency(phase)])


@pytest.mark.parametrize("bw,rate,tile", [
    (100.0, 1000.0, 1000), (204.8e9, 204.8e9 * 8, 32 << 20),
    (3.35e12, 1e12, 1 << 20)])
def test_pipeline_model_matches_reference(bw, rate, tile):
    ref = jsched.PipelineModel(stream_bw=bw, compute_rate=rate)
    got = tsched.PipelineModel(stream_bw=bw, compute_rate=rate)
    assert got.bubble_free_batch(tile) == ref.bubble_free_batch(tile)
    assert got.optimal_batch(tile) == ref.optimal_batch(tile)
    for b in (1, 4, 8, 16):
        assert got.phase_time(tile, b) == ref.phase_time(tile, b)
        assert (got.iteration_time([tile, tile // 2, 3], b)
                == ref.iteration_time([tile, tile // 2, 3], b))
    assert got.iteration_time([], 8) == 0.0


# --- core/quant.py ------------------------------------------------------------

@pytest.mark.parametrize("k", [96, 97, 5])
@pytest.mark.parametrize("bits", tq.KERNEL_BITS)
def test_pack_bits_bit_equal_to_reference(bits, k):
    """Field packing for every width, K a multiple of the codes per word
    and not (zero-padded): the same words, and the codes back."""
    assert tq.values_per_word(bits) == jq.values_per_word(bits)
    rng = np.random.default_rng(bits * 1000 + k)
    codes = rng.integers(0, 1 << bits, size=(k, 7)).astype(np.uint32)
    want = np.asarray(jq.pack_bits(jax.numpy.asarray(codes), bits))
    got = tq.pack_bits(torch.from_numpy(codes.astype(np.int64)), bits)
    assert got.dtype == torch.int32
    assert (got.numpy().view(np.uint32) == want).all()
    back = tq.unpack_bits(got, bits, k=k)
    assert back.dtype == torch.int32 and (back.numpy() == codes).all()
    assert (tq.unpack_bits(got, bits).numpy()
            == np.asarray(jq.unpack_bits(jax.numpy.asarray(want), bits))) \
        .all()


def test_values_per_word_refuses_other_widths():
    for bits in (0, 7, 16):
        with pytest.raises(ValueError, match="bits must be one of"):
            tq.values_per_word(bits)


@pytest.mark.parametrize("bits", tq.KERNEL_BITS[1:])
@pytest.mark.parametrize("group", [32, 64])
def test_quantize_int_bit_equal_to_reference(bits, group):
    rng = np.random.default_rng(bits * 10 + group)
    w = rng.standard_normal((group * 4, 24)).astype(np.float32)
    w[:group, 3] = 0.0                                  # an all-zero group
    wq, scale = jq.quantize_int(jax.numpy.asarray(w), bits, group)
    got_q, got_s = tq.quantize_int(torch.from_numpy(w), bits, group)
    assert got_q.dtype == torch.int32
    assert (got_q.numpy() == np.asarray(wq)).all()
    assert (got_s.numpy().view(np.uint32)
            == np.asarray(scale).view(np.uint32)).all()


# --- serving/workload.py ------------------------------------------------------

def _specs(mod):
    L, A = mod.LengthDist, mod.ArrivalSpec
    out = []
    for seed, process in enumerate(("fixed", "poisson", "bursty",
                                    "diurnal")):
        out.append(mod.TraceSpec(
            seed=seed + 3, n_requests=24, vocab=97,
            prompt=L("uniform", low=4, high=12),
            output=L("constant", low=8, high=8),
            arrival=A(process, gap=3.0, burst=4)))
    out.append(mod.TraceSpec(seed=7, n_requests=10, vocab=97,
                             prompt=L("uniform", low=4, high=12),
                             output=L("constant", low=8, high=8),
                             arrival=A("bursty", gap=2.0, burst=5)))
    out.append(mod.TraceSpec(seed=5, n_requests=12, vocab=32005,
                             prompt=L("lognormal", low=2, high=64, mean=12.0),
                             arrival=A("diurnal", gap=1.5, period=16.0),
                             prefix_len=6))
    out.append(mod.spec_for_ratio(2.0, n_requests=8, output_tokens=10))
    return out


@pytest.mark.parametrize("case", range(7))
def test_workload_traces_equal_reference(case):
    ref = jwl.generate(_specs(jwl)[case])
    got = twl.generate(_specs(twl)[case])
    assert got.trace_hash == ref.trace_hash
    assert ([dataclasses.astuple(r) for r in got.requests]
            == [dataclasses.astuple(r) for r in ref.requests])
    assert got.to_json() == ref.to_json()
    again = twl.Trace.from_json(ref.to_json())
    assert again.trace_hash == ref.trace_hash
    rng = np.random.default_rng(case)
    spec = _specs(twl)[case].arrival
    arr = spec.arrival_iterations(rng, 24)
    want = _specs(jwl)[case].arrival.arrival_iterations(
        np.random.default_rng(case), 24)
    assert arr.dtype == np.int64 and (arr == want).all()


def test_workload_validation_matches_reference():
    for mod in (jwl, twl):
        with pytest.raises(ValueError, match="version"):
            mod.Trace.from_json({"version": 99, "spec": {}, "requests": []})
        with pytest.raises(ValueError, match="amplitude"):
            mod.ArrivalSpec("diurnal", amplitude=1.5)
        with pytest.raises(ValueError, match="positive"):
            mod.spec_for_ratio(-1.0)


# --- the launcher -------------------------------------------------------------

def test_serve_launcher_runs_batch_mode_on_cpu(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "4", "--batch", "2", "--cache-len", "32",
                "--mode", "batch"])
    out = capsys.readouterr().out
    assert "batch scheduling" in out and "3 requests, 12 tokens" in out
    assert "2 prefill / 6 decode" in out
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--requests",
                "3", "--max-new", "2", "--batch", "4", "--cache-len", "32",
                "--prefill-budget", "8"])
    out = capsys.readouterr().out
    assert "continuous scheduling" in out and "3 requests, 6 tokens" in out
