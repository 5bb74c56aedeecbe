"""The SLO controller in the port against the JAX reference: the
``SloController`` state machine step for step on the same seeded
observation sequences, and the controlled engine on tinymistral smoke
(uniform:4, int8 KV) under an SLO the full pool cannot meet: the same
sheds, shrinks, batch cap and tokens as the reference's engine, on the
ring and on a paged pool whose free blocks bind the cap; a forced-drift
replan through the tap, a quiet run under a feasible SLO and a
deterministic replay."""
import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import sail_linear as jsl
from repro.planning import Slo as JSlo
from repro.serving import control as jcontrol
from repro.serving import engine as jengine
from repro.serving.workload import ArrivalSpec, LengthDist, TraceSpec, \
    generate
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.planning import Slo as TSlo
from repro_torch.serving import control as tcontrol
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

# --- the state machine ----------------------------------------------------------

KNOBS = [
    dict(check_every=1, deadband=0.25, hysteresis=2, cooldown=0, window=1,
         warmup=0),
    dict(check_every=2, deadband=0.1, hysteresis=1, cooldown=5, window=4,
         warmup=2),
    dict(check_every=3, deadband=0.0, hysteresis=3, cooldown=0, window=8,
         warmup=1, anchor=False, min_batch=2),
    dict(shed=False, resolve_hit_delta=0.0),
]


@pytest.mark.parametrize("knobs", [
    True, {"deadband": 0.5}, {"check_every": 0}, {"hysteresis": 0},
    {"deadband": -0.1}, {"cooldown": -1}, {"window": 0}, {"min_batch": 0},
    {"resolve_hit_delta": -1.0}, "yes"])
def test_config_coerce_and_validation_match_reference(knobs):
    def build(mod):
        try:
            return dataclasses.asdict(mod.ControllerConfig.coerce(knobs))
        except (TypeError, ValueError) as err:
            return type(err).__name__
    assert build(tcontrol) == build(jcontrol)
    assert tcontrol.ACTIONS == jcontrol.ACTIONS


def _pair(knobs, tokens_per_iter, hit):
    """The same controller in both packages over t_iter(b) = 0.05 + 0.03 b
    and an SLO whose budget (40 / 8 = 0.2 s) it meets through b = 5."""
    t_iter = lambda b: 0.05 + 0.03 * b
    return [mod.SloController(mod.ControllerConfig(**knobs),
                              slo=slo(40.0, batch=8), iter_seconds=t_iter,
                              planned_tps=120.0, plan_hit_rate=hit,
                              tokens_per_iter=tokens_per_iter)
            for mod, slo in ((tcontrol, TSlo), (jcontrol, JSlo))]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("knobs", KNOBS, ids=range(len(KNOBS)))
def test_controller_step_for_step(knobs, seed):
    """A seeded sequence of observations (occupancy, seconds drawn around
    the model with a drift that grows in steps), cap queries under pool
    and free-block bounds, sheds, decisions, actions and a plan change:
    every return value and the stats after every step equal the
    reference's."""
    rng = np.random.default_rng(seed)
    tokens_per_iter = float(rng.choice([1.0, 2.6]))
    ctls = _pair(knobs, tokens_per_iter, hit=0.5)
    it = 0
    for step in range(120):
        op = rng.integers(0, 10)
        if op < 6:
            it += 1
            occ = int(rng.integers(1, 9))
            secs = (0.05 + 0.03 * occ) * (1 + step / 60) \
                * float(rng.uniform(0.9, 1.1))
            args = ("observe", occ, secs, it)
        elif op == 6:
            free = None if rng.integers(0, 2) else int(rng.integers(0, 9))
            args = ("batch_cap", int(rng.integers(1, 9)), free)
        elif op == 7:
            args = ("decide", float(rng.uniform(0.4, 0.6)), None)
        elif op == 8:
            args = ("acted", str(rng.choice(["replan", "resolve",
                                             "skipped"])), it)
        else:
            args = ("record_shed", int(rng.integers(1, 3)))
        outs = [getattr(c, args[0])(*args[1:]) for c in ctls]
        assert outs[0] == outs[1], (step, args)
        assert ctls[0].stats() == ctls[1].stats(), (step, args)
        assert ctls[0].meets_slo_at(3) == ctls[1].meets_slo_at(3)
        if step == 70:
            for c in ctls:
                c.plan_changed(iter_seconds=lambda b: 0.04 + 0.02 * b,
                               planned_tps=150.0, tokens_per_iter=1.5)
    assert ctls[0].checks == ctls[1].checks > 0
    assert ctls[0].actions == ctls[1].actions


# --- the engine -----------------------------------------------------------------

ENGINE = dict(batch_size=4, cache_len=64, quantize=True, ql=4, group_size=32)


def _reference_tree(tree):
    """A port tree as the reference's: jnp leaves, quantized leaves as the
    reference's QTensor / StackedQTensor (int32 words back to uint32)."""
    if isinstance(tree, dict):
        return {k: _reference_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_reference_tree(v) for v in tree)
    if isinstance(tree, (tsl.QTensor, tsl.StackedQTensor)):
        cls = (jsl.QTensor if isinstance(tree, tsl.QTensor)
               else jsl.StackedQTensor)
        return cls(packed=jnp.asarray(tree.packed.numpy().view(np.uint32)),
                   scales=jnp.asarray(tree.scales.numpy()),
                   codebook=jnp.asarray(tree.codebook.numpy()),
                   bits=tree.bits, group_size=tree.group_size, k=tree.k,
                   abits=tree.abits)
    return jnp.asarray(tree.numpy())


@pytest.fixture(scope="module")
def tiny():
    """Seeded smoke weights in both packages.  The reference quantizes
    eagerly, seconds a tree at smoke size, and the port's quantization is
    bit-equal to it (tests/test_torch_plan.py, test_torch_quant.py), so
    the reference's engines here are handed the port's uniform:4 tree
    carried across (any other policy still goes through the reference's
    ``quantize_params``)."""
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    carried = tlm.init_params(tcfg, torch.Generator().manual_seed(0),
                              device="cpu")
    raw = _reference_tree(carried)
    policy = dict(bits=4, group_size=32, min_size=1024)
    tq, b0, b1 = tsl.quantize_params(carried, tsl.QuantPolicy(**policy))
    made = {jsl.QuantPolicy(**policy): (_reference_tree(tq), b0, b1)}
    quantize = jsl.quantize_params

    def carried_across(params, policy=jsl.QuantPolicy()):
        if params is raw and policy in made:
            return made[policy]
        return quantize(params, policy)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jengine, "quantize_params", carried_across)
        yield jcfg, tcfg, raw, carried


def bursty_trace(seed=7, n=10):
    return generate(TraceSpec(
        seed=seed, n_requests=n, vocab=255,
        prompt=LengthDist("uniform", low=4, high=12),
        output=LengthDist("constant", low=6, high=6),
        arrival=ArrivalSpec("bursty", gap=2.0, burst=5)))


def drive(eng, trace):
    """Submit each request at its arrival iteration and step to the end."""
    pending = sorted(trace.requests, key=lambda r: r.arrival_iteration)
    i = 0
    while i < len(pending) or not eng.sched.idle():
        while (i < len(pending)
               and pending[i].arrival_iteration <= eng.iterations):
            eng.submit(list(pending[i].prompt), pending[i].max_new_tokens)
            i += 1
        if not eng.step() and i < len(pending):
            eng.submit(list(pending[i].prompt), pending[i].max_new_tokens)
            i += 1
    return eng


def _tengine(tiny, **kw):
    _, tcfg, _, carried = tiny
    return TEngine(carried, tcfg, TEngineConfig(**ENGINE, **kw),
                   device="cpu")


def _tokens(eng):
    return {u: c.tokens for u, c in eng.completions.items()}


PAGED = dict(kv_block_size=8, kv_pool_blocks=16, share_prefix=False)


@pytest.mark.parametrize("pool", ["ring", "paged"])
def test_controller_sheds_as_the_reference(tiny, pool):
    """An SLO 1.5x the plan's own modeled tokens/s: the full pool is
    infeasible, the cap shrinks and the burst's excess admissions are
    shed (deferred, never dropped), with the reference's counts, cap and
    tokens.  On the paged pool (two lanes' worth of blocks) the free
    blocks bind the cap below the SLO's."""
    jcfg, _, params, _ = tiny
    kw = PAGED if pool == "paged" else {}
    planned = _tengine(tiny, plan="uniform:4").planned_tps()
    fields = dict(plan="uniform:4", slo=planned * 1.5, controller=True, **kw)
    trace = bursty_trace()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the engines warn: SLO not met
        jeng = drive(jengine.Engine(params, jcfg, jengine.EngineConfig(
            **ENGINE, **fields)), trace)
        teng = drive(_tengine(tiny, **fields), trace)
    tst, jst = teng.stats(), jeng.stats()
    assert planned == pytest.approx(jengine.Engine(
        params, jcfg, jengine.EngineConfig(**ENGINE, plan="uniform:4"))
        .planned_tps(), rel=1e-12)
    assert tst["requests"] == len(trace.requests)
    c = tst["controller"]
    for key in ("batch_cap", "shed", "shrink", "replan", "resolve"):
        assert c[key] == jst["controller"][key], key
    assert c["batch_cap"] < 4 and c["shrink"] >= 1 and c["shed"] >= 1
    assert teng.controller.meets_slo_at(c["batch_cap"]) is True
    assert _tokens(teng) == _tokens(jeng)
    if pool == "paged":
        assert teng._block_free_cap() == jeng._block_free_cap()
        assert teng.stats()["block_pool"]["used_blocks"] == 0


def test_block_free_cap_binds(tiny):
    """Without an SLO the controller's cap is the memory bound alone: on a
    pool of one lane's blocks the free blocks cap occupancy below the
    pool's 4 lanes, every cap applied stays within them, and every request
    completes."""
    trace = bursty_trace(seed=5, n=8)
    eng = _tengine(tiny, plan="uniform:4", controller=True,
                   **dict(PAGED, kv_pool_blocks=8))
    seen = []
    batch_cap = eng.controller.batch_cap

    def spy(pool, free_cap=None):
        cap = batch_cap(pool, free_cap=free_cap)
        seen.append((free_cap, cap))
        return cap
    eng.controller.batch_cap = spy
    drive(eng, trace)
    assert min(f for f, _ in seen) < 4
    assert all(cap == max(min(4, f), 1) for f, cap in seen)
    assert eng.stats()["requests"] == len(trace.requests)
    assert eng.stats()["controller"]["shrink"] == 0


def test_stats_drift_without_controller(tiny):
    eng = _tengine(tiny, plan="uniform:4")
    eng.submit([1, 2, 3], max_new_tokens=4)
    eng.run()
    st = eng.stats()
    assert st["controller"] is None and st["speculative"] is None
    assert st["measured_tps"] > 0 and st["planned_tps"] > 0
    assert st["modeled_run_tps"] is not None and st["drift"] is not None


def test_controller_quiet_when_slo_feasible(tiny):
    """A comfortably feasible SLO: no occupancy action, and no replan on
    steady traffic with the tap attached."""
    planned = _tengine(tiny, plan="uniform:4").planned_tps()
    trace = generate(TraceSpec(
        seed=11, n_requests=6, vocab=255,
        prompt=LengthDist("constant", low=6, high=6),
        output=LengthDist("constant", low=8, high=8),
        arrival=ArrivalSpec("fixed", gap=3.0)))
    eng = drive(_tengine(tiny, plan="uniform:4", slo=planned * 0.5,
                         controller=True, tap_capacity=32), trace)
    c = eng.stats()["controller"]
    assert c["batch_cap"] == 4 and c["shed"] == 0 and c["shrink"] == 0
    assert c["replan"] == 0 and c["resolve"] == 0


def test_controller_replans_on_forced_drift(tiny):
    """A zero deadband puts every check after the anchor out of band: the
    drift loop replans through the tap, on the engine's device."""
    knobs = {"deadband": 0.0, "check_every": 1, "hysteresis": 1,
             "cooldown": 0, "warmup": 1}
    eng = drive(_tengine(tiny, plan="uniform:4", controller=knobs,
                         tap_capacity=32), bursty_trace(n=6))
    c = eng.stats()["controller"]
    assert c["replan"] + c["resolve"] >= 1 and c["checks"] >= 1
    assert eng.replan_count >= 1 and eng.stats()["plan_hash"] is not None
    # without a tap the same drift is recorded as skipped
    eng = drive(_tengine(tiny, plan="uniform:4", controller=knobs),
                bursty_trace(n=6))
    c = eng.stats()["controller"]
    assert c["skipped"] >= 1 and c["replan"] + c["resolve"] == 0


def test_controlled_replay_is_deterministic(tiny):
    trace = bursty_trace(seed=3, n=8)
    outs = []
    for _ in range(2):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            eng = drive(_tengine(tiny, plan="uniform:4", controller=True,
                                 tap_capacity=32), trace)
        outs.append(_tokens(eng))
    assert outs[0] == outs[1]


def test_controller_warns_and_stays_off_in_batch_mode(tiny):
    with pytest.warns(UserWarning, match="controller is ignored"):
        eng = _tengine(tiny, plan="uniform:4", controller=True,
                       mode="batch")
    assert eng.controller is None
    with pytest.raises(TypeError, match="controller must be"):
        _tengine(tiny, plan="uniform:4", controller="yes")


def test_serve_launcher_controller(capsys):
    from repro_torch.launch import serve
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--requests", "3", "--max-new", "3", "--batch", "4",
                    "--cache-len", "32", "--plan", "uniform:4,draft=q2:k2",
                    "--slo", "1e9", "--controller", "--deadband", "0.5",
                    "--check-every", "2", "--cooldown", "4"])
    out = capsys.readouterr().out
    assert "3 requests, 9 tokens" in out
    assert "speculative: draft q2, k=2" in out
    assert "controller: batch cap 1," in out
