"""The port's planning slice against the JAX reference on tinymistral
smoke (4 layers, so a plan can cut the stack into three segments): the
plan grammar and JSON with equal ``spec_hash``; per-path and per-layer
quantization bit for bit, with the same segment bounds and byte counts;
segmented prefill and decode logits; the engine's greedy tokens under
rules and solved per-layer plans, ring and paged, int8 and f32 KV; the
cost model, the PRT simulation and the bit-serial LUT-GEMV oracle.  Every
input comes from a fixed seed and reaches both packages through numpy."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro import planning as jplanning
from repro.core import cost_model as jcm
from repro.core import lut_gemv as jlg
from repro.core import pattern as jpattern
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.planning import cost as jcost
from repro.planning.spec import PlanSpec as JPlanSpec
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import planning as tplanning
from repro_torch.convert import params_from_numpy
from repro_torch.core import cost_model as tcm
from repro_torch.core import lut_gemv as tlg
from repro_torch.core import pattern as tpattern
from repro_torch.core.quant import QTensor
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.planning import cost as tcost
from repro_torch.planning.spec import PlanSpec as TPlanSpec
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_torch_model.py's
REL = 1e-9                                 # cost-model figures
BASE = dict(group_size=32, min_size=1024)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9], [3, 1, 4, 1, 5], [2, 7, 1]]

# --- plans ------------------------------------------------------------------

# plan R: rules, no segments; lm_head falls to the default (8 bits, f32)
PLAN_R = "rules:w_gate|w_up=2,w_down=3,wq|wk|wv=6a6,wo=5a4,default=8"
ATTN = [f"['blocks']['attn']['{m}']" for m in ("wq", "wk", "wv", "wo")]
MLP = [f"['blocks']['mlp']['{m}']" for m in ("w_gate", "w_up")]
DOWN = "['blocks']['mlp']['w_down']"


def _per_layer(a, b, c):
    """Segments [0, 1), [1, 3), [3, 4) of the 4-layer stack."""
    return [a, b, b, c]


def plan_s(acts=False, kv=32):
    """Plan S: a solved auto plan in three segments; with ``acts``, plan
    S-a's activation allocation on the MLP too."""
    w = {p: _per_layer(8, 4, 6) for p in ATTN}
    w.update({p: _per_layer(5, 3, 4) for p in MLP})
    w[DOWN] = _per_layer(6, 4, 8)
    w["['lm_head']"] = 6
    spec = {"version": 1, "mode": "auto", "weight_bits": 4, "act_bits": None,
            "nbw": "auto", "prt": "paper", "quant_kv": True,
            "weights_per_unit": w}
    if kv is not None:
        spec["kv_bits"] = kv
    if acts:
        spec["acts_per_unit"] = {p: _per_layer(8, 6, 4) for p in MLP + [DOWN]}
    return spec


PLANS = {"R": PLAN_R, "S": plan_s(), "S-a": plan_s(acts=True)}
# the allocation of tests/test_mixed_precision.py's engine test, which
# fails on the reference itself: the port is held to the reference's
# tokens (ROADMAP, Queue 3)
MIXED_68 = {"version": 1, "mode": "auto", "weight_bits": 8, "act_bits": None,
            "nbw": "auto", "prt": "paper", "quant_kv": False,
            "weights_per_unit": {DOWN: [6, 8]}}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def smoke4():
    """The smoke config at 4 layers, the reference's random weights, and
    the same tree carried across."""
    jcfg = dataclasses.replace(JC.get_smoke(ARCH), n_layers=4)
    tcfg = dataclasses.replace(TC.get_smoke(ARCH), n_layers=4)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params, _carry(params)


def _carry(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _policies(plan):
    """The reference's and the port's policy of one plan."""
    jp = jplanning.as_plan(plan).to_policy(jsl.QuantPolicy(bits=4, **BASE))
    tp = tplanning.as_plan(plan).to_policy(tsl.QuantPolicy(bits=4, **BASE))
    return jp, tp


# --- PlanSpec ---------------------------------------------------------------

DOCUMENTED_SPECS = [                      # tests/test_planning.py's
    "uniform:4",
    "uniform:4a8",
    "uniform:6",
    "rules:mlp=3,attn=5,default=4",
    "rules:mlp=4a6,attn=5a8,default=6a8",
    "rules:attn=5a6,mlp=3",
    "auto:q4",
    "auto:4.5bpw",
    "auto:q4a8",
    "auto:q4a8,prt=measured,maxseg=4",
    "auto:q4a8,prt=measured,slo=120",
]
SPECS = DOCUMENTED_SPECS + ["uniform:3a6,kv=32",
                            "uniform:4,draft=q2a8:k4,tp=2,wire=8", PLAN_R]


@pytest.mark.parametrize("spec", SPECS)
def test_planspec_grammar_json_and_hash_match(spec):
    ref, got = JPlanSpec.parse(spec), TPlanSpec.parse(spec)
    assert got.format() == ref.format()
    assert TPlanSpec.parse(got.format()) == got
    assert got.to_json() == ref.to_json()
    assert TPlanSpec.from_json(got.to_json()) == got
    assert got.spec_hash == ref.spec_hash
    assert got.solved == ref.solved
    if got.draft is None:
        assert got.to_legacy_dict() == ref.to_legacy_dict()
        assert TPlanSpec.from_legacy_dict(got.to_legacy_dict()).format() \
            == JPlanSpec.from_legacy_dict(ref.to_legacy_dict()).format()


@pytest.mark.parametrize("name", ["S", "S-a"])
def test_solved_plan_json_hash_and_policy_match(name, tmp_path):
    spec = PLANS[name]
    ref, got = JPlanSpec.from_json(spec), TPlanSpec.from_json(spec)
    assert got.solved and got.spec_hash == ref.spec_hash
    assert got.to_json() == ref.to_json()
    got.save(str(tmp_path / "plan.json"))
    loaded = tplanning.plan_from_arg(str(tmp_path / "plan.json"))
    assert loaded == got and loaded.spec_hash == ref.spec_hash
    jpol, tpol = _policies(spec)
    assert tpol.to_spec() == jpol.to_spec()
    assert tpol.is_mixed() and jpol.is_mixed()
    back = TPlanSpec.from_policy(tpol, quant_kv=True)
    assert back.spec_hash == JPlanSpec.from_policy(jpol).spec_hash
    assert json.loads(json.dumps(got.to_json())) == got.to_json()


# --- quantize_params ----------------------------------------------------------

def _same(a, b):
    """Port tree ``a`` equals the carried reference tree ``b`` bit for
    bit, QTensor statics included."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for key in a:
            _same(a[key], b[key])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (QTensor, tsl.StackedQTensor)):
        assert type(a) is type(b)
        assert (a.bits, a.group_size, a.k, a.abits) == (
            b.bits, b.group_size, b.k, b.abits)
        for f in ("packed", "scales", "codebook"):
            assert torch.equal(getattr(a, f), getattr(b, f)), f
    else:
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def quantized(smoke4):
    """Each plan's reference quantization, carried across, and the
    port's own."""
    jcfg, tcfg, params, carried = smoke4
    out = {}
    for name, plan in PLANS.items():
        jpol, tpol = _policies(plan)
        jq = jsl.quantize_params(params, jpol)
        tq = tsl.quantize_params(carried, tpol)
        out[name] = (jpol, tpol, jq, _carry(jq[0]), tq)
    return out


@pytest.mark.parametrize("name", list(PLANS))
def test_quantize_params_bit_equal_with_segments(smoke4, quantized, name):
    _, _, params, carried = smoke4
    jpol, tpol, jq, carried_q, tq = quantized[name]
    assert tq[1:] == jq[1:]                       # bytes before / after
    assert tsl._segment_bounds(carried, tpol) == jsl._segment_bounds(
        params, jpol)
    _same(tq[0], carried_q)
    if name == "R":
        assert isinstance(tq[0]["blocks"], dict)
        blocks = tq[0]["blocks"]
        assert (blocks["attn"]["wq"].bits, blocks["attn"]["wq"].abits) == \
            (6, 6)
        assert (blocks["attn"]["wo"].bits, blocks["attn"]["wo"].abits) == \
            (5, 4)
        assert (blocks["mlp"]["w_up"].bits, blocks["mlp"]["w_down"].bits) \
            == (2, 3)
        assert (tq[0]["lm_head"].bits, tq[0]["lm_head"].abits) == (8, None)
    else:
        assert tsl._segment_bounds(carried, tpol) == [0, 1, 3, 4]
        segs = tq[0]["blocks"]
        assert [s["attn"]["wq"].bits for s in segs] == [8, 4, 6]
        assert [s["mlp"]["w_down"].bits for s in segs] == [6, 4, 8]
        assert [s["mlp"]["w_gate"].abits for s in segs] == (
            [8, 6, 4] if name == "S-a" else [None] * 3)
        assert [s["attn_norm"]["scale"].shape[0] for s in segs] == [1, 2, 1]
        assert tq[0]["lm_head"].bits == 6


def test_params_from_numpy_carries_segments(quantized):
    """A reference tree whose ``blocks`` is a list of segments converts to
    a list of segment trees of StackedQTensors with their own bits."""
    carried = quantized["S-a"][3]
    segs = carried["blocks"]
    assert isinstance(segs, list) and len(segs) == 3
    for seg, (bits, abits) in zip(segs, [(5, 8), (3, 6), (4, 4)]):
        st = seg["mlp"]["w_up"]
        assert isinstance(st, tsl.StackedQTensor)
        assert (st.bits, st.abits) == (bits, abits)
        assert st.packed.dtype == torch.int32
    assert tlm.n_layers(carried) == 4
    assert [i for i, _ in tlm.iter_layers(carried)] == [0, 1, 2, 3]


def test_policy_resolution_matches(smoke4):
    jpol, tpol = _policies(PLANS["S-a"])
    for path in ATTN + MLP + [DOWN, "['lm_head']", "['embed']"]:
        assert tpol.bits_for(path) == jpol.bits_for(path)
        assert tpol.abits_for(path) == jpol.abits_for(path)
    rules_j, rules_t = _policies(PLAN_R)
    for path in ATTN + MLP + [DOWN, "['lm_head']"]:
        assert rules_t.bits_for(path) == rules_j.bits_for(path)
        assert rules_t.abits_for(path) == rules_j.abits_for(path)
    # an explicit codebook of the wrong size raises as in the reference
    pol = tsl.QuantPolicy(bits=4, rules=(("mlp", 3),),
                          codebook=tsl.nf_codebook(4), **BASE)
    with pytest.raises(ValueError, match="callable codebook factory"):
        tsl.quantize_params(smoke4[3], pol)
    nf = tsl.QuantPolicy(bits=4, rules=(("mlp", 3),), codebook=tsl.nf_codebook,
                         **BASE)
    jnf = jsl.QuantPolicy(bits=4, rules=(("mlp", 3),),
                          codebook=jsl.nf_codebook, **BASE)
    _same(tsl.quantize_params(smoke4[3], nf)[0],
          _carry(jsl.quantize_params(smoke4[2], jnf)[0]))
    assert tsl.QuantPolicy.from_spec(nf.to_spec()).to_spec() == jnf.to_spec()


# --- segmented model ------------------------------------------------------------

def _kv_codes_within_one(tcache, jcache):
    """The int8 KV caches' codes differ by at most one (a code at a
    rounding tie may go either way: the two packages sum K and V in
    another f32 order); True when they are identical."""
    same = True
    for name in ("k", "v"):
        got = tcache["layers"][name].numpy().astype(int)
        ref = np.asarray(jcache["layers"][name]).astype(int)
        assert np.abs(got - ref).max() <= 1
        same = same and np.array_equal(got, ref)
        np.testing.assert_allclose(tcache["layers"][name + "_scale"].numpy(),
                                   np.asarray(jcache["layers"][name
                                                               + "_scale"]),
                                   **LOGIT_TOL)
    return same


@pytest.mark.parametrize("name", ["S", "S-a"])
@pytest.mark.parametrize("quant_kv", [False, True], ids=["f32kv", "int8kv"])
def test_segmented_prefill_and_decode_logits_match(smoke4, quantized, name,
                                                   quant_kv):
    """Layers 1-3 live in segments that start past layer 0: each must
    read and write its absolute layer of the KV pool.  With int8 KV the
    codes are held within one and the logits wherever the two caches hold
    the same codes: once a code at a rounding tie went the other way (it
    does here: under plan S at lane 0's tenth slot in layer 0, k / scale
    = -3.50000; under S-a the 4-bit activation codes flip first), the two
    runs attend over different K and their logits part by up to ~1e-3."""
    jcfg, tcfg, _, _ = smoke4
    _, _, jq, carried_q, _ = quantized[name]
    jp = jq[0]
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab, size=(2, 9))
    lengths = np.array([9, 6], np.int32)
    jl, jcache = jlm.prefill(jp, jnp.asarray(prompt), jcfg, 32, quant_kv,
                             lengths=jnp.asarray(lengths))
    tl, tcache = tlm.prefill(carried_q, prompt, tcfg, 32, quant_kv,
                             lengths=lengths, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    held = 0
    same = not quant_kv or _kv_codes_within_one(tcache, jcache)
    for _ in range(3):
        jl, jcache = jlm.decode_step(jp, jnp.asarray(tok), jcache, jcfg,
                                     quant_kv)
        tl, tcache = tlm.decode_step(carried_q, tok, tcache, tcfg, quant_kv,
                                     device="cpu")
        same = same and (not quant_kv
                         or _kv_codes_within_one(tcache, jcache))
        if same:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       **LOGIT_TOL)
            held += 1
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    assert held == 3 or quant_kv
    if not quant_kv:
        np.testing.assert_allclose(tcache["layers"]["k"].numpy(),
                                   np.asarray(jcache["layers"]["k"]),
                                   **LOGIT_TOL)


# --- the engine -------------------------------------------------------------------

ENGINE = dict(batch_size=4, cache_len=64, ql=4, **BASE)
PAGED = dict(kv_block_size=8, kv_pool_blocks=32, share_prefix=False)


def _serve(engine, max_new=6):
    uids = [engine.submit(list(p), max_new) for p in PROMPTS]
    engine.run()
    return {u: engine.completions[u].tokens for u in uids}


def _with_kv(plan, kv):
    if isinstance(plan, str):
        return f"{plan},kv={kv}" if plan.startswith("uniform") else plan
    return {**plan, "kv_bits": kv}


ENGINE_CASES = [("R", 8), ("R", 32), ("S", 8), ("S", 32)]


@pytest.fixture(scope="module")
def ref_engines(smoke4):
    """The reference's ring engine per (plan, KV bits): its tokens and
    stats.  Plan R's KV precision comes from ``quant_kv`` (a rules plan
    has no ``kv=`` option)."""
    jcfg, _, params, _ = smoke4
    out = {}
    for name, kv in ENGINE_CASES:
        eng = JEngine(params, jcfg, JEngineConfig(
            **ENGINE, plan=_with_kv(PLANS[name], kv), quant_kv=kv == 8))
        out[name, kv] = (_serve(eng), eng.stats())
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["ring", "paged"])
@pytest.mark.parametrize("name, kv", ENGINE_CASES,
                         ids=[f"{n}-kv{k}" for n, k in ENGINE_CASES])
def test_engine_tokens_match_reference(smoke4, ref_engines, name, kv, paged):
    _, tcfg, _, carried = smoke4
    ref, jst = ref_engines[name, kv]
    eng = TEngine(carried, tcfg, TEngineConfig(
        **ENGINE, plan=_with_kv(PLANS[name], kv), quant_kv=kv == 8,
        **(PAGED if paged else {})), device="cpu")
    got = _serve(eng)
    assert got == ref
    st = eng.stats()
    assert st["kv_bits"] == jst["kv_bits"] == kv
    assert eng.cache["layers"]["k"].dtype == (torch.int8 if kv == 8
                                              else torch.float32)
    for key in ("plan_hash", "plan_mode", "mixed_precision",
                "weight_compression", "plan_calibrated", "decode_iterations"):
        assert st[key] == jst[key], key
    assert st["planned_tps"] == pytest.approx(jst["planned_tps"], rel=REL)
    assert st["modeled_run_tps"] == pytest.approx(jst["modeled_run_tps"],
                                                  rel=REL)
    assert isinstance(eng.params["blocks"], list) == (name == "S")


def test_engine_holds_the_failing_reference_allocation(smoke4):
    """tests/test_mixed_precision.py's 6/8-bit segmented engine differs
    from the f32 engine on the reference itself (a near-tie argmax on a
    random model); the port must give the reference's tokens."""
    jcfg, tcfg, params, carried = smoke4
    jcfg2 = dataclasses.replace(jcfg, n_layers=2)
    tcfg2 = dataclasses.replace(tcfg, n_layers=2)
    params2 = jlm.init_params(jax.random.PRNGKey(0), jcfg2)
    fields = dict(batch_size=4, cache_len=64, ql=8, group_size=32,
                  quant_kv=False, plan=MIXED_68)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]

    def serve(engine):
        for p in prompts:
            engine.submit(p, 8)
        return {c.uid: c.tokens for c in engine.run()}

    ref_eng = JEngine(params2, jcfg2, JEngineConfig(**fields))
    eng = TEngine(_carry(params2), tcfg2, TEngineConfig(**fields),
                  device="cpu")
    assert serve(eng) == serve(ref_eng)
    assert isinstance(eng.params["blocks"], list)
    assert eng.stats()["mixed_precision"] and eng.stats()["kv_bits"] == 32


def test_engine_plan_forms_and_slo(smoke4):
    """A PlanSpec, a grammar string and a JSON dict serve the same plan;
    an SLO prices it on the SAIL machine model (a warning below it)."""
    _, tcfg, _, carried = smoke4
    hashes = set()
    for plan in (TPlanSpec.from_json(PLANS["S"]), PLANS["S"],
                 json.loads(json.dumps(PLANS["S"]))):
        eng = TEngine(carried, tcfg, TEngineConfig(**ENGINE, plan=plan),
                      device="cpu")
        hashes.add(eng.stats()["plan_hash"])
    assert hashes == {JPlanSpec.from_json(PLANS["S"]).spec_hash}
    planned = eng.planned_tps()
    with pytest.warns(UserWarning, match="SAIL machine"):
        TEngine(carried, tcfg, TEngineConfig(**ENGINE, plan=PLANS["S"],
                                             slo=planned * 2), device="cpu")
    ok = TEngine(carried, tcfg, TEngineConfig(**ENGINE, plan=PLANS["S"],
                                              slo=planned / 2), device="cpu")
    assert ok.slo.batch == ENGINE["batch_size"]


def test_unservable_plans_name_the_roadmap(smoke4):
    """Unsolved plans solve at construction (auto modes, kv=auto, tp=auto,
    one shard without an SLO, and a bare SLO), and draft plans serve
    speculative decoding: a concrete draft as given, draft=auto as the
    Planner's own solve.  tp > 1 still raises, naming its ROADMAP item."""
    _, tcfg, _, carried = smoke4
    for plan in ("auto:q4a8", "uniform:4,kv=auto", "uniform:4,tp=auto",
                 {**PLANS["S"], "kv_bits": "auto"}):
        eng = TEngine(carried, tcfg, TEngineConfig(**ENGINE, plan=plan),
                      device="cpu")
        assert eng.plan.solved and eng.plan.kv_bits in (8, 32, None)
        assert eng.plan.tp in (1, None) and eng.kv_bits in (8, 32)
    assert TEngine(carried, tcfg, TEngineConfig(**ENGINE,
                                                plan="uniform:4,tp=auto"),
                   device="cpu").plan.tp == 1
    eng = TEngine(carried, tcfg, TEngineConfig(**ENGINE, slo=100.0),
                  device="cpu")
    assert eng.plan.solved and eng.plan.mode == "auto"
    assert eng.plan.target_tps == 100.0 and eng.plan.prt == "measured"
    # draft plans are servable, with the reference's spec_hash (the engines
    # that serve them are held in tests/test_torch_speculative.py)
    for plan in ("uniform:4,draft=q2a8:k4", "uniform:4,draft=auto"):
        spec = TPlanSpec.parse(plan)
        assert spec.spec_hash == JPlanSpec.parse(plan).spec_hash
    # a tp=2 plan is servable over a group of 2 ranks (tests/test_torch_tp.py);
    # outside one the engine refuses it, as the reference's refuses it
    # without 2 devices
    with pytest.raises(ValueError, match="needs a process group of 2 ranks"):
        TEngine(carried, tcfg, TEngineConfig(**ENGINE, plan="uniform:4,tp=2"),
                device="cpu")
    with pytest.raises(ValueError, match="Planner"):
        TPlanSpec.parse("auto:q4").to_policy()


# --- cost model ----------------------------------------------------------------

def _close(a, b):
    assert a == pytest.approx(b, rel=REL, abs=0.0)


def _cost_fields(c):
    return (c.cycles, c.quant_bytes, c.fixed_bytes, c.t_compute, c.t_dram,
            c.t_wire, c.seconds_per_iteration, c.tokens_per_second)


@pytest.mark.parametrize("name", list(PLANS) + ["uniform:3a6"])
@pytest.mark.parametrize("prt", ["paper", "off", "measured"])
def test_decode_cost_model_matches(smoke4, name, prt):
    _, _, params, carried = smoke4
    jpol, tpol = _policies(PLANS.get(name, name))
    units = tcost.policy_units(carried, tpol)
    assert units == jcost.policy_units(params, jpol)
    assert tcost.unquantized_bytes(carried, tpol) == jcost.unquantized_bytes(
        params, jpol)
    for batch in (None, 3):
        jm = jcost.DecodeCostModel(prt=prt if prt != "off" else False)
        tm = tcost.DecodeCostModel(prt=prt if prt != "off" else False)
        for a, b in zip(_cost_fields(tm.evaluate(carried, tpol, batch)),
                        _cost_fields(jm.evaluate(params, jpol, batch))):
            _close(a, b)
    slo_t, slo_j = tcost.Slo(50.0, batch=8), jcost.Slo(50.0, batch=8)
    fixed = tcost.unquantized_bytes(carried, tpol)
    for a, b in zip(dataclasses.astuple(tm.budgets(slo_t, fixed)),
                    dataclasses.astuple(jm.budgets(slo_j, fixed))):
        _close(a, b)


def test_cost_model_variants_match(smoke4):
    """The knobs the engine does not reach by default: a fixed NBW, a
    fitted machine and dispatch table, tensor-parallel wire pricing and
    speculative rounds."""
    _, _, params, carried = smoke4
    jpol, tpol = _policies(PLANS["S-a"])
    units = tcost.policy_units(carried, tpol)
    cal = {"machine_overrides": {"lookup_base_cycles": 20.0, "dram_bw": 1e11,
                                 "freq_hz": 1.0},
           "dispatch_cycles": {"2:8": 500.0, "4:6": 250.0}}
    from repro.planning import calibrate_cost as jcal
    assert tcost.machine_from_json(cal) == tcm.SailMachine(
        **dataclasses.asdict(jcal.machine_from_json(cal)))
    assert tcost.dispatch_from_json(cal) == jcal.dispatch_from_json(cal)
    kws = [dict(nbw=2), dict(nbw=4, prt="measured"),
           dict(tp=2, wire_bits=8, allreduce_elems=2 * 4 * 64.0),
           dict(dispatch_cycles=tcost.dispatch_from_json(cal))]
    for kw in kws:
        jkw = dict(kw)
        tm, jm = tcost.DecodeCostModel(**kw), jcost.DecodeCostModel(**jkw)
        for a, b in zip(_cost_fields(tm.evaluate(carried, tpol)),
                        _cost_fields(jm.evaluate(params, jpol))):
            _close(a, b)
    tm, jm = tcost.DecodeCostModel(), jcost.DecodeCostModel()
    fixed = tcost.unquantized_bytes(carried, tpol)
    _close(tcost.speculative_round_seconds(tm, units, units[:3], 32, fixed, 4),
           jcost.speculative_round_seconds(jm, units, units[:3], 32, fixed, 4))
    for a, k in ((0.0, 4), (0.7, 4), (1.0, 3)):
        _close(tcost.expected_tokens_per_round(a, k),
               jcost.expected_tokens_per_round(a, k))
    cfg = smoke4[1]
    assert tcost.tp_allreduce_elems(cfg) == jcost.tp_allreduce_elems(cfg)


@pytest.mark.parametrize("calib", ["synthetic", "seeded"])
def test_prt_hit_rate_matches(calib):
    batch = (None if calib == "synthetic" else
             np.random.default_rng(5).standard_normal((8, 256)).astype(
                 np.float32))
    for nbw in (1, 2, 4):
        for abits in (4, 6, 8):
            _close(tpattern.prt_hit_rate(nbw, abits, batch),
                   jpattern.prt_hit_rate(nbw, abits, batch))
            _close(tpattern.prt_discount(nbw, abits, 3, batch),
                   jpattern.prt_discount(nbw, abits, 3, batch))
    if batch is not None:
        xq = np.random.default_rng(6).integers(-127, 128, size=(6, 64))
        _close(tpattern.vectorized_repeat_rate(xq, 4),
               jpattern.vectorized_repeat_rate(jnp.asarray(xq), 4))
        assert dataclasses.astuple(tpattern.measure_repeat_rate(xq, 2, 8)) \
            == dataclasses.astuple(jpattern.measure_repeat_rate(
                jnp.asarray(xq), 2, 8))


def test_paper_figures_and_cycle_model_match():
    """The SAIL machine model's functions, figure for figure."""
    m_t, m_j = tcm.SailMachine(), jcm.SailMachine()
    pairs = [
        (tcm.fig6_workload_cycles(24, 4, 2), jcm.fig6_workload_cycles(24, 4, 2)),
        (tcm.sail_tokens_per_second(tcm.LLAMA2_7B, 4),
         jcm.sail_tokens_per_second(jcm.LLAMA2_7B, 4)),
        (tcm.sail_tokens_per_second(tcm.TINYMISTRAL, 3, prt="measured"),
         jcm.sail_tokens_per_second(jcm.TINYMISTRAL, 3, prt="measured")),
        (tcm.arm_tokens_per_second(tcm.LLAMA2_13B, 5),
         jcm.arm_tokens_per_second(jcm.LLAMA2_13B, 5)),
        (tcm.amx_tokens_per_second(tcm.LLAMA2_7B, 8, batch=4),
         jcm.amx_tokens_per_second(jcm.LLAMA2_7B, 8, batch=4)),
        (tcm.fig1_efficiency_gain(2, 8), jcm.fig1_efficiency_gain(2, 8)),
        (tcm.lut_build_fraction(m_t, 8, 2, 2), jcm.lut_build_fraction(
            m_j, 8, 2, 2)),
        (tcm.mixed_decode_cycles([(64, 64, 3, 6, 2), (128, 64, 5)], nbw="auto",
                                 prt="measured"),
         jcm.mixed_decode_cycles([(64, 64, 3, 6, 2), (128, 64, 5)], nbw="auto",
                                 prt="measured")),
        (tcm.tokens_per_dollar(81.63, "sail_16c"),
         jcm.tokens_per_dollar(81.63, "sail_16c")),
    ]
    for a, b in pairs:
        _close(a, b)
    for key, val in jcm.gemv_breakdown().items():
        _close(tcm.gemv_breakdown()[key], val)
    assert tcm.best_nbw_for_unit(1024, 4096, 4, 8) == jcm.best_nbw_for_unit(
        1024, 4096, 4, 8)
    assert tcm.best_nbw(tcm.LLAMA2_7B, 4, 16, 8) == jcm.best_nbw(
        jcm.LLAMA2_7B, 4, 16, 8)
    assert tcm.PAPER_TABLE_II == jcm.PAPER_TABLE_II
    assert dataclasses.asdict(m_t) == dataclasses.asdict(m_j)
    assert tcm.qtensor_bytes(1024, 4096, 5) == jcm.qtensor_bytes(1024, 4096, 5)


# --- the bit-serial LUT-GEMV oracle -----------------------------------------------

@pytest.mark.parametrize("nbw", [1, 2, 3, 4])
@pytest.mark.parametrize("abits", [4, 8])
def test_lut_gemv_oracle_matches(nbw, abits):
    rng = np.random.default_rng(nbw * 10 + abits)
    qmax = (1 << (abits - 1)) - 1
    xq = rng.integers(-qmax, qmax + 1, size=(3, 38)).astype(np.int32)
    wq = rng.integers(-8, 8, size=(38, 11)).astype(np.int32)
    got = tlg.lut_gemv(torch.from_numpy(xq), torch.from_numpy(wq), nbw, abits)
    ref = jlg.lut_gemv(jnp.asarray(xq), jnp.asarray(wq), nbw, abits)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        got.numpy(), tlg.reference_int_gemv(torch.from_numpy(xq),
                                            torch.from_numpy(wq)).numpy())
    np.testing.assert_array_equal(
        tlg.activation_patterns(torch.from_numpy(xq), nbw, abits).numpy(),
        np.asarray(jlg.activation_patterns(jnp.asarray(xq), nbw, abits)))
    np.testing.assert_array_equal(
        tlg.build_luts(torch.from_numpy(wq), nbw).numpy(),
        np.asarray(jlg.build_luts(jnp.asarray(wq), nbw)))
    assert tlg.lut_gemv_op_counts(8, 64, 32, nbw, abits) == \
        jlg.lut_gemv_op_counts(8, 64, 32, nbw, abits)
    if 64 % nbw == 0:
        x = rng.standard_normal((2, 64)).astype(np.float32)
        w = rng.integers(-8, 8, size=(64, 16)).astype(np.int32)
        s = rng.random((2, 16)).astype(np.float32)
        np.testing.assert_allclose(
            tlg.lut_gemv_quantized(torch.from_numpy(x), torch.from_numpy(w),
                                   torch.from_numpy(s), nbw, abits, 32).numpy(),
            np.asarray(jlg.lut_gemv_quantized(jnp.asarray(x), jnp.asarray(w),
                                              jnp.asarray(s), nbw, abits, 32)),
            rtol=1e-5, atol=1e-5)
