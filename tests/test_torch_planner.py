"""The port's Planner slice against the JAX reference: the calibration
tokens bit for bit, the full-sequence forward and the captured decode
inputs, the activation-quant probe wrapper, the output / activation / KV
sensitivity probes score by score, the budgeted solvers fed the
reference's own scores (bit-identical allocations and equal
``spec_hash``), the segment cap, the Pareto filter, both cost-constant
fits, and the cost calibration's timing run on the CPU.  The model is the
reference tests' ``tiny`` config (tests/test_planning.py:21-36); weights
come from the reference's seed and reach the port through numpy.

Probe tolerance: every output score at rtol 1e-4 / atol 1e-9 (the scores
are logit MSEs of two f32 forwards, which differ by f32 summation order;
the worst gap measured on this config is ~1.1e-6 relative), every
activation score at rtol 1e-3 / atol 1e-9 (their 4-bit activation codes
turn such rounding differences into score differences of ~1e-4 relative
at full width on the H100, chip_smoke phase 7), the KV probe's per-layer
values at rtol 1e-3."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import calibrate as jcal
from repro.core import sensitivity as jsens
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.models.common import ModelConfig as JModelConfig
from repro.planning import Planner as JPlanner
from repro.planning import Slo as JSlo
from repro.planning import calibrate_cost as jcc
from repro.planning import resolve_plan as jresolve_plan
from repro.planning.spec import PlanSpec as JPlanSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import calibrate as tcal
from repro_torch.core import prng
from repro_torch.core import sensitivity as tsens
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.models.common import ModelConfig as TModelConfig
from repro_torch.planning import Planner as TPlanner
from repro_torch.planning import Slo as TSlo
from repro_torch.planning import calibrate_cost as tcc
from repro_torch.planning import resolve_plan
from repro_torch.planning.spec import PlanSpec as TPlanSpec

TINY = dict(name="tiny", family="dense", vocab=64, d_model=32, n_layers=2,
            n_heads=4, n_kv=2, d_ff=64, act="swiglu", attn_chunk=16,
            max_seq=128)
BASE = dict(group_size=32, min_size=1024)
SCORE_TOL = dict(rel=1e-4, abs=1e-9)
ACT_SCORE_TOL = dict(rel=1e-3, abs=1e-9)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
    jcfg, tcfg = JModelConfig(**TINY), TModelConfig(**TINY)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, carried


@pytest.fixture(scope="module")
def probes(tiny):
    """One set of probes per package on the same tokens, shared by every
    probe and solver test of this file."""
    jcfg, tcfg, params, carried = tiny
    jbase = jsl.QuantPolicy(bits=4, **BASE)
    tbase = tsl.QuantPolicy(bits=4, **BASE)
    jtoks = jsens.calibration_tokens(jcfg.vocab, 2, 16)
    ttoks = tsens.calibration_tokens(tcfg.vocab, 2, 16)
    ref = dict(scores=jsens.output_sensitivity(params, jcfg, jtoks, jbase),
               act=jsens.activation_sensitivity(params, jcfg, jtoks, jbase),
               kv=jsens.kv_sensitivity(params, jcfg, jtoks))
    stats = {}
    got = dict(scores=tsens.output_sensitivity(carried, tcfg, ttoks, tbase,
                                               stats=stats),
               act=tsens.activation_sensitivity(carried, tcfg, ttoks, tbase,
                                                 stats=stats),
               kv=tsens.kv_sensitivity(carried, tcfg, ttoks))
    return dict(jbase=jbase, tbase=tbase, jtoks=jtoks, ttoks=ttoks, ref=ref,
                got=got, stats=stats)


# --- calibration tokens, forward, capture, the probe wrapper ----------------

@pytest.mark.parametrize("vocab,shape,seed", [
    (32005, (4, 32), 0), (64, (2, 16), 0), (256, (4, 32), 3),
    (32005, (3, 7), 12345), (1000, (5,), 7)])
def test_calibration_draw_is_the_references(vocab, shape, seed):
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                        vocab))
    np.testing.assert_array_equal(prng.randint(seed, shape, 0, vocab), ref)
    if len(shape) == 2:
        got = tsens.calibration_tokens(vocab, shape[0], shape[1], seed)
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsens.calibration_tokens(
                vocab, shape[0], shape[1], seed)))


@pytest.mark.parametrize("lo,hi", [(-1, 2), (-7, 8), (-127, 128)])
def test_signed_code_draw_is_the_references(lo, hi):
    """The cost calibration's signed weight / activation codes."""
    ref = np.asarray(jax.random.randint(jax.random.PRNGKey(4), (64, 32), lo,
                                        hi, dtype=np.int32))
    np.testing.assert_array_equal(prng.randint(4, (64, 32), lo, hi), ref)


def test_forward_logits_match(tiny):
    jcfg, tcfg, params, carried = tiny
    toks = np.random.default_rng(0).integers(0, jcfg.vocab, (3, 11))
    ref, aux = jlm.forward(params, toks, jcfg)
    got, taux = tlm.forward(carried, torch.from_numpy(toks), tcfg,
                            device="cpu")
    assert got.shape == (3, 11, jcfg.vocab) and float(taux) == float(aux) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-4)


def test_decode_capture_layer_inputs_match(tiny):
    jcfg, tcfg, params, carried = tiny
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 6))
    _, jcache = jlm.prefill(params, toks, jcfg, cache_len=16)
    _, tcache = tlm.prefill(carried, toks, tcfg, cache_len=16, device="cpu")
    nxt = np.array([[3], [9]])
    jl, _, jx = jlm.decode_step(params, nxt, jcache, jcfg,
                                capture_layer_inputs=True)
    tl, _, tx = tlm.decode_step(carried, nxt, tcache, tcfg, device="cpu",
                                capture_layer_inputs=True)
    assert tx.shape == (jcfg.n_layers, 2, 1, jcfg.d_model)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)


def test_act_quant_probe_gate(tiny):
    """Gate 0 leaves x bit-equal; gate 1 is the per-token fake-quant the
    reference applies; indexing a stacked probe slices its gate."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((5, 32), generator=gen)
    w = torch.randn((3, 32, 16), generator=gen)
    probe = tsl.ActQuantWeight(w=w, gate=torch.tensor([0.0, 1.0, 0.0]),
                               abits=4)
    assert torch.equal(tsl.mm(x, probe[0]), x @ w[0])
    assert torch.equal(tsl.mm(x, probe[2]), x @ w[2])
    fq = tsl.act_fake_quant(x, 4)
    np.testing.assert_allclose(
        fq.numpy(), np.asarray(jsl.act_fake_quant(x.numpy(), 4)), rtol=1e-6,
        atol=1e-6)
    assert torch.equal(tsl.mm(x, probe[1]), (x + 1.0 * (fq - x)) @ w[1])
    _, tcfg, _, carried = tiny
    blocks = dict(carried["blocks"])
    attn = dict(blocks["attn"])
    attn["wq"] = tsl.ActQuantWeight(w=attn["wq"], gate=torch.tensor([1.0, 0.0]),
                                    abits=8)
    blocks["attn"] = attn
    lay = tlm.layer_params(blocks, 1)["attn"]["wq"]
    assert float(lay.gate) == 0.0 and lay.w.shape == (32, 32)


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 6, 8])
def test_fake_quant_is_the_quantize_dequantize_roundtrip(bits):
    """The probes' unpacked roundtrip equals ``dequantize(quantize())`` bit
    for bit and the reference's ``fake_quant`` (stacked, vmapped there),
    for the uniform and NF codebooks; the nearest-code search equals the
    full argmin, exact ties included."""
    from repro_torch.core import quant as tq
    w = np.random.default_rng(bits).standard_normal((3, 64, 48)).astype(
        np.float32)
    w[0, :32, 0] = 0.0
    tw = torch.from_numpy(w)
    for tbook, jbook in ((None, None),
                         (tq.nf_codebook(bits), jsl.nf_codebook(bits))):
        got = tsens.fake_quant(tw, bits, 32, tbook)
        assert torch.equal(got[1], tq.dequantize(tq.quantize(tw[1], bits, 32,
                                                             tbook)))
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(jsens.fake_quant(w, bits, 32, jbook)))
    book = tq._uniform_codebook(bits)
    x = torch.cat([(book[1:] + book[:-1]) / 2, torch.linspace(-1.2, 1.2, 97)])
    x = x.reshape(1, 1, -1)
    assert torch.equal(tq._nearest_codes(x, book),
                       (x[..., None] - book).abs().argmin(-1))


# --- the probes ------------------------------------------------------------------

def _assert_scores(got, ref, tol):
    assert sorted(got, key=str) == sorted(ref, key=str)
    for key in ref:
        assert sorted(got[key], key=str) == sorted(ref[key], key=str), key
        for b, r in ref[key].items():
            assert got[key][b] == pytest.approx(float(r), **tol), (key, b)


def test_output_sensitivity_matches(probes):
    _assert_scores(probes["got"]["scores"], probes["ref"]["scores"],
                   SCORE_TOL)
    # 5 units x 5 non-baseline candidates, plus the f32 and baseline runs
    assert probes["stats"]["forwards"] >= 5 * 5 + 2


def test_activation_sensitivity_matches(probes):
    _assert_scores(probes["got"]["act"], probes["ref"]["act"],
                   ACT_SCORE_TOL)


def test_kv_sensitivity_matches(probes):
    ref, got = probes["ref"]["kv"], probes["got"]["kv"]
    np.testing.assert_allclose(got["per_layer"], ref["per_layer"], rtol=1e-3)
    assert got["relative"] == pytest.approx(ref["relative"], rel=1e-3)
    for tol in (0.05, ref["relative"] * 0.5, ref["relative"] * 2):
        assert (got["relative"] <= tol) == (ref["relative"] <= tol)


def test_probes_leave_params_untouched(tiny, probes):
    _, _, params, carried = tiny
    np.testing.assert_array_equal(
        carried["blocks"]["mlp"]["w_down"].numpy(),
        np.asarray(params["blocks"]["mlp"]["w_down"]))


def test_weight_sensitivity_matches(tiny, probes):
    _, _, params, carried = tiny
    ref = jsens.weight_sensitivity(params, probes["jbase"])
    got = tsens.weight_sensitivity(carried, probes["tbase"])
    assert sorted(got, key=str) == sorted(ref, key=str)
    for key in ref:
        for b in ref[key]:
            assert got[key][b] == pytest.approx(float(ref[key][b]), rel=1e-4)


# --- the solvers, fed the reference's scores ------------------------------

def _units(rng, n_paths=3, n_layers=4, joint=True):
    units = []
    for p in range(n_paths):
        for layer in range(n_layers):
            errs = {b: float(rng.random() / b) for b in (2, 3, 4, 5, 6, 8)}
            aerrs = ({None: 0.0, **{a: float(rng.random() / a)
                                    for a in (4, 6, 8)}} if joint else None)
            units.append((f"['blocks']['p{p}']", layer, 64, 32 * (p + 1), 1,
                          errs, aerrs))
    return units


SOLVES = {
    "match-uniform": dict(match_uniform=4),
    "bpw": dict(budget_bpw=4.5),
    "joint": dict(abits_candidates=(4, 6, 8), match_uniform=4,
                  match_uniform_abits=8),
    "joint-cycle-budget": dict(abits_candidates=(4, 6, 8), cycle_budget=0.8),
    "joint-measured-maxseg": dict(abits_candidates=(4, 6, 8), match_uniform=4,
                                  prt="measured", max_segments=1),
    "maxseg": dict(match_uniform=3, max_segments=1),
    "rule-pins": dict(match_uniform=4, rules=(("w_down", 8),),
                      act_rules=(("wq", 6),),
                      abits_candidates=(4, 6, 8)),
}


@pytest.mark.parametrize("name", sorted(SOLVES))
def test_solver_on_reference_scores_is_bit_identical(tiny, probes, name):
    jcfg, tcfg, params, carried = tiny
    kw = dict(SOLVES[name])
    jbase, tbase = probes["jbase"], probes["tbase"]
    rules = kw.pop("rules", None)
    act_rules = kw.pop("act_rules", ())
    if rules is not None:
        jbase = dataclasses.replace(jbase, rules=rules, act_rules=act_rules)
        tbase = dataclasses.replace(tbase, rules=rules, act_rules=act_rules)
    if "cycle_budget" in kw:
        # a fraction of the uniform 4a8 anchor's cycles
        from repro.core import cost_model as jcm
        units = [(int(w.shape[-2]), int(w.shape[-1]), 4, 8, 1)
                 for _, w, _ in jsens.quantizable_units(params, jbase)
                 for _ in range(w.shape[0] if w.ndim == 3 else 1)]
        kw["cycle_budget"] *= jcm.mixed_decode_cycles(units, nbw="auto")
    ref = dict(scores=probes["ref"]["scores"], act_scores=probes["ref"]["act"])
    jpol, jrep = jsens.calibrate_policy(params, jcfg, jbase, tokens=probes["jtoks"],
                                        **ref, **kw)
    tpol, trep = tsens.calibrate_policy(carried, tcfg, tbase,
                                        tokens=probes["ttoks"], **ref, **kw)
    assert trep.bits_by_unit == jrep.bits_by_unit
    assert trep.feasible == jrep.feasible
    assert tpol.allocation.to_spec() == jpol.allocation.to_spec()
    if hasattr(jrep, "cycles_total"):
        assert trep.cycles_total == pytest.approx(jrep.cycles_total, rel=1e-12)
    # the port's own scores solve to the same allocation here too
    own = dict(scores=probes["got"]["scores"], act_scores=probes["got"]["act"])
    _, orep = tsens.calibrate_policy(carried, tcfg, tbase,
                                     tokens=probes["ttoks"], **own, **kw)
    assert orep.bits_by_unit == jrep.bits_by_unit


PLANS = ["auto:q4", "auto:4.5bpw", "auto:q4a8", "auto:q3a6,maxseg=1",
         "auto:q4a8,prt=measured,maxseg=1", "auto:q4a8,kv=auto",
         "auto:q4,tp=auto"]


def _planners(tiny, probes, plan):
    jcfg, tcfg, params, carried = tiny
    j = JPlanner(params, jcfg, plan, base=probes["jbase"],
                 tokens=probes["jtoks"], scores=probes["ref"]["scores"],
                 act_scores=probes["ref"]["act"])
    t = TPlanner(carried, tcfg, plan, base=probes["tbase"],
                 tokens=probes["ttoks"], scores=probes["ref"]["scores"],
                 act_scores=probes["ref"]["act"])
    # the KV decision from each package's own probe
    j._kv_scores, t._kv_scores = probes["ref"]["kv"], probes["got"]["kv"]
    return j, t


@pytest.mark.parametrize("plan", PLANS)
def test_planner_solves_to_the_references_spec_hash(tiny, probes, plan):
    j, t = _planners(tiny, probes, plan)
    jr, tr = j.solve(), t.solve()
    assert tr.spec.solved and tr.spec.to_json() == jr.spec.to_json()
    assert tr.spec.spec_hash == jr.spec.spec_hash
    assert tr.report.bits_by_unit == jr.report.bits_by_unit
    assert tr.cost.tokens_per_second == pytest.approx(
        jr.cost.tokens_per_second, rel=1e-9)
    if "tp=auto" in plan:
        assert tr.spec.tp == 1


@pytest.mark.parametrize("scale", [0.5, 1.0, 2.0])
def test_planner_slo_solve_matches(tiny, probes, scale):
    """An SLO solve: budgets from the target, priced at the SLO's batch;
    the target is a multiple of the uniform-4a8 anchor's modeled tok/s."""
    j, t = _planners(tiny, probes, "auto:q4a8,prt=measured")
    anchor = j.solve().cost.tokens_per_second
    jr = j.solve(slo=JSlo(anchor * scale, 4))
    tr = t.solve(slo=TSlo(anchor * scale, 4))
    assert tr.spec.spec_hash == jr.spec.spec_hash
    assert tr.budgets.cycle_budget == pytest.approx(jr.budgets.cycle_budget,
                                                    rel=1e-12)
    assert tr.meets_slo == jr.meets_slo
    assert tr.report.feasible == jr.report.feasible


def test_planner_tp_auto_prices_shards_under_an_slo(tiny, probes):
    j, t = _planners(tiny, probes, "uniform:4a8,tp=auto")
    for target in (1.0, 1e12):
        jr = j.solve(slo=JSlo(target, 8))
        tr = t.solve(slo=TSlo(target, 8))
        assert tr.spec.tp == jr.spec.tp
        assert tr.spec.spec_hash == jr.spec.spec_hash


def test_planner_refuses_draft_auto_naming_the_roadmap(tiny, probes):
    """draft=auto solves, to the reference's pick on the same measured
    acceptance curve; resolve_plan serves a tp=2 plan as the reference's
    does (the engine shards it, tests/test_torch_tp.py)."""
    j, t = _planners(tiny, probes, "auto:q4")
    for p in (j, t):
        for bits, acc in ((2, 0.35), (3, 0.6), (4, 0.9)):
            p._draft_acceptance[(bits, None)] = acc
    plan = "uniform:4,draft=auto"
    jr = j.solve(plan=JPlanSpec.parse(plan))
    tr = t.solve(plan=TPlanSpec.parse(plan))
    assert tr.spec.solved and tr.spec.spec_hash == jr.spec.spec_hash
    assert tr.spec.draft == jr.spec.draft is None
    jcfg, tcfg, params, carried = tiny
    tr = resolve_plan("uniform:4,tp=2", carried, tcfg)
    jr = jresolve_plan("uniform:4,tp=2", params, jcfg)
    assert tr.spec.tp == jr.spec.tp == 2
    assert tr.spec.spec_hash == jr.spec.spec_hash
    assert tr.policy.to_spec() == jr.policy.to_spec()


def test_planner_probe_cache_is_reused(tiny, probes):
    _, tcfg, _, carried = tiny
    t = TPlanner(carried, tcfg, "auto:q4a8", base=probes["tbase"],
                 tokens=probes["ttoks"])
    first = t.solve()
    forwards = t.probe_stats["forwards"]
    again = t.solve(plan=TPlanSpec.parse("auto:4.5bpw"))
    assert t.probe_stats["forwards"] == forwards
    assert first.spec.solved and again.spec.solved


def test_segment_cap_and_pareto_filter_match():
    rng = np.random.default_rng(7)
    for joint in (False, True):
        raw = _units(rng, joint=joint)
        jus = [jsens.Unit(path=p, layer=layer, k=k, n=n, copies=c, errors=e,
                          aerrors=a) for p, layer, k, n, c, e, a in raw]
        tus = [tsens.Unit(path=p, layer=layer, k=k, n=n, copies=c, errors=e,
                          aerrors=a) for p, layer, k, n, c, e, a in raw]
        states = ([(int(w), int(a)) for w, a in
                   zip(rng.choice([2, 4, 8], 12), rng.choice([4, 6, 8], 12))]
                  if joint else [int(b) for b in rng.choice([2, 3, 4, 6], 12)])
        assign = {u.key: s for u, s in zip(jus, states)}
        assert tsens.segment_count(assign) == jsens.segment_count(assign)
        for cap in (1, 2, 3):
            nbytes = (lambda u, s: tsens.unit_bytes(u.k, u.n, s[0] if joint
                                                    else s, 32, u.copies))
            assert (tsens.enforce_max_segments(tus, assign, cap,
                                               bytes_of=nbytes)
                    == jsens.enforce_max_segments(jus, assign, cap,
                                                  bytes_of=nbytes))
            assert (tsens.enforce_max_segments(tus, assign, cap)
                    == jsens.enforce_max_segments(jus, assign, cap))
    pts = [(int(a), int(b)) for a, b in rng.integers(0, 6, (40, 2))]
    err = {s: float(rng.integers(0, 4)) for s in pts}
    cyc = {s: float(s[0] + s[1]) for s in pts}
    byt = {s: float(s[1]) for s in pts}
    for byte_of in (None, byt.get):
        assert (tsens.pareto_state_filter(pts, err.get, cyc.get, byte_of)
                == jsens.pareto_state_filter(pts, err.get, cyc.get, byte_of))


def test_allocate_bits_matches_on_synthetic_units():
    rng = np.random.default_rng(3)
    raw = _units(rng, n_paths=4, n_layers=3, joint=True)
    jus = [jsens.Unit(path=p, layer=layer, k=k, n=n, copies=c, errors=e,
                      aerrors=a) for p, layer, k, n, c, e, a in raw]
    tus = [tsens.Unit(path=p, layer=layer, k=k, n=n, copies=c, errors=e,
                      aerrors=a) for p, layer, k, n, c, e, a in raw]
    budget = sum(jsens.unit_bytes(u.k, u.n, 4, 32, u.copies) for u in jus)
    pins = {jus[0].key: 8}
    jr = jsens.allocate_bits(jus, budget, 32, pinned=pins)
    tr = tsens.allocate_bits(tus, budget, 32, pinned=pins)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    cycles = 3e6
    jj = jsens.allocate_bits_joint(jus, cycles, 32, byte_budget=budget,
                                   pinned_act={jus[1].key: 6})
    tj = tsens.allocate_bits_joint(tus, cycles, 32, byte_budget=budget,
                                   pinned_act={jus[1].key: 6})
    assert tj.bits_by_unit == jj.bits_by_unit and tj.feasible == jj.feasible
    assert tj.cycles_total == pytest.approx(jj.cycles_total, rel=1e-12)


# --- the cost-constant fits -----------------------------------------------------

def test_fit_constants_match():
    rng = np.random.default_rng(5)
    pts = [dict(wbits=wb, abits=ab, nbw=nbw, t_s=float(rng.uniform(1e-4, 1e-2)))
           for wb in (2, 4, 8) for ab in (4, 6, 8) for nbw in (1, 2, 3, 4)]
    assert tcc.fit_constants(pts, 8, 512, 256) == \
        jcc.fit_constants(pts, 8, 512, 256)
    tc, td = tcc.fit_constants(pts, 8, 512, 256, fit_dispatch=True)
    jc, jd = jcc.fit_constants(pts, 8, 512, 256, fit_dispatch=True)
    assert tc == jc and td == jd
    np.testing.assert_array_equal(
        tcc._design_row(tcc.SailMachine(), 8, 512, 256, 3, 4, 6),
        jcc._design_row(jcc.SailMachine(), 8, 512, 256, 3, 4, 6))


class _SmallLinspace:
    """numpy with ``linspace`` cut to its two end points: the paper-anchor
    fit's grids shrink from 9-7 to 2 points per axis."""

    def __getattr__(self, name):
        if name == "linspace":
            return lambda a, b, num=50: np.linspace(a, b, 2)
        return getattr(np, name)


def test_core_calibrate_fit_matches_on_a_small_grid(monkeypatch):
    monkeypatch.setattr(jcal, "np", _SmallLinspace())
    monkeypatch.setattr(tcal, "np", _SmallLinspace())
    jm, jerr = jcal.fit(verbose=False)
    tm, terr = tcal.fit(verbose=False)
    assert terr == jerr
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)


def test_run_calibration_on_the_cpu():
    res = tcc.run_calibration(batch=2, k=64, n=32, wbits_grid=(2, 4),
                              abits_grid=(4, 8), nbw_grid=(2, 4), iters=2,
                              device="cpu")
    assert res.backend == "cpu" and len(res.points) == 8
    vals = list(res.machine_overrides.values()) + \
        list(res.dispatch_cycles.values())
    assert all(np.isfinite(v) and v >= 0 for v in vals)
    assert res.dram_bw_measured > 0 and np.isfinite(res.max_rel_err)
    back = tcc.CalibrationResult.from_json(res.to_json())
    assert back.provenance() == res.provenance()
    # the provenance prices a plan on the fitted (effective) machine, as
    # the reference reads it
    prov = res.provenance()
    assert tcc.machine_from_json(prov) == res.machine()
    jm = jcc.machine_from_json(prov)
    assert dataclasses.asdict(tcc.machine_from_json(prov)) == \
        dataclasses.asdict(jm)
    assert tcc.dispatch_from_json(prov) == jcc.dispatch_from_json(prov)


def test_calibrated_plan_solves_to_the_references_hash(tiny, probes):
    prov = {"machine_overrides": {"lookup_base_cycles": 7.0,
                                  "dram_bw": 5e10, "dram_efficiency": 1.0},
            "dispatch_cycles": {"2:8": 1234.0}, "backend": "cpu",
            "shape": [8, 512, 256], "max_rel_err": 0.1, "mean_rel_err": 0.05,
            "dram_bw_measured": 5e10}
    plan = dataclasses.replace(JPlanSpec.parse("auto:q4a8"), calibration=prov)
    tplan = dataclasses.replace(TPlanSpec.parse("auto:q4a8"), calibration=prov)
    j, t = _planners(tiny, probes, "auto:q4a8")
    j = JPlanner(j.params, j.cfg, plan, base=j.base, tokens=j._tokens,
                 scores=j._scores, act_scores=j._act_scores)
    t = TPlanner(t.params, t.cfg, tplan, base=t.base, tokens=t._tokens,
                 scores=t._scores, act_scores=t._act_scores)
    jr, tr = j.solve(), t.solve()
    assert tr.spec.calibration == prov
    assert tr.spec.spec_hash == jr.spec.spec_hash
    assert tr.cost.tokens_per_second == pytest.approx(
        jr.cost.tokens_per_second, rel=1e-9)
