"""The port's engine with the Planner against the JAX reference, on
tinymistral smoke: unsolved ``auto:`` / ``kv=auto`` plans and a bare SLO
solved at construction with default calibration (the reference's
``spec_hash`` and greedy tokens), the activation tap and live replan
(``calib()``, ``prt_hit_rate``, ``replan(resolve=True)``), ``apply_plan``
swaps between steps that leave every token as it was (ring and paged
pools), the deprecated ``bit_policy`` surface (held to the reference's
engine tokens, including the allocation of the reference test that fails
on the reference itself, ROADMAP Queue 3), the engine's refusals, and the
launcher's ``--plan auto:...``, ``--tap`` and ``--bit-policy``.

The reference's probes run once, in one module-scoped Planner whose cached
scores every other reference solve here reuses; it solves exactly as the
reference's engine does (``resolve_plan`` builds the same Planner with the
default calibration tokens)."""
import dataclasses
import json
import warnings

import jax
import numpy as np
import pytest

import repro.configs as JC
import repro_torch.configs as TC
from repro import planning as jplanning
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch import planning as tplanning
from repro_torch.convert import params_from_numpy
from repro_torch.core import pattern as tpattern
from repro_torch.launch import serve
from repro_torch.models import sail_linear as tsl
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"
ENGINE = dict(batch_size=2, cache_len=32, ql=4, group_size=32)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11, 12]]
DOWN = "['blocks']['mlp']['w_down']"


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    carried = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return jcfg, tcfg, params, carried


@pytest.fixture(scope="module")
def ref_planner(smoke):
    """The reference engine's Planner (default calibration tokens), probed
    once; ``solved`` maps each plan string to its reference result."""
    jcfg, _, params, _ = smoke
    base = jsl.QuantPolicy(bits=4, group_size=32, min_size=1024)
    planner = jplanning.Planner(params, jcfg, "auto:q4a8,kv=auto", base=base)
    solved = {"auto:q4a8,kv=auto": planner.solve()}
    for plan in ("auto:q4a8", "auto:q4,kv=auto", "auto:q4"):
        solved[plan] = planner.solve(plan=jplanning.PlanSpec.parse(plan))
    return planner, solved


def _serve(eng, prompts=PROMPTS, max_new=8):
    for p in prompts:
        eng.submit(p, max_new_tokens=max_new)
    eng.run()
    return {c.uid: c.tokens for c in eng.completions.values()}


def _jengine(smoke, **kw):
    jcfg, _, params, _ = smoke
    return JEngine(params, jcfg, JEngineConfig(quantize=True, **ENGINE, **kw))


def _tengine(smoke, **kw):
    _, tcfg, _, carried = smoke
    return TEngine(carried, tcfg, TEngineConfig(**ENGINE, **kw), device="cpu")


# --- unsolved plans at engine construction -----------------------------------

@pytest.mark.parametrize("plan", ["auto:q4a8", "auto:q4,kv=auto",
                                  "auto:q4a8,kv=auto"])
def test_engine_solves_auto_plans_like_the_reference(smoke, ref_planner, plan):
    ref = ref_planner[1][plan]
    eng = _tengine(smoke, plan=plan)
    st = eng.stats()
    assert eng.plan.solved and isinstance(eng.plan.kv_bits, (int, type(None)))
    assert st["plan_hash"] == ref.spec.spec_hash
    assert eng.plan.to_json() == ref.spec.to_json()
    assert st["kv_bits"] == (ref.spec.kv_bits or 8)
    jeng = _jengine(smoke, plan=ref.spec)
    assert _serve(eng) == _serve(jeng)
    assert st["mixed_precision"] and st["replan_count"] == 0


def test_engine_bare_slo_solves_like_the_reference(smoke, ref_planner):
    """A bare SLO solves auto:q<ql>a8,prt=measured against it at the
    engine's batch; the target is the uniform anchor's modeled tok/s."""
    jcfg, _, params, _ = smoke
    planner, solved = ref_planner
    target = solved["auto:q4a8"].cost.tokens_per_second * 0.9
    plan = jplanning.PlanSpec(mode="auto", weight_bits=4, act_bits=8,
                              prt="measured", quant_kv=True)
    j = jplanning.Planner(params, jcfg, plan, base=planner.base,
                          tokens=planner._tokens, scores=planner._scores,
                          act_scores=planner._act_scores)
    ref = j.solve(slo=jplanning.Slo(target, batch=ENGINE["batch_size"]))
    eng = _tengine(smoke, slo=target)
    assert eng.stats()["plan_hash"] == ref.spec.spec_hash
    assert eng.plan.target_tps == target
    assert eng.slo.batch == ENGINE["batch_size"]


def test_engine_tp_auto_resolves_to_one_shard(smoke):
    eng = _tengine(smoke, plan="uniform:4,tp=auto")
    assert eng.plan.tp == 1 and eng.plan.solved
    assert _serve(eng, max_new=3)


# --- the tap and live replan -------------------------------------------------

def test_tap_calib_and_measured_prt_match_the_reference(smoke):
    jeng = _jengine(smoke, plan="uniform:4a8", tap_capacity=64)
    teng = _tengine(smoke, plan="uniform:4a8", tap_capacity=64)
    assert _serve(teng) == _serve(jeng)
    jc, tc = jeng.tap.calib(), teng.tap.calib()
    assert sorted(tc, key=str) == sorted(jc, key=str)
    for layer in jc:
        np.testing.assert_allclose(tc[layer], jc[layer], rtol=1e-5, atol=1e-5)
    assert teng.tap.rows_seen == jeng.tap.rows_seen > 0
    assert teng.stats()["tapped_rows"] == teng.tap.rows_seen
    # the served plan's operating point on the tapped traffic (the
    # reference controller's escalation signal)
    assert teng._tapped_hit_rate() == pytest.approx(jeng._tapped_hit_rate(),
                                                    abs=1e-3)
    jr, tr = jeng.replan(), teng.replan()
    assert tr.measured_prt_hit_rate == pytest.approx(
        jr.measured_prt_hit_rate, abs=1e-3)
    # on the same captured rows the two rates are the same number
    plan = teng.plan
    rate = tplanning.Planner(teng._raw_params, teng.cfg, plan,
                             base=teng._base_policy())._traffic_hit_rate(
                                 plan, jc)
    jrate = jplanning.Planner(jeng._raw_params, jeng.cfg,
                              jplanning.PlanSpec.from_json(plan.to_json()),
                              base=jeng._base_policy())._traffic_hit_rate(
                                  jplanning.PlanSpec.from_json(plan.to_json()),
                                  jc)
    assert rate == jrate
    st = teng.stats()
    assert st["replan_count"] == 1 and st["prt_hit_rate"] == tr.measured_prt_hit_rate
    assert teng.plan.prt == "measured" and teng.quant_policy.bits == 4
    assert teng.stats()["plan_hash"] == jeng.stats()["plan_hash"]


@pytest.mark.parametrize("paged", [False, True])
def test_live_swap_keeps_every_token(smoke, paged):
    """Requantizing mid-serve under the same plan disturbs no token: the
    KV pool, block tables and scheduler survive the swap
    (tests/test_planning.py:387)."""
    kw = dict(kv_block_size=8) if paged else {}

    def run(swap_iterations=()):
        eng = _tengine(smoke, plan="uniform:4a8", tap_capacity=32, **kw)
        for p in PROMPTS[:2]:
            eng.submit(p, max_new_tokens=8)
        while True:
            more = eng.step()
            if eng.iterations in swap_iterations:
                eng.apply_plan(eng.plan, force_requantize=True)
            if not more:
                break
        return {c.uid: c.tokens for c in eng.completions.values()}, eng

    ref, _ = run()
    swapped, eng = run(swap_iterations=(3, 5))
    assert swapped == ref
    assert eng.replan_count == 2 and eng.stats()["replan_count"] == 2


def test_replan_resolve_matches_the_reference(smoke, ref_planner):
    """An auto plan re-solved mid-serve under the tapped traffic's PRT
    rates, with the reference's cached scores on both sides: the same
    solved plan, and the same tokens before and after the swap."""
    jcfg, tcfg, params, carried = smoke
    planner, solved = ref_planner
    spec = solved["auto:q4a8"].spec
    jeng = _jengine(smoke, plan=spec, tap_capacity=64)
    teng = _tengine(smoke, plan=spec.to_json(), tap_capacity=64)

    def drive(eng, n):
        for p in PROMPTS:
            eng.submit(p, max_new_tokens=10)
        for _ in range(n):
            eng.step()

    drive(jeng, 6)
    drive(teng, 6)
    unsolved = dataclasses.replace(spec, weights_per_unit=None,
                                   acts_per_unit=None)
    jp = jplanning.Planner(jeng._raw_params, jcfg, unsolved,
                           base=jeng._base_policy(), tokens=planner._tokens,
                           scores=planner._scores,
                           act_scores=planner._act_scores)
    tp = tplanning.Planner(teng._raw_params, tcfg,
                           tplanning.PlanSpec.from_json(unsolved.to_json()),
                           base=teng._base_policy(), tokens=planner._tokens,
                           scores=planner._scores,
                           act_scores=planner._act_scores)
    jr = jeng.replan(planner=jp, resolve=True)
    tr = teng.replan(planner=tp, resolve=True)
    assert tr.spec.spec_hash == jr.spec.spec_hash
    assert tr.spec.prt == "measured" and tr.spec.solved
    jeng.run()
    teng.run()
    assert ({c.uid: c.tokens for c in teng.completions.values()}
            == {c.uid: c.tokens for c in jeng.completions.values()})
    assert teng.stats()["replan_count"] == 1
    assert teng.stats()["plan_hash"] == jeng.stats()["plan_hash"]


def test_replan_and_apply_plan_refusals(smoke):
    eng = _tengine(smoke, plan="uniform:4")
    with pytest.raises(ValueError, match="ActivationTap"):
        eng.replan()
    with pytest.raises(ValueError, match="raw weights"):
        eng.apply_plan("uniform:3")
    eng = _tengine(smoke, plan="uniform:4", retain_raw=True)
    with pytest.warns(UserWarning, match="kv_bits=32"):
        eng.apply_plan("uniform:3,kv=32")
    assert eng.quant_policy.bits == 3 and eng.kv_bits == 8
    with pytest.raises(NotImplementedError, match="ROADMAP, Queue 1 item 3"):
        eng.apply_plan("uniform:4,draft=q2a8:k4")
    eng = _tengine(smoke, plan="uniform:4", tap_capacity=8, retain_raw=False)
    _serve(eng, max_new=3)
    with pytest.raises(ValueError, match="raw weights"):
        eng.replan()


# --- the deprecated bit_policy surface ----------------------------------------

def test_bit_policy_rules_string_matches_the_reference(smoke):
    with pytest.warns(DeprecationWarning):
        jeng = _jengine(smoke, bit_policy="rules:mlp=2,default=6")
    with pytest.warns(DeprecationWarning):
        teng = _tengine(smoke, bit_policy="rules:mlp=2,default=6")
    assert teng.quant_policy.to_spec() == jeng.quant_policy.to_spec()
    assert teng.stats()["plan_hash"] == jeng.stats()["plan_hash"]
    assert _serve(teng) == _serve(jeng)


def test_bit_policy_failing_reference_allocation(smoke):
    """tests/test_mixed_precision.py's 6/8-bit segmented bit_policy, which
    fails its f32 comparison on the reference itself: the port gives the
    reference's tokens on it."""
    alloc = {DOWN: (6, 8)}
    jpol = jsl.QuantPolicy(bits=8, group_size=32, min_size=1024,
                           allocation=jsl.BitAllocation(per_path=alloc))
    tpol = tsl.QuantPolicy(bits=8, group_size=32, min_size=1024,
                           allocation=tsl.BitAllocation(per_path=alloc))
    kw = dict(batch_size=4, cache_len=64, ql=8, group_size=32,
              quant_kv=False)
    jcfg, tcfg, params, carried = smoke
    with pytest.warns(DeprecationWarning):
        jeng = JEngine(params, jcfg, JEngineConfig(quantize=True, **kw,
                                                   bit_policy=jpol))
    with pytest.warns(DeprecationWarning):
        teng = TEngine(carried, tcfg, TEngineConfig(**kw, bit_policy=tpol),
                       device="cpu")
    assert isinstance(teng.params["blocks"], list)
    prompts = [[1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert _serve(teng, prompts) == _serve(jeng, prompts)


def test_bit_policy_auto_string_solves_like_the_plan(smoke, ref_planner):
    with pytest.warns(DeprecationWarning):
        teng = _tengine(smoke, bit_policy="auto:q4")
    ref = ref_planner[1]["auto:q4"]
    assert (teng.quant_policy.allocation.to_spec()
            == ref.policy.allocation.to_spec())


def test_bit_policy_surface_errors(smoke):
    with pytest.raises(ValueError, match="not both"):
        _tengine(smoke, plan="uniform:4", bit_policy="uniform:4")
    with pytest.raises(ValueError, match="slo= requires plan="):
        _tengine(smoke, slo=100.0, bit_policy="uniform:4")
    with pytest.raises(TypeError):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            _tengine(smoke, bit_policy=3.5)
    with pytest.warns(DeprecationWarning):
        from repro_torch.core import sensitivity as tsens
        assert tsens.parse_bit_policy("auto:q4a8") == {
            "mode": "auto", "match_uniform": 4, "abits": 8}


# --- the launcher ----------------------------------------------------------------

def test_launcher_solves_taps_and_saves_an_auto_plan(tmp_path, capsys):
    """The launcher's own seeded weights: the plan it solves and saves
    serves again from the file with no probes."""
    out = tmp_path / "plan.json"
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--requests", "2", "--max-new", "4", "--cache-len", "32",
                "--group-size", "32", "--plan", "auto:q4a8,kv=auto",
                "--tap", "16", "--save-plan", str(out)])
    text = capsys.readouterr().out
    saved = tplanning.PlanSpec.load(str(out))
    assert saved.solved and saved.kv_bits in (8, 32)
    assert "tap:" in text and saved.spec_hash in text
    assert json.loads(out.read_text())["mode"] == "auto"
    serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                "--requests", "1", "--max-new", "2", "--cache-len", "32",
                "--group-size", "32", "--plan", str(out)])
    assert saved.spec_hash in capsys.readouterr().out
    with pytest.warns(DeprecationWarning):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                    "2", "--requests", "1", "--max-new", "2", "--cache-len",
                    "32", "--bit-policy", "uniform:3"])
    assert "Q3" in capsys.readouterr().out


def test_tap_rows_ring_and_dead_lanes():
    """The tap keeps ``capacity`` rows per layer, drops masked lanes and
    moves a device tensor to the host once per observation."""
    import torch
    tap = tplanning.ActivationTap(capacity=5, capture_every=2)
    x = torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 1, 4)
    tap.observe(x, np.array([True, False, True]))
    tap.observe(x.numpy()[:, :, 0], None)
    assert tap.n_layers == 2 and len(tap) == 5 and tap.rows_seen == 10
    np.testing.assert_array_equal(tap.rows(0)[:2], x[0, [0, 2], 0].numpy())
    calib = tap.calib(max_rows=3)
    assert calib[0].shape == (3, 4) and calib[None].shape == (3, 4)
    assert tap.should_capture(4) and not tap.should_capture(3)
    hit = tpattern.prt_hit_rate(2, 8, calib[None])
    assert 0.0 <= hit <= 1.0
