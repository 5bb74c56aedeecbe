"""The port's MoE decoders against the JAX reference on the CPU:
granite_moe_1b_a400m (32 experts top-8 at full width; smoke 4 experts
top-2, tied head) and mixtral_8x7b (8 experts top-2, window) at smoke
size, weights and inputs from a numpy seed (``tests/_torch_models.py``).
``moe_init``'s scales; ``apply_moe_dense`` / ``apply_moe_dispatch`` and
the aux loss, with the reference's two properties (``tests/test_system.py``:
dispatch equals dense at capacity factor 8, most tokens kept at 1.25);
4-D expert stacks quantized to the reference's packed words bit for bit;
``einsum_q`` on its f32 and int paths; the forward (dispatch, aux loss),
prefill and decode logits, f32 and ``uniform:4``; the engine's greedy
tokens on the ring and the paged pool; greedy speculation's tokens; and
the Planner's 4-D units (the cost model's copies, the weight probes and
their solve) equal to the reference's."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from _torch_models import (both, numpy_params, one_torch_thread,  # noqa: F401
                           quantized_both, reference_engine, reference_tree,
                           serve)
from repro import planning as jplanning
from repro.core import quant as jquant
from repro.core import sensitivity as jsens
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.models import sail_linear as jsl
from repro.serving import speculative as jspec
from repro_torch import planning as tplanning
from repro_torch.core import quant as tquant
from repro_torch.core import sensitivity as tsens
from repro_torch.models import lm as tlm
from repro_torch.models import moe as tmoe
from repro_torch.models import sail_linear as tsl
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

MOE = ("granite_moe_1b_a400m", "mixtral_8x7b")
TOL = dict(rtol=2e-4, atol=2e-4)
# the reference's tolerance of dispatch against dense (tests/test_system.py)
MOE_TOL = dict(rtol=2e-4, atol=2e-5)
POLICY = dict(bits=4, group_size=32, min_size=1024)
ENGINE = dict(batch_size=2, cache_len=32, plan="uniform:4", group_size=32,
              min_size=1024)
PAGED = dict(kv_block_size=8, kv_pool_blocks=8)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 3, 5, 7]]


@pytest.fixture(scope="module")
def models():
    """Per config, built once: (reference config, port config, reference
    tree, port tree)."""
    cache = {}

    def get(arch):
        if arch not in cache:
            jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
            cache[arch] = (jcfg, tcfg) + both(jcfg, seed=10 + MOE.index(arch))
        return cache[arch]
    return get


def _layer0(jparams, carried):
    """Layer 0's MoE params in both packages."""
    return (jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["moe"]),
            {k: v[0] for k, v in carried["blocks"]["moe"].items()})


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).standard_normal(
        shape + (cfg.d_model,)).astype(np.float32)


def test_moe_init_scales():
    """The port's random experts have the reference's distributions
    (truncated normal on +-2, std 0.8796 / sqrt(fan-in)): ``w_gate`` /
    ``w_up`` at fan-in E (the reference's default fan-in of one layer's
    (E, d, f)), ``w_down`` at f, the router at d.  Each package's sample
    std within 4 standard errors of that."""
    widths = dict(d_model=128, n_experts=16, moe_ffn=64)
    jcfg = dataclasses.replace(JC.get_smoke("mixtral_8x7b"), **widths)
    tcfg = dataclasses.replace(TC.get_smoke("mixtral_8x7b"), **widths)
    ref = jmoe.moe_init(jax.random.PRNGKey(0), jcfg)
    got = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg)
    fan = dict(router=128, w_gate=16, w_up=16, w_down=64)
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: v.shape for k, v in ref.items()}
    for name, w in got.items():
        std = 0.87962566 / fan[name] ** 0.5
        tol = 4 * std / (2 * w.numel()) ** 0.5
        assert float(np.std(np.asarray(ref[name]))) == pytest.approx(
            std, abs=tol), name
        assert float(w.std()) == pytest.approx(std, abs=tol), name


@pytest.mark.parametrize("arch", MOE)
def test_apply_moe_matches_reference(models, arch):
    """Dense and dispatch MoE and their aux losses on [2, 48] tokens of
    layer 0's weights, f32."""
    jcfg, tcfg, jparams, carried = models(arch)
    jp, tp = _layer0(jparams, carried)
    x = _x(jcfg, (2, 48), 1)
    for mode in ("dense", "dispatch"):
        want, waux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg, mode=mode)
        got, gaux = tmoe.apply_moe(tp, torch.from_numpy(x), tcfg, mode=mode)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MOE_TOL)
        assert float(gaux) == pytest.approx(float(waux), rel=1e-5)


def test_dispatch_equals_dense_at_high_capacity(models):
    jcfg, tcfg, jparams, carried = models("mixtral_8x7b")
    tcfg = dataclasses.replace(tcfg, capacity_factor=8.0)
    _, tp = _layer0(jparams, carried)
    x = torch.from_numpy(_x(jcfg, (2, 48), 2))
    dense, _ = tmoe.apply_moe_dense(tp, x, tcfg)
    disp, _ = tmoe.apply_moe_dispatch(tp, x, tcfg)
    np.testing.assert_allclose(disp.numpy(), dense.numpy(), **MOE_TOL)


@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_capacity_drops_bounded_and_match_reference(models, cf):
    """granite smoke over [4, 64] tokens at its capacity factor 1.25 (most
    tokens survive, the reference's property) and at 0.5 (an expert's
    buffer holds 64 of the 512 (token, k) pairs: many are dropped and
    dispatch parts from dense); either way the drops and the aux loss are
    the reference's."""
    jcfg, tcfg, jparams, carried = models("granite_moe_1b_a400m")
    jcfg = dataclasses.replace(jcfg, capacity_factor=cf)
    tcfg = dataclasses.replace(tcfg, capacity_factor=cf)
    jp, tp = _layer0(jparams, carried)
    x = _x(jcfg, (4, 64), 3)
    dense, _ = tmoe.apply_moe_dense(tp, torch.from_numpy(x), tcfg)
    disp, aux = tmoe.apply_moe_dispatch(tp, torch.from_numpy(x), tcfg)
    close = np.isclose(disp.numpy(), dense.numpy(), rtol=1e-3,
                       atol=1e-4).mean()
    assert close > 0.5 if cf > 1 else close < 0.9
    want, waux = jmoe.apply_moe_dispatch(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(disp.numpy(), np.asarray(want), **MOE_TOL)
    assert float(aux) == pytest.approx(float(waux), rel=1e-5)


@pytest.mark.parametrize("arch", MOE)
def test_expert_stacks_quantize_bit_identical(models, arch):
    """``quantize_params`` on the MoE layers' subtree (the router and the
    [L, E, K, N] expert stacks; the other leaves quantize as tinymistral's,
    tests/test_torch_quant.py): every leaf the reference quantizes the port
    quantizes, to the same words, scales and codebooks; the expert stacks
    keep their leading dims and a codebook tiled along L only, and a
    layer's slice of them is a stack of E matrices with a 1-D codebook (no
    LUT-GEMV takes it)."""
    jcfg, _, jparams, carried = models(arch)
    sub = lambda tree: {"blocks": {"moe": tree["blocks"]["moe"]}}
    want, wb0, wb1 = jsl.quantize_params(sub(jparams),
                                         jsl.QuantPolicy(**POLICY))
    got, gb0, gb1 = tsl.quantize_params(sub(carried),
                                        tsl.QuantPolicy(**POLICY))
    assert (gb0, gb1) == (wb0, wb1)
    jflat = jax.tree_util.tree_flatten_with_path(
        want, is_leaf=lambda x: isinstance(x, (jsl.QTensor,
                                               jsl.StackedQTensor)))[0]
    tflat = dict(tsl.flatten_with_paths(got))
    stacks = 0
    for path, w in jflat:
        t = tflat[jax.tree_util.keystr(path)]
        if isinstance(w, (jsl.QTensor, jsl.StackedQTensor)):
            assert type(t).__name__ == type(w).__name__
            np.testing.assert_array_equal(t.packed.numpy().view(np.uint32),
                                          np.asarray(w.packed))
            np.testing.assert_array_equal(t.scales.numpy(),
                                          np.asarray(w.scales))
            np.testing.assert_array_equal(t.codebook.numpy(),
                                          np.asarray(w.codebook))
            stacks += w.packed.ndim == 4
        else:
            np.testing.assert_array_equal(t.numpy(), np.asarray(w))
    assert stacks == 3
    experts = tlm.layer_params(got["blocks"], 1)["moe"]["w_up"]
    assert isinstance(experts, tsl.StackedQTensor)
    assert experts.codebook.ndim == 1 and experts.packed.ndim == 3
    np.testing.assert_array_equal(
        tsl.dequantize_any(experts).numpy(),
        np.asarray(jsl.dequantize_any(jax.tree_util.tree_map(
            lambda a: a[1], want["blocks"]["moe"]["w_up"]))))


@pytest.mark.parametrize("abits", [None, 8])
def test_einsum_q_matches_reference(abits):
    """The reference's ``test_einsum_q_int_path_moe_spec`` on both
    packages: x[t, d] x experts[e, d, f] -> y[t, e, f], and the
    down projection's [t, e, f] x [e, f, d]; the f32 path and the int path
    (per-token codes, the scale on the output)."""
    rng = np.random.default_rng(5)
    w = rng.standard_normal((2, 64, 32)).astype(np.float32)
    wd = rng.standard_normal((2, 32, 64)).astype(np.float32)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    h = rng.standard_normal((3, 2, 32)).astype(np.float32)
    jpol = jsl.QuantPolicy(bits=4, group_size=32, min_size=1)
    tpol = tsl.QuantPolicy(bits=4, group_size=32, min_size=1)
    for spec, xx, ww in (("td,edf->tef", x, w), ("tef,efd->ted", h, wd)):
        jst = jsl._quantize_stacked(jnp.asarray(ww), 4, jpol, abits=abits)
        tst = tsl._quantize_stacked(torch.from_numpy(ww), 4, tpol,
                                    abits=abits)
        want = jsl.einsum_q(spec, jnp.asarray(xx), jst)
        got = tsl.einsum_q(spec, torch.from_numpy(xx), tst)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    xs = torch.arange(6, dtype=torch.float32).reshape(3, 2, 1) + 1.0
    out = tsl._einsum_scale_to_out("ted,edf->tef", xs)
    assert out.shape == (3, 2, 1) and torch.equal(out, xs)
    assert tsl._einsum_scale_to_out("td,de->tde", xs[:, 0]) is None
    if abits is not None:
        # the int path: codes, then the scale on the output
        tst = tsl._quantize_stacked(torch.from_numpy(w), 4, tpol, abits=8)
        xq, xsc = tquant.quantize_activations(torch.from_numpy(x), 8)
        y = torch.einsum("td,edf->tef", xq.float(), tsl.dequantize_any(tst))
        assert torch.equal(tsl.einsum_q("td,edf->tef", torch.from_numpy(x),
                                        tst), y * xsc[:, :, None])
    jq, jscale = jquant.quantize_activations(jnp.asarray(x), 8)
    tq, tscale = tquant.quantize_activations(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))


def _prefill_decode(jparams, carried, jcfg, tcfg, toks, steps):
    """(reference logits, port logits) of a prefill and ``steps`` greedy
    decode steps (dense MoE), int8 KV."""
    jl, jc = jlm.prefill(jparams, toks, jcfg, cache_len=16, quant_kv=True)
    tl, tc = tlm.prefill(carried, toks, tcfg, 16, True, device="cpu")
    js, ts = [np.asarray(jl)], [tl.numpy()]
    for _ in range(steps):
        tok = np.argmax(js[-1], -1)[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(tok), jc, jcfg, True)
        tl, tc = tlm.decode_step(carried, torch.from_numpy(tok), tc, tcfg,
                                 True, device="cpu")
        js.append(np.asarray(jl))
        ts.append(tl.numpy())
    return np.stack(js), np.stack(ts)


@pytest.mark.parametrize("arch", MOE)
def test_forward_prefill_and_decode_match(models, arch):
    """The forward (dispatch, summed aux loss), then prefill and 4 decode
    steps (dense) at f32, and prefill and 2 decode steps under
    ``uniform:4`` (expert stacks quantized; the reference fed the port's
    tree, equal to its own by ``test_expert_stacks_quantize_bit_identical``)."""
    jcfg, tcfg, jparams, carried = models(arch)
    toks = np.random.default_rng(6).integers(0, jcfg.vocab, (2, 9))
    ref, aux = jlm.forward(jparams, toks, jcfg)
    got, taux = tlm.forward(carried, torch.from_numpy(toks), tcfg,
                            device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(aux) > 0
    assert float(taux) == pytest.approx(float(aux), rel=1e-5)
    want, got = _prefill_decode(jparams, carried, jcfg, tcfg, toks, 4)
    np.testing.assert_allclose(got, want, **TOL)
    jq, tq, _, _ = quantized_both(carried, POLICY)
    want, got = _prefill_decode(jq, tq, jcfg, tcfg, toks, 2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_engine_tokens_ring_and_paged_match_reference(models, arch,
                                                      monkeypatch):
    jcfg, tcfg, jparams, carried = models(arch)
    quantized = quantized_both(carried, POLICY)
    want = serve(reference_engine(jparams, jcfg, quantized, ENGINE,
                                  monkeypatch), PROMPTS, 4)
    ring = serve(TEngine(carried, tcfg, TEngineConfig(**ENGINE),
                         device="cpu"), PROMPTS, 4)
    paged = serve(TEngine(carried, tcfg, TEngineConfig(**ENGINE, **PAGED),
                          device="cpu"), PROMPTS, 4)
    assert ring == want
    assert paged == want


def test_greedy_speculation_matches_reference(models, monkeypatch):
    """granite smoke under ``uniform:4,draft=q2:k3`` (group 32): the
    speculative engine's greedy tokens, ring and paged, equal the
    reference's speculative engine's and the port's plain engine's (the
    reference is fed the port's served and draft trees)."""
    jcfg, tcfg, jparams, carried = models("granite_moe_1b_a400m")
    served = quantized_both(carried, POLICY)
    draft = quantized_both(carried, dict(POLICY, bits=2))
    ecfg = dict(ENGINE, plan="uniform:4,draft=q2:k3", quant_kv=False)

    def draft_tree(params, policy=jsl.QuantPolicy()):
        assert params is jparams and policy.bits == 2
        return draft[0], draft[2], draft[3]
    monkeypatch.setattr(jspec, "quantize_params", draft_tree)
    eng = reference_engine(jparams, jcfg, served, ecfg, monkeypatch)
    want = serve(eng, PROMPTS, 6)
    assert eng.stats()["speculative"]["rounds"] > 0
    ring = serve(TEngine(carried, tcfg, TEngineConfig(**ecfg),
                         device="cpu"), PROMPTS, 6)
    paged = serve(TEngine(carried, tcfg, TEngineConfig(**ecfg, **PAGED),
                          device="cpu"), PROMPTS, 6)
    plain = serve(TEngine(carried, tcfg, TEngineConfig(
        **dict(ecfg, plan="uniform:4")), device="cpu"), PROMPTS, 6)
    assert ring == want and paged == want and plain == want


def test_planner_units_on_expert_stacks_match_reference(models):
    """The Planner's 4-D units: the cost model's units (an expert stack's
    copies are L x E, or E per layer) and the fixed bytes equal the
    reference's; the calibration-free weight scores of an expert stack's
    layer slices are the reference's; the budgeted solve over the port's
    scores (``match_uniform=4``) is the reference's on the same scores, and
    its tree serves the reference's logits (granite smoke: mixtral's
    stacks take the same code)."""
    jcfg, tcfg, jparams, carried = models("granite_moe_1b_a400m")
    jbase, tbase = jsl.QuantPolicy(**POLICY), tsl.QuantPolicy(**POLICY)
    assert (tplanning.policy_units(carried, tbase)
            == jplanning.policy_units(jparams, jbase))
    assert (tplanning.unquantized_bytes(carried, tbase)
            == jplanning.unquantized_bytes(jparams, jbase))
    path = "['blocks']['moe']['w_down']"
    stack = {"blocks": {"moe": {"w_down": carried["blocks"]["moe"][
        "w_down"]}}}
    want = jsens.weight_sensitivity(jax.tree_util.tree_map(
        jnp.asarray, reference_tree(stack)), jbase, bits_candidates=(2, 4))
    got = tsens.weight_sensitivity(stack, tbase, bits_candidates=(2, 4))
    assert set(got) == set(want) == {(path, i) for i in range(2)}
    for key, errs in want.items():
        for b, e in errs.items():
            assert got[key][b] == pytest.approx(e, rel=1e-4)
    scores = tsens.weight_sensitivity(carried, tbase)
    assert sum(path in p for p, _ in scores) == tcfg.n_layers
    jpol, jrep = jsens.calibrate_policy(jparams, jcfg, jbase, match_uniform=4,
                                        mode="weight", scores=scores)
    tpol, trep = tsens.calibrate_policy(carried, tcfg, tbase, match_uniform=4,
                                        mode="weight", scores=scores)
    assert trep.bits_by_unit == jrep.bits_by_unit
    assert tpol.allocation.to_spec() == jpol.allocation.to_spec()
    tree, _, _ = tsl.quantize_params(carried, tpol)
    toks = np.random.default_rng(7).integers(0, jcfg.vocab, (2, 6))
    want_l, _ = jlm.prefill(reference_tree(tree), toks, jcfg, cache_len=8)
    got_l, _ = tlm.prefill(tree, toks, tcfg, 8, device="cpu")
    np.testing.assert_allclose(got_l.numpy(), np.asarray(want_l), **TOL)


def test_numpy_params_cover_the_tree():
    """The seeded tree has every leaf of the reference's init (experts
    [L, E, d, f]), none of them zero."""
    jcfg = JC.get_smoke("granite_moe_1b_a400m")
    tree = numpy_params(jcfg)
    ref = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                 jcfg))
    assert (jax.tree_util.tree_structure(tree)
            == jax.tree_util.tree_structure(ref))
    assert tree["blocks"]["moe"]["w_gate"].shape == (
        jcfg.n_layers, jcfg.n_experts, jcfg.d_model, jcfg.expert_ffn)
    assert float(np.abs(tree["blocks"]["moe"]["router"]).min()) > 0


@pytest.mark.parametrize("plan", ["uniform:4a8", "rules:moe=3,attn=5a8,default=4"])
def test_plans_resolve_and_serve_as_the_reference(models, plan, monkeypatch):
    """mixtral smoke under a uniform plan with 8-bit activations (the
    experts' einsums on the int path) and a rules plan that gives the
    expert stacks 3 bits: the reference's ``spec_hash`` and its engine's
    tokens (the reference fed the port's tree of the plan's policy)."""
    jcfg, tcfg, jparams, carried = models("mixtral_8x7b")
    ecfg = dict(ENGINE, plan=plan)
    eng = TEngine(carried, tcfg, TEngineConfig(**ecfg), device="cpu")
    quantized = quantized_both(carried, dataclasses.asdict(eng.quant_policy))
    ref = reference_engine(jparams, jcfg, quantized, ecfg, monkeypatch)
    assert eng.plan.spec_hash == ref.plan.spec_hash
    assert serve(eng, PROMPTS, 4) == serve(ref, PROMPTS, 4)
