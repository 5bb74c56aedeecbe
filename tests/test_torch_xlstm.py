"""The port's xlstm (``models/xlstm.py`` and the recurrent super-block)
against the JAX reference on the CPU, weights and inputs from a numpy seed
(``tests/_torch_models.py``).  mLSTM and sLSTM outputs and states from the
``-inf`` start and from a given state; xlstm smoke prefill and decode
logits and states; continuous batching equal to batch mode on
equal-length prompts and ragged prompts completing (the counterpart of
``tests/test_engine_continuous.py::test_recurrent_family_slot_serving``);
speculation refused as the reference refuses it; greedy engine tokens
under ``uniform:4`` and ``uniform:4a8`` equal the reference engine's; the
quantized path set at the published width."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from _torch_models import (both, one_torch_thread, quantized_both,  # noqa: F401
                           quantized_paths_full, reference_engine, serve)
from repro.models import lm as jlm
from repro.models import xlstm as jxl
from repro.serving import engine as jengine
from repro_torch.models import lm as tlm
from repro_torch.models import xlstm as txl
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "xlstm_350m"
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
# min_size 256 quantizes the smoke mLSTM's w_if ([128, 4]: N 4), as the
# published width's w_if ([2048, 8]) is
ENGINE = dict(batch_size=2, cache_len=32, plan="uniform:4", group_size=8,
              min_size=256)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 3, 5, 7]]


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    return (jcfg, tcfg) + both(jcfg, seed=4)


def _state_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
@pytest.mark.parametrize("t", [1, 9])
def test_cell_and_state_match(model, kind, t):
    """One sub-layer over T tokens from the ``-inf`` start (no state) and
    from the state that run left: outputs and (C or c, n, m) at 1e-5."""
    jcfg, tcfg, jparams, carried = model
    i = 1 if kind == "slstm" else 0
    jp = jax.tree_util.tree_map(lambda a: a[0],
                                jparams["blocks"]["subs"][i][kind])
    tp = tlm.layer_params(carried["blocks"], 0)["subs"][i][kind]
    japply = jxl.apply_slstm if kind == "slstm" else jxl.apply_mlstm
    tapply = txl.apply_slstm if kind == "slstm" else txl.apply_mlstm
    rng = np.random.default_rng(t)
    jst = tst = None
    for _ in range(2):
        x = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
        jy, jst = japply(jp, jnp.asarray(x), jcfg, state=jst,
                         return_state=True)
        ty, tst = tapply(tp, torch.from_numpy(x), tcfg, state=tst,
                         return_state=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **STATE_TOL)
        _state_close(tst, jst)
        assert bool(torch.isfinite(tst.m).all())


def test_prefill_and_decode_match(model):
    """xlstm smoke: prefill and 4 greedy decode steps, logits at 1e-4 and
    every sub-layer's state at 1e-5 after each pass; the cache holds no
    KV."""
    jcfg, tcfg, jparams, carried = model
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 9))
    jl, jc = jlm.prefill(jparams, toks, jcfg, cache_len=32, quant_kv=True)
    tl, tc = tlm.prefill(carried, toks, tcfg, 32, True, device="cpu")
    assert sorted(tc["layers"]) == sorted(jc["layers"]) == ["mlstm_0",
                                                            "slstm_1"]
    for _ in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        for name in tc["layers"]:
            _state_close(tc["layers"][name], jc["layers"][name])
        tok = np.argmax(np.asarray(jl), -1)[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(tok), jc, jcfg, True)
        tl, tc = tlm.decode_step(carried, torch.from_numpy(tok), tc, tcfg,
                                 True, device="cpu")


def test_continuous_equals_batch_and_ragged_complete(model, monkeypatch):
    """Unquantized, f32 KV: continuous batching (exact-length prefill)
    equals run-to-completion on equal-length prompts, and equals the
    reference engine; ragged prompts complete."""
    jcfg, tcfg, jparams, carried = model
    mk = lambda mode: TEngine(carried, tcfg, TEngineConfig(
        batch_size=2, cache_len=32, quantize=False, quant_kv=False,
        mode=mode), device="cpu")
    same = [[1, 2, 3], [4, 5, 6], [7, 8, 9]]
    outs = {mode: serve(mk(mode), same, 3) for mode in ("continuous",
                                                        "batch")}
    assert outs["continuous"] == outs["batch"]
    ref = jengine.Engine(jparams, jcfg, jengine.EngineConfig(
        batch_size=2, cache_len=32, quantize=False, quant_kv=False))
    assert outs["continuous"] == serve(ref, same, 3)
    done = serve(mk("continuous"), [[1, 2], [3, 4, 5, 6], [7]], 3)
    assert len(done) == 3 and all(len(t) == 3 for t in done.values())


def test_speculation_refused(model):
    """A draft plan on a recurrent family is refused, naming attention
    (``tests/test_speculative.py::test_draft_rejects_tap_and_recurrent_family``)."""
    _, tcfg, _, carried = model
    with pytest.raises(ValueError, match="attention"):
        TEngine(carried, tcfg, TEngineConfig(
            batch_size=2, cache_len=32, min_size=1024,
            plan="uniform:8a8,draft=q4:k2"), device="cpu")


@pytest.mark.parametrize("plan", ["uniform:4", "uniform:4a8"])
def test_engine_tokens_match_reference(model, plan, monkeypatch):
    """The ring engine (every matrix of the step a LUT-GEMV, the int path
    under 4a8): greedy tokens equal the reference engine's, fed the port's
    quantized tree; ``w_if`` is quantized."""
    jcfg, tcfg, jparams, carried = model
    ecfg = dict(ENGINE, plan=plan)
    eng = TEngine(carried, tcfg, TEngineConfig(**ecfg), device="cpu")
    w_if = tlm.layer_params(eng.params["blocks"], 0)["subs"][0]["mlstm"][
        "w_if"]
    assert w_if.n == 2 * tcfg.n_heads
    assert w_if.abits == (8 if plan.endswith("a8") else None)
    quantized = quantized_both(carried, dataclasses.asdict(eng.quant_policy))
    ref = reference_engine(jparams, jcfg, quantized, ecfg, monkeypatch)
    assert serve(eng, PROMPTS, 6) == serve(ref, PROMPTS, 6)


def test_quantized_paths_match_reference():
    """At the published width the engine's defaults quantize all of the
    mLSTM's ``w_up w_q w_k w_v w_if w_down`` (``w_if`` [2048, 8]), the
    sLSTM's five and ``lm_head``, as the reference's do."""
    want, got = quantized_paths_full(ARCH, 128)
    assert got == want and len(got) == 3 * 6 + 5 + 1
    assert "['blocks']['subs'][0]['mlstm']['w_if']" in got
