"""The port's hymba (``models/ssm.py`` and the hybrid block) against the JAX
reference on the CPU, weights and inputs from a numpy seed
(``tests/_torch_models.py``; the SSM's fixed leaves at the reference's own
values).  The SSM branch and its state (conv window, h) at T 1 and T 9;
hymba smoke prefill and decode logits and states; the engine's greedy
tokens on the ring; the paged pool refused with the reference's message;
the quantized path set at the published width and the engine's default
group 128 (only ``w_down``) and at group 64, where both quantize ``a_log``
and their SSM's ``exp`` raises."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from _torch_models import (both, one_torch_thread, quantized_both,  # noqa: F401
                           quantized_paths_full, reference_engine,
                           reference_tree, serve)
from repro.models import lm as jlm
from repro.models import ssm as jssm
from repro.serving import engine as jengine
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.models import ssm as tssm
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "hymba_1_5b"
STATE_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ENGINE = dict(batch_size=2, cache_len=32, plan="uniform:4", group_size=8,
              min_size=1024)
PROMPTS = [[1, 2, 3], [4, 5, 6, 7, 8], [9, 10], [11, 3, 5, 7]]


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    return (jcfg, tcfg) + both(jcfg, seed=3)


def _state_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STATE_TOL)


@pytest.mark.parametrize("t", [1, 9])
def test_apply_ssm_and_state_match(model, t):
    """Layer 0's SSM branch over T tokens, from no state and from a random
    one (the decode step's case at T 1): outputs and the new conv window
    and h at 1e-5 (the port's loop over T against the reference's
    associative scan)."""
    jcfg, tcfg, jparams, carried = model
    jp = jax.tree_util.tree_map(lambda a: a[0], jparams["blocks"]["ssm"])
    tp = tlm.layer_params(carried["blocks"], 0)["ssm"]
    rng = np.random.default_rng(t)
    x = rng.standard_normal((2, t, jcfg.d_model)).astype(np.float32)
    inner = tssm.ssm_inner(tcfg)
    st = (rng.standard_normal((2, tcfg.ssm_conv - 1, inner)),
          rng.standard_normal((2, inner, tcfg.ssm_state)))
    st = [a.astype(np.float32) for a in st]
    for state in (None, st):
        jst = None if state is None else jssm.SSMState(
            *(jnp.asarray(a) for a in state))
        tst = None if state is None else tssm.SSMState(
            *(torch.from_numpy(a) for a in state))
        jy, jnew = jssm.apply_ssm(jp, jnp.asarray(x), jcfg, state=jst,
                                  return_state=True)
        ty, tnew = tssm.apply_ssm(tp, torch.from_numpy(x), tcfg, state=tst,
                                  return_state=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **STATE_TOL)
        _state_close(tnew, jnew)


def test_prefill_and_decode_match(model):
    """hymba smoke: prefill (attention and SSM in parallel, window 32) and
    4 greedy decode steps with int8 KV, logits at 1e-4, the cache's SSM
    state at 1e-5 after each pass."""
    jcfg, tcfg, jparams, carried = model
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 9))
    jl, jc = jlm.prefill(jparams, toks, jcfg, cache_len=32, quant_kv=True)
    tl, tc = tlm.prefill(carried, toks, tcfg, 32, True, device="cpu")
    for _ in range(5):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        _state_close(tc["layers"]["ssm"], jc["layers"]["ssm"])
        tok = np.argmax(np.asarray(jl), -1)[:, None]
        jl, jc = jlm.decode_step(jparams, jnp.asarray(tok), jc, jcfg, True)
        tl, tc = tlm.decode_step(carried, torch.from_numpy(tok), tc, tcfg,
                                 True, device="cpu")


def test_engine_tokens_match_reference(model, monkeypatch):
    """The ring engine under uniform:4 (exact-length prefill groups, the
    retired lanes' state advancing as the reference's does): greedy
    tokens equal the reference engine's, fed the port's quantized tree."""
    jcfg, tcfg, jparams, carried = model
    eng = TEngine(carried, tcfg, TEngineConfig(**ENGINE), device="cpu")
    quantized = quantized_both(carried, dataclasses.asdict(eng.quant_policy))
    ref = reference_engine(jparams, jcfg, quantized, ENGINE, monkeypatch)
    assert serve(eng, PROMPTS, 6) == serve(ref, PROMPTS, 6)
    assert eng.prefill_iterations == ref.prefill_iterations


def test_paged_pool_refused(model):
    """Paged KV is refused for the hybrid family with the reference's
    message, by the engine and by ``init_paged_cache``."""
    jcfg, tcfg, jparams, carried = model
    fields = dict(ENGINE, kv_block_size=8, kv_pool_blocks=8)
    with pytest.raises(ValueError) as want:
        jengine.Engine(jparams, jcfg, jengine.EngineConfig(**fields))
    with pytest.raises(ValueError) as got:
        TEngine(carried, tcfg, TEngineConfig(**fields), device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as want:
        jlm.init_paged_cache(jparams, jcfg, 2, 8, 8)
    with pytest.raises(ValueError) as got:
        tlm.init_paged_cache(tcfg, 2, 8, 8, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("group", [128, 64])
def test_quantized_paths_match_reference(model, group):
    """At hymba's published width the reference's engine defaults
    (group 128) quantize only ``w_down`` (K 5504; every K = 1600 leaf
    stays f32), and group 64 also ``a_log``; the port quantizes the same
    paths.  At a group that divides the smoke width ``a_log`` is quantized
    too, and both models' SSM then raise ``TypeError`` (``exp`` of a
    quantized leaf, reference ``ssm.py:99``)."""
    want, got = quantized_paths_full(ARCH, group)
    assert got == want
    if group == 128:
        assert got == {"['blocks']['mlp']['w_down']"}
        return
    assert "['blocks']['ssm']['a_log']" in got
    jcfg, tcfg, jparams, carried = model
    q, _, _ = tsl.quantize_params(carried, tsl.QuantPolicy(
        bits=4, group_size=64, min_size=256))
    assert isinstance(q["blocks"]["ssm"]["a_log"], tsl.StackedQTensor)
    toks = np.array([[1, 2, 3]])
    with pytest.raises(TypeError):
        jlm.prefill(reference_tree(q), toks, jcfg, cache_len=8)
    with pytest.raises(TypeError):
        tlm.prefill(q, toks, tcfg, 8, device="cpu")
