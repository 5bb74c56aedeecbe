"""The port's dense decoders against the JAX reference on the CPU: the six
dense configs besides tinymistral (llama2_7b, llama2_13b, llama3_2_1b,
qwen3_0_6b, h2o_danube_3_4b, starcoder2_7b) at smoke size, weights and
inputs from a numpy seed (``tests/_torch_models.py``: nonzero attention
and LayerNorm biases).  Per config: prefill and 4 decode steps at the reference's own ``test_decode_matches_forward`` tolerance
(2e-4), ``uniform:4`` logits, and the engine's greedy tokens on the ring
and the paged pool equal to the reference engine's.  Unit by unit: tanh
GELU, LayerNorm, qk-norm; the attention-bias quirk (the decode step and
the prefill cache leave the biases out); every config of the reference
ported and admitted; ``tp_supported`` for every config."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from _torch_models import (both, one_torch_thread, quantized_both,  # noqa: F401
                           reference_engine, serve)
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import distributed as jdist
from repro_torch.models import blocks as tblk
from repro_torch.models.common import ModelConfig as TModelConfig
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.serving import distributed as tdist
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

DENSE = ("llama2_7b", "llama2_13b", "llama3_2_1b", "qwen3_0_6b",
         "h2o_danube_3_4b", "starcoder2_7b")
TOL = dict(rtol=2e-4, atol=2e-4)
# group 8 divides every smoke width (64, 72, 80 and the FFN's)
POLICY = dict(bits=4, group_size=8, min_size=1024)
ENGINE = dict(batch_size=2, cache_len=32, plan="uniform:4", group_size=8,
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
            cache[arch] = (jcfg, tcfg) + both(jcfg, seed=DENSE.index(arch))
        return cache[arch]
    return get


def _tokens(jcfg, seed=0, shape=(2, 9)):
    return np.random.default_rng(seed).integers(0, jcfg.vocab, shape)


def _prefill_decode(jparams, carried, jcfg, tcfg, toks, steps=4):
    """(reference logits, port logits) of a prefill and ``steps`` greedy
    decode steps (the reference's tokens fed to both), int8 KV."""
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


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match(models, arch):
    jcfg, tcfg, jparams, carried = models(arch)
    want, got = _prefill_decode(jparams, carried, jcfg, tcfg, _tokens(jcfg))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_uniform4_logits_match(models, arch):
    """``uniform:4`` (group 8) on both sides, the reference fed the port's
    tree: prefill and decode logits at 2e-4 (the packed words are the
    reference's, tests/test_torch_quant.py and test_torch_moe.py)."""
    jcfg, tcfg, _, carried = models(arch)
    jq, tq, _, _ = quantized_both(carried, POLICY)
    want, got = _prefill_decode(jq, tq, jcfg, tcfg, _tokens(jcfg, 1),
                                steps=2)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("arch", DENSE)
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


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 97, dtype=np.float32)
    want = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    got = tlayers.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(erf - want).max() > 1e-4


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_norms_match(norm):
    cfg = dataclasses.replace(JC.get_smoke("starcoder2_7b"), norm=norm)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 5, cfg.d_model)).astype(np.float32) * 4 + 1
    p = {"scale": rng.standard_normal(cfg.d_model).astype(np.float32)}
    if norm == "layernorm":
        p["bias"] = rng.standard_normal(cfg.d_model).astype(np.float32)
    want = jlayers.apply_norm(jax.tree_util.tree_map(jnp.asarray, p),
                              jnp.asarray(x), cfg)
    got = tlayers.apply_norm({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-5)
    assert set(tlayers.norm_init(cfg)) == set(jlayers.norm_init(cfg))


def test_qk_norm_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 3, 4, 32)).astype(np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    want = jlayers._qk_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = tlayers.qk_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_attention_biases_only_in_full_sequence_attention(models):
    """starcoder2 smoke with nonzero biases: the prefill cache holds K and V
    without ``bk`` / ``bv`` (the reference's ``_kv_from_seq``), equal to the
    reference's cache, while the full-sequence attention adds them; the
    prefill and decode logits match the reference's
    (``test_forward_prefill_and_decode_match``)."""
    jcfg, tcfg, jparams, carried = models("starcoder2_7b")
    attn = tlm.layer_params(carried["blocks"], 0)["attn"]
    assert float(attn["bk"].abs().min()) > 0
    toks = _tokens(jcfg, 2)
    ref, aux = jlm.forward(jparams, toks, jcfg)
    got, taux = tlm.forward(carried, torch.from_numpy(toks), tcfg,
                            device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert float(taux) == float(aux) == 0
    _, jc = jlm.prefill(jparams, toks, jcfg, cache_len=16)
    _, tc = tlm.prefill(carried, toks, tcfg, 16, device="cpu")
    for name in ("k", "v"):
        np.testing.assert_allclose(tc["layers"][name].numpy(),
                                   np.asarray(jc["layers"][name]), **TOL)
    # layer 0's V from the embedding, with and without the bias
    x = tlm.embed_tokens(carried, torch.from_numpy(toks), tcfg)
    h = tlayers.apply_norm(tlm.layer_params(carried["blocks"], 0)
                           ["attn_norm"], x, tcfg)
    v = tblk._kv_from_seq(attn, h, tcfg, torch.arange(9).expand(2, 9))["v"]
    biased = (h @ attn["wv"] + attn["bv"]).reshape(v.shape)
    torch.testing.assert_close(tc["layers"]["v"][0, :, :9], v)
    assert (biased - v).abs().max() > 1e-2


def test_ported_configs_and_refusals():
    """Every arch of the reference is ported, in its order, with the
    reference's full and smoke configs; the decoder stack admits every
    decoder (dense, MoE, hybrid, recurrent, the vision prefix) and sends
    whisper's encoder-decoder to models/encdec.py; an unknown arch is
    refused by name."""
    assert TC.ARCHS == JC.ARCHS and len(TC.ARCHS) == 13
    for arch in TC.ARCHS:
        assert (dataclasses.asdict(TC.get_config(arch))
                == dataclasses.asdict(JC.get_config(arch)))
        assert (dataclasses.asdict(TC.get_smoke(arch))
                == dataclasses.asdict(JC.get_smoke(arch)))
        for cfg in (TC.get_config(arch), TC.get_smoke(arch)):
            if cfg.family == "encdec":
                with pytest.raises(NotImplementedError, match="encdec.py"):
                    tblk.check_supported(cfg)
            else:
                tblk.check_supported(cfg)
    with pytest.raises(ValueError, match="unknown arch"):
        TC.get_config("whisper_tiny")
    cfg = TModelConfig(**dataclasses.asdict(JC.get_config("llama3_2_1b")))
    with pytest.raises(NotImplementedError, match="not a decoder"):
        tblk.check_supported(dataclasses.replace(cfg, pos="learned"))


@pytest.mark.parametrize("tp", [2, 4, 8])
def test_tp_supported_matches_reference(tp):
    """The reason (or None) a ported config cannot serve tensor-parallel,
    full and smoke, is the reference's."""
    for arch in TC.ARCHS:
        for get in ("get_config", "get_smoke"):
            want = jdist.tp_supported(getattr(JC, get)(arch), tp)
            assert tdist.tp_supported(getattr(TC, get)(arch), tp) == want


@pytest.mark.parametrize("plan", ["uniform:4a8", "rules:mlp=3,attn=5a8,default=4"])
def test_plans_resolve_and_serve_as_the_reference(models, plan, monkeypatch):
    """starcoder2 smoke (LayerNorm, GELU, biases) under a uniform plan with
    8-bit activations and a rules plan: the reference's ``spec_hash`` and
    its engine's tokens (the reference fed the port's tree of the plan's
    policy)."""
    jcfg, tcfg, jparams, carried = models("starcoder2_7b")
    ecfg = dict(ENGINE, plan=plan)
    eng = TEngine(carried, tcfg, TEngineConfig(**ecfg), device="cpu")
    quantized = quantized_both(carried, dataclasses.asdict(eng.quant_policy))
    ref = reference_engine(jparams, jcfg, quantized, ecfg, monkeypatch)
    assert eng.plan.spec_hash == ref.plan.spec_hash
    assert serve(eng, PROMPTS, 4) == serve(ref, PROMPTS, 4)
