"""Temperature sampling in the port against the JAX reference: the key
stream (``fold_in``), the random words, the uniforms and ``categorical``
bit-equal to ``jax.random``'s and the Gumbel noise within 4 ulp; the
engine's sampler on the reference's ``_sample_rows_jit`` draw; and the
engine's sampled tokens equal to the reference engine's on tinymistral
smoke (ring and paged, ``uniform:8a8``, T 0.7, seed 7), whatever the pool
layout or a preemption.  Every input comes from a fixed numpy seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _hyp import given, settings, strategies as st

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import lm as jlm
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro.serving.engine import _sample_rows_jit
from repro_torch.convert import params_from_numpy
from repro_torch.core import prng
from repro_torch.serving.engine import Engine as TEngine
from repro_torch.serving.engine import EngineConfig as TEngineConfig

ARCH = "tinymistral_248m"
# (seed, uid, index): uid 0 (a dead lane), an index above 2**16, the
# largest uint32 uid, and a seed above 2**16
TRIPLES = [(7, 0, 0), (7, 3, 5), (0, 1, 70000), (123456, 65543, 65536),
           (11, 2**32 - 1, 1)]
GUMBEL_ULP = 4


def _jkey(seed, uid, index):
    return jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                 uid), index)


def _words(key):
    return tuple(int(w) for w in np.asarray(jax.random.key_data(key)))


def noise_ulps(got, want) -> float:
    """|got - want| in ulps of f32 at max(|want|, 1).  The noise is
    ``-log(-log u)``: where it nears 0 the outer log's input nears 1, and
    one ulp of the inner log there is thousands of ulps of the result, so
    the noise is held at its own scale, never finer than 1."""
    want = np.asarray(want, np.float32)
    scale = np.spacing(np.maximum(np.abs(want), np.float32(1)))
    diff = np.abs(np.asarray(got, np.float64) - want.astype(np.float64))
    return float((diff / scale).max())


@pytest.mark.parametrize("seed,uid,index", TRIPLES)
def test_fold_in_matches_jax(seed, uid, index):
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), uid), index)
    assert key == _words(_jkey(seed, uid, index))
    k0, k1 = prng.row_keys(seed, [uid, uid], [index, index])
    assert (int(k0[1]), int(k1[1])) == key


@pytest.mark.parametrize("vocab", [97, 32005])
@pytest.mark.parametrize("seed,uid,index", TRIPLES)
def test_draw_matches_jax_random(seed, uid, index, vocab):
    """The words and uniforms bit-equal, the Gumbel noise within 4 ulp and
    the categorical draw equal, in numpy and in torch (CPU)."""
    jkey = _jkey(seed, uid, index)
    key = _words(jkey)
    bits = prng.random_bits(key, (vocab,))
    assert (bits == np.asarray(jax.random.bits(jkey, (vocab,),
                                               jnp.uint32))).all()
    u = prng.uniform(key, (vocab,), prng.TINY, 1.0)
    ju = np.asarray(jax.random.uniform(jkey, (vocab,), minval=prng.TINY,
                                       maxval=1.0))
    assert (u.view(np.uint32) == ju.view(np.uint32)).all()
    jg = np.asarray(jax.random.gumbel(jkey, (vocab,)))
    assert noise_ulps(prng.gumbel(key, (vocab,)), jg) <= GUMBEL_ULP
    row = np.random.default_rng(seed % 1000).standard_normal(vocab) \
        .astype(np.float32) * 4
    want = int(jax.random.categorical(jkey, row))
    assert int(prng.categorical(key, row)) == want
    draw = prng.draw_rows(torch.from_numpy(row[None]), [uid], [index], seed,
                          1.0)
    assert (draw.bits.numpy().view(np.uint32)[0] == bits).all()
    assert (draw.uniform.numpy()[0].view(np.uint32) == ju.view(np.uint32)) \
        .all()
    assert noise_ulps(draw.gumbel.numpy()[0], jg) <= GUMBEL_ULP
    assert int(draw.tokens[0]) == want


@settings(max_examples=20, deadline=None, derandomize=True)
@given(seed=st.integers(0, 2**31 - 1), uid=st.integers(0, 2**32 - 1),
       index=st.integers(0, 2**32 - 1))
def test_property_key_stream_matches_jax(seed, uid, index):
    key = prng.fold_in(prng.fold_in(prng.prng_key(seed), uid), index)
    jkey = _jkey(seed, uid, index)
    assert key == _words(jkey)
    assert (prng.random_bits(key, (8,))
            == np.asarray(jax.random.bits(jkey, (8,), jnp.uint32))).all()


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_engine_draw_matches_reference_sampler(temperature):
    """``draw_rows`` on [8, 32005] logits, the reference's
    ``_sample_rows_jit`` on the same logits, uids and indices: equal
    tokens; the torch words and uniforms bit-equal to the numpy plain
    version's, its noise within 4 ulp."""
    rng = np.random.default_rng(3)
    logits = (rng.standard_normal((8, 32005)) * 3).astype(np.float32)
    uids = np.array([0, 1, 2, 3, 70000, 9, 10, 2**32 - 1], np.int64)
    indices = np.array([0, 1, 2, 3, 66000, 5, 6, 7], np.int64)
    want = np.asarray(_sample_rows_jit(
        jnp.asarray(logits), jnp.asarray(uids.astype(np.uint32)),
        jnp.asarray(indices.astype(np.uint32)), 7, temperature))
    plain = prng.draw_rows_np(logits, uids, indices, 7, temperature)
    draw = prng.draw_rows(torch.from_numpy(logits), uids, indices, 7,
                          temperature)
    assert (plain.tokens == want).all()
    assert (draw.tokens.numpy() == want).all()
    assert (draw.bits.numpy().view(np.uint32) == plain.bits).all()
    assert (draw.uniform.numpy().view(np.uint32)
            == plain.uniform.view(np.uint32)).all()
    assert noise_ulps(draw.gumbel.numpy(), plain.gumbel) <= GUMBEL_ULP


def test_temperature_divides_as_the_reference():
    """The reference's ``row / T`` runs under jit, where XLA multiplies by
    the f32 reciprocal; the port multiplies by the same number."""
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    got = jax.jit(lambda r: r / 0.7)(jnp.asarray(x))
    assert (np.asarray(got) == x * np.float32(prng.reciprocal(0.7))).all()


# --- the engine ---------------------------------------------------------------

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
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    return {c.uid: c.tokens for c in engine.run()}


@pytest.fixture(scope="module")
def reference_runs(smoke):
    """The reference engine's tokens: sampled on the ring and the paged
    pool, and greedy (tests/test_speculative.py's sampling test)."""
    jcfg, _, params, _ = smoke
    runs = {}
    for name, kw in (("ring", {}), ("paged", dict(kv_block_size=8)),
                     ("greedy", dict(temperature=0.0))):
        fields = {**ENGINE, "plan": "uniform:8a8", "temperature": 0.7,
                  "seed": 7, **kw}
        runs[name] = _serve(JEngine(params, jcfg, JEngineConfig(**fields)))
    return runs


@pytest.mark.parametrize("pool", ["ring", "paged"])
def test_sampled_tokens_match_reference(smoke, reference_runs, pool):
    _, tcfg, _, carried = smoke
    kw = dict(kv_block_size=8) if pool == "paged" else {}
    eng = TEngine(carried, tcfg, TEngineConfig(
        **ENGINE, plan="uniform:8a8", temperature=0.7, seed=7, **kw),
        device="cpu")
    got = _serve(eng)
    assert got == reference_runs[pool]
    # the pool layout changes where KV lives, never the key stream
    assert got == reference_runs["ring"]
    # and the draw is stochastic: greedy differs somewhere
    assert got != reference_runs["greedy"]
    assert all(len(t) == 6 for t in got.values())


def test_greedy_is_temperature_zero(smoke, reference_runs):
    _, tcfg, _, carried = smoke
    eng = TEngine(carried, tcfg, TEngineConfig(**ENGINE, plan="uniform:8a8"),
                  device="cpu")
    assert _serve(eng) == reference_runs["greedy"]


def test_sampling_invariant_to_batch_composition(smoke):
    """A request's tokens depend on (seed, uid, index) only: served alone
    in a one-slot pool, each request samples what it sampled among
    others."""
    _, tcfg, _, carried = smoke
    fields = dict(ENGINE, plan="uniform:4", temperature=0.9, seed=5)
    together = _serve(TEngine(carried, tcfg, TEngineConfig(**fields),
                              device="cpu"))
    alone = TEngine(carried, tcfg, TEngineConfig(**{**fields,
                                                    "batch_size": 1}),
                    device="cpu")
    assert _serve(alone) == together


def test_preempted_request_samples_as_unpreempted(smoke):
    """Paged pool at T > 0: a pool of one lane's blocks preempts and
    resumes requests, and every request samples the tokens it samples in
    a pool that never preempts (the resumed re-prefill draws the pending
    token under its original index)."""
    _, tcfg, _, carried = smoke
    prompts = [[5, 9, 2, 4, 11, 3, 8, 1, i] for i in range(6)]
    fields = dict(ENGINE, plan="uniform:4", temperature=0.8, seed=11,
                  kv_block_size=8, share_prefix=False)
    roomy = TEngine(carried, tcfg, TEngineConfig(**fields,
                                                 kv_pool_blocks=64),
                    device="cpu")
    want = _serve(roomy, prompts, max_new=20)
    tight = TEngine(carried, tcfg, TEngineConfig(**fields, kv_pool_blocks=8),
                    device="cpu")
    got = _serve(tight, prompts, max_new=20)
    assert tight.stats()["block_pool"]["preemptions"] > 0
    assert roomy.stats()["block_pool"]["preemptions"] == 0
    assert got == want
    tight.block_mgr.check_invariants()
