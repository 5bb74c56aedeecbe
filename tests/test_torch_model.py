"""The port's serving model against the JAX reference on tinymistral
smoke, with the reference's parameters carried across through numpy:
prefill and decode logits agree and greedy generation is token-identical,
under uniform:4 and uniform:4a8, with int8 KV on and off."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro_torch.configs as TC
from repro.models import lm as jlm
from repro.models.sail_linear import QuantPolicy as JPolicy
from repro.models.sail_linear import quantize_params as jquantize
from repro_torch.convert import params_from_numpy
from repro_torch.core.quant import QTensor
from repro_torch.models import lm as tlm
from repro_torch.models.sail_linear import QuantPolicy as TPolicy
from repro_torch.models.sail_linear import StackedQTensor
from repro_torch.models.sail_linear import quantize_params as tquantize

# f32 sums in another order (XLA's CPU dots vs PyTorch's) through two layers
LOGIT_TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "tinymistral_248m"


@pytest.fixture(scope="module")
def smoke():
    jcfg, tcfg = JC.get_smoke(ARCH), TC.get_smoke(ARCH)
    assert jcfg == tcfg or jcfg.__dict__ == tcfg.__dict__
    params = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, params


def _carry(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _quantized(smoke, abits):
    jcfg, tcfg, params = smoke
    q, _, _ = jquantize(params, JPolicy(bits=4, group_size=32, min_size=1024,
                                        act_bits=abits))
    return jcfg, tcfg, q, _carry(q)


PLANS = [pytest.param(None, id="uniform:4"), pytest.param(8, id="uniform:4a8")]
KV = [pytest.param(False, id="f32kv"), pytest.param(True, id="int8kv")]


@pytest.mark.parametrize("abits", PLANS)
@pytest.mark.parametrize("quant_kv", KV)
def test_prefill_and_decode_logits_match(smoke, abits, quant_kv):
    jcfg, tcfg, jp, tp = _quantized(smoke, abits)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab, size=(2, 9))
    lengths = np.array([9, 6], np.int32)
    jl, jcache = jlm.prefill(jp, jnp.asarray(prompt), jcfg, 32, quant_kv,
                             lengths=jnp.asarray(lengths))
    tl, tcache = tlm.prefill(tp, prompt, tcfg, 32, quant_kv, lengths=lengths,
                             device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        ref = np.asarray(jcache["layers"][name])
        got = tcache["layers"][name].numpy()
        if quant_kv:   # an int8 code may round the other way at a tie
            assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
        else:
            np.testing.assert_allclose(got, ref, **LOGIT_TOL)
    tok = np.asarray(jnp.argmax(jl, -1))[:, None]
    mask = np.array([True, False])
    for _ in range(3):
        jl, jcache = jlm.decode_step(jp, jnp.asarray(tok), jcache, jcfg,
                                     quant_kv, active_mask=jnp.asarray(mask))
        tl, tcache = tlm.decode_step(tp, tok, tcache, tcfg, quant_kv,
                                     active_mask=mask, device="cpu")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
        np.testing.assert_array_equal(tcache["length"].numpy(),
                                      np.asarray(jcache["length"]))
        tok = np.asarray(jnp.argmax(jl, -1))[:, None]


@pytest.mark.parametrize("abits", PLANS)
@pytest.mark.parametrize("quant_kv", KV)
def test_greedy_generate_token_identical(smoke, abits, quant_kv):
    jcfg, tcfg, jp, tp = _quantized(smoke, abits)
    prompt = np.random.default_rng(2).integers(0, jcfg.vocab, size=(3, 7))
    ref = jlm.greedy_generate(jp, jnp.asarray(prompt), jcfg, 8,
                              quant_kv=quant_kv)
    got = tlm.greedy_generate(tp, prompt, tcfg, 8, quant_kv=quant_kv,
                              device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_raw_tree_carried_across(smoke):
    """An unquantized tree converts too; its logits agree."""
    jcfg, tcfg, params = smoke
    tp = _carry(params)
    assert isinstance(tp["blocks"]["attn"]["wq"], torch.Tensor)
    prompt = np.random.default_rng(3).integers(0, jcfg.vocab, size=(1, 5))
    jl, _ = jlm.prefill(params, jnp.asarray(prompt), jcfg, 16)
    tl, _ = tlm.prefill(tp, prompt, tcfg, 16, device="cpu")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)


@pytest.mark.parametrize("abits", PLANS)
def test_quantize_params_bit_equal(smoke, abits):
    """The port's quantize_params on the carried-across raw tree gives the
    reference's quantized tree bit for bit (same leaves, same statics)."""
    _, _, jq_tree, carried = _quantized(smoke, abits)
    _, _, params = smoke
    policy = TPolicy(bits=4, group_size=32, min_size=1024, act_bits=abits)
    got, b0, b1 = tquantize(_carry(params), policy)
    _, jb0, jb1 = jquantize(params, JPolicy(bits=4, group_size=32,
                                            min_size=1024, act_bits=abits))
    assert (b0, b1) == (jb0, jb1)

    def same(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for key in a:
                same(a[key], b[key])
        elif isinstance(a, (QTensor, StackedQTensor)):
            assert type(a) is type(b)
            assert (a.bits, a.group_size, a.k, a.abits) == (
                b.bits, b.group_size, b.k, b.abits)
            for f in ("packed", "scales", "codebook"):
                assert torch.equal(getattr(a, f), getattr(b, f)), f
        else:
            assert torch.equal(a, b)

    same(got, carried)
    assert isinstance(got["blocks"]["mlp"]["w_down"], StackedQTensor)
    assert isinstance(got["lm_head"], QTensor)
    assert isinstance(got["embed"], torch.Tensor)       # gathers stay f32
