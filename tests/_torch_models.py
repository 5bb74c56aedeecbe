"""Shared helpers of the families tests (tests/test_torch_families.py,
tests/test_torch_moe.py, tests/test_torch_ssm.py, tests/test_torch_xlstm.py,
tests/test_torch_encdec.py): seeded numpy weights in the reference's tree
layout, carried into both packages, and the reference's engine fed a
quantized tree the port made (the two quantize bit for bit, which the
tests check; the reference quantizes eagerly, seconds a tree)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.serving import engine as jengine
from repro_torch.convert import params_from_numpy
from repro_torch.models import sail_linear as tsl

BIASES = ("['bq']", "['bk']", "['bv']", "['bo']", "['bias']")


def numpy_params(jcfg, seed: int = 0):
    """A parameter tree of ``jcfg``'s layout (the reference's
    ``init_params``, shapes only; ``encdec.init_params`` for whisper)
    filled from a numpy seed: weights N(0, 1) / sqrt(fan-in) (the
    embedding N(0, 1)), norm and qk-norm scales 1 + 0.1 N(0, 1), and every
    bias 0.1 N(0, 1), so the attention biases and LayerNorm biases are
    nonzero.  The SSM leaves the reference sets to a fixed function get its
    values: ``a_log = log(1..n)``, ``d_skip`` ones, ``conv_b`` zeros and
    ``dt_bias`` the inverse softplus of a log-uniform draw in [1e-3, 1e-1]
    (``repro/models/ssm.py:36-50``)."""
    init = jencdec.init_params if jcfg.family == "encdec" else jlm.init_params
    shapes = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(s.shape)
        if name.endswith("['a_log']"):
            x = np.log(np.broadcast_to(np.arange(1, s.shape[-1] + 1),
                                       s.shape))
        elif name.endswith("['d_skip']"):
            x = np.ones(s.shape)
        elif name.endswith("['conv_b']"):
            x = np.zeros(s.shape)
        elif name.endswith("['dt_bias']"):
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), s.shape))
            x = np.log(np.expm1(dt))
        elif name.endswith("['scale']"):
            x = 1 + 0.1 * x
        elif name.endswith(BIASES):
            x = 0.1 * x
        elif "embed" not in name:
            x = x / np.sqrt(s.shape[-2])
        return x.astype(np.float32)
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def both(jcfg, seed: int = 0):
    """(reference tree of jnp arrays, the port's tree on the CPU)."""
    tree = numpy_params(jcfg, seed)
    return (jax.tree_util.tree_map(jnp.asarray, tree),
            params_from_numpy(tree, device="cpu"))


def reference_tree(tree):
    """A port tree as the reference's: jnp leaves, quantized leaves as the
    reference's QTensor / StackedQTensor (int32 words back to uint32)."""
    if isinstance(tree, dict):
        return {k: reference_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(reference_tree(v) for v in tree)
    if isinstance(tree, (tsl.QTensor, tsl.StackedQTensor)):
        cls = (jsl.QTensor if isinstance(tree, tsl.QTensor)
               else jsl.StackedQTensor)
        return cls(packed=jnp.asarray(tree.packed.numpy().view(np.uint32)),
                   scales=jnp.asarray(tree.scales.numpy()),
                   codebook=jnp.asarray(tree.codebook.numpy()),
                   bits=tree.bits, group_size=tree.group_size, k=tree.k,
                   abits=tree.abits)
    return jnp.asarray(tree.numpy())


def quantized_both(carried, policy: dict):
    """(the reference's tree, the port's tree, bytes before, bytes after)
    of ``policy`` applied by the port."""
    tq, b0, b1 = tsl.quantize_params(carried, tsl.QuantPolicy(**policy))
    return reference_tree(tq), tq, b0, b1


def reference_engine(jparams, jcfg, quantized, ecfg: dict, monkeypatch):
    """The reference's Engine on ``jparams``, its quantization of them
    replaced by the port's (``quantized_both``'s result for ``ecfg``'s
    policy)."""
    jq, _, b0, b1 = quantized

    def carried(params, policy=jsl.QuantPolicy()):
        if params is jparams:
            return jq, b0, b1
        return jsl.quantize_params(params, policy)
    monkeypatch.setattr(jengine, "quantize_params", carried)
    return jengine.Engine(jparams, jcfg, jengine.EngineConfig(**ecfg))


def serve(engine, prompts, max_new):
    """Submit every prompt, run, and return {uid: tokens}."""
    for p in prompts:
        engine.submit(p, max_new_tokens=max_new)
    return {c.uid: c.tokens for c in engine.run()}


def quantized_paths_full(arch: str, group: int):
    """(the reference's quantized paths, the port's) of ``arch`` at its
    published width under the engine's policy (bits 4, ``group``,
    ``min_size`` 1024): the reference's ``quantize_params`` traced on
    shapes alone, the port's quantization rule on a tree made on the meta
    device."""
    import repro.configs as JC
    import repro_torch.configs as TC
    from repro_torch.models import encdec as tencdec
    from repro_torch.models import lm as tlm
    jcfg, tcfg = JC.get_config(arch), TC.get_config(arch)
    jinit = jencdec.init_params if jcfg.family == "encdec" else jlm.init_params
    tinit = tencdec.init_params if tcfg.family == "encdec" else tlm.init_params
    shapes = jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg))
    policy = dict(bits=4, group_size=group, min_size=1024)

    def quantize():
        zeros = jax.tree_util.tree_map(
            lambda s: jnp.zeros(s.shape, s.dtype), shapes)
        return jsl.quantize_params(zeros, jsl.QuantPolicy(**policy))[0]
    qcls = (jsl.QTensor, jsl.StackedQTensor)
    leaves = jax.tree_util.tree_flatten_with_path(
        jax.eval_shape(quantize), is_leaf=lambda x: isinstance(x, qcls))[0]
    want = {jax.tree_util.keystr(p) for p, x in leaves
            if isinstance(x, qcls)}
    tree = tinit(tcfg, None, device="meta")
    pol = tsl.QuantPolicy(**policy)
    got = {p for p, w in tsl.flatten_with_paths(tree)
           if tsl._should_quantize(p, w, pol)
           or tsl._should_quantize_stacked(p, w, pol)}
    return want, got


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
