"""Quantized checkpoints in the port against the JAX reference: the
quantized tree's leaves and paths (``repro_torch.tree`` walks a
``QTensor`` as ``jax.tree_util`` walks the reference's registered
dataclass), ``quantized_template`` for every family, directories written
by either package's ``save_quantized`` restored bit for bit by the
other's ``restore_quantized`` (uniform, a mixed per-layer allocation and
an activation-bits plan; tinymistral and granite's expert stacks), the
port's counterparts of the reference's round-trip tests
(``tests/test_mixed_precision.py:219-250``,
``tests/test_joint_precision.py:452-469``,
``tests/test_planning.py:502-524``), and ``save`` refusing a leaf it
would have to pickle."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jck
import repro.configs as JC
import repro_torch.checkpoint as tck
import repro_torch.configs as TC
from repro.models import encdec as jencdec
from repro.models import lm as jlm
from repro.models import sail_linear as jsl
from repro.models.common import ModelConfig as JModelConfig
from repro.planning import PlanSpec as JPlanSpec
from repro_torch.convert import params_from_numpy
from repro_torch.core import sensitivity as tsens
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.models.common import ModelConfig as TModelConfig
from repro_torch.planning import Planner, PlanSpec
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)

from _torch_models import numpy_params

BASE = dict(group_size=32, min_size=1024)
# (name, policy fields of both packages) of the cross-package directories:
# uniform, a per-layer weight allocation that cuts blocks into segments,
# and activation bits (uniform, and per layer)
POLICIES = {
    "uniform4": dict(bits=4),
    "mixed": dict(bits=4, allocation={
        "per_path": {"['blocks']['attn']['wq']": (2, 8),
                     "['blocks']['mlp']['w_up']": 3, "['lm_head']": 6}}),
    "a8": dict(bits=4, act_bits=8, allocation={
        "per_path": {"['blocks']['attn']['wq']": (6, 4)},
        "act_per_path": {"['blocks']['attn']['wq']": (8, 4)}}),
}
ARCHS = ("tinymistral_248m", "granite_moe_1b_a400m")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def policies(fields):
    """(the reference's QuantPolicy, the port's) of ``fields``."""
    fields = dict(BASE, **fields)
    alloc = fields.pop("allocation", None)
    pols = []
    for sl in (jsl, tsl):
        a = None if alloc is None else sl.BitAllocation(**alloc)
        pols.append(sl.QuantPolicy(allocation=a, **fields))
    return pols


def host(x) -> np.ndarray:
    """A leaf as numpy, the port's packed int32 words as uint32."""
    if isinstance(x, torch.Tensor):
        a = x.numpy()
        return a.view(np.uint32) if a.dtype == np.int32 else a
    return np.asarray(x)


def statics(tree, qcls):
    """{path: (bits, abits, k)} of every quantized leaf."""
    out = {}

    def walk(node, path):
        if isinstance(node, qcls):
            out[path] = (node.bits, node.abits, node.k)
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
    walk(tree, "")
    return out


def assert_bit_equal(port_tree, ref_tree):
    """Leaf for leaf: the same keystr paths, dtypes and bits."""
    ref = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port = tree_flatten_with_path(port_tree)
    assert [p for p, _ in port] == [jax.tree_util.keystr(p) for p, _ in ref]
    for (path, t), (_, r) in zip(port, ref):
        a, b = host(t), np.asarray(r)
        assert a.dtype == b.dtype and np.array_equal(a, b), path


_TREES = {}


def smoke(arch):
    """(numpy weights, the reference's tree, the port's) of ``arch``'s
    smoke config, made once."""
    if arch not in _TREES:
        tree = numpy_params(JC.get_smoke(arch))
        _TREES[arch] = (tree, jax.tree_util.tree_map(jnp.asarray, tree),
                        params_from_numpy(tree, device="cpu"))
    return _TREES[arch]


# --- the tree ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_quantized_tree_paths_are_the_reference_keystrs(arch):
    """The port's quantized tree flattens as the reference's: three
    leaves per quantized weight at ``.packed`` / ``.scales`` /
    ``.codebook``, statics on the structure, and ``tree_unflatten`` puts
    them back (expert stacks as ``StackedQTensor``)."""
    _, _, carried = smoke(arch)
    jpol, tpol = policies(POLICIES["mixed"])
    tq, _, _ = tsl.quantize_params(carried, tpol)
    shapes = jax.eval_shape(lambda: jsl.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, smoke(arch)[0]), jpol)[0])
    want = [jax.tree_util.keystr(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [p for p, _ in tree_flatten_with_path(tq)]
    assert got == want
    assert any(p.endswith(".codebook") for p in got)
    back = tree_unflatten(tq, tree_leaves(tq))
    assert statics(back, (tsl.QTensor, tsl.StackedQTensor)) == \
        statics(tq, (tsl.QTensor, tsl.StackedQTensor))
    if arch.startswith("granite"):
        assert any(isinstance(x, tsl.StackedQTensor) for x in
                   tq["blocks"][0]["moe"].values())


@pytest.mark.parametrize("arch", sorted(JC.ARCHS))
def test_quantized_template_matches_reference(arch):
    """``quantized_template`` of every family's smoke tree: the reference's
    paths, shapes and dtypes (packed words int32 against uint32), and those
    of the port's own ``quantize_params`` on real weights."""
    jcfg, tcfg = JC.get_smoke(arch), TC.get_smoke(arch)
    jinit = jencdec.init_params if jcfg.family == "encdec" else jlm.init_params
    tinit = tencdec.init_params if tcfg.family == "encdec" else tlm.init_params
    jpol, tpol = policies(POLICIES["uniform4"])
    want = jax.tree_util.tree_flatten_with_path(jck.quantized_template(
        jax.eval_shape(lambda: jinit(jax.random.PRNGKey(0), jcfg)),
        jpol))[0]
    meta = tinit(tcfg, None, device="meta")
    got = tree_flatten_with_path(tck.quantized_template(meta, tpol))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, t), (_, s) in zip(got, want):
        assert t.device.type == "meta" and tuple(t.shape) == s.shape, path
        dtype = str(s.dtype).replace("uint32", "int32")
        assert str(t.dtype) == f"torch.{dtype}", path
    real = tsl.quantize_params(
        tinit(tcfg, torch.Generator().manual_seed(0), device="cpu"), tpol)[0]
    assert [(p, tuple(x.shape), x.dtype) for p, x in
            tree_flatten_with_path(real)] == \
        [(p, tuple(x.shape), x.dtype) for p, x in got]


# --- across the packages -------------------------------------------------

@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_reference_directory_restores_into_port(arch, name, tmp_path):
    """The reference quantizes and ``save_quantized``s; the port's
    ``restore_quantized`` from the raw template alone gives its tree bit
    for bit, with the same per-leaf bits, abits and segmentation, and
    ``restored_plan`` its plan (same JSON, same ``spec_hash``)."""
    _, jparams, carried = smoke(arch)
    jpol, _ = policies(POLICIES[name])
    jq, _, _ = jsl.quantize_params(jparams, jpol)
    jck.save_quantized(str(tmp_path), 2, jq, jpol)
    meta = tree_map(lambda x: torch.empty(x.shape, device="meta"), carried)
    back, extras = tck.restore_quantized(str(tmp_path), meta, device="cpu")
    assert_bit_equal(back, jq)
    assert statics(back, (tsl.QTensor, tsl.StackedQTensor)) == \
        statics(jq, (jsl.QTensor, jsl.StackedQTensor))
    if name != "uniform4":
        assert isinstance(back["blocks"], list) and len(back["blocks"]) == 2
    _, jextras = jck.restore_quantized(str(tmp_path), jparams)
    plan = tck.restored_plan(extras)
    assert plan.to_json() == jck.restored_plan(jextras).to_json()
    assert plan.spec_hash == jck.restored_plan(jextras).spec_hash


@pytest.mark.parametrize("name", sorted(POLICIES))
@pytest.mark.parametrize("arch", ARCHS)
def test_port_directory_restores_into_reference(arch, name, tmp_path):
    """The port quantizes and ``save_quantized``s (packed words written as
    uint32); the reference's ``restore_quantized`` gives the port's tree
    bit for bit, and its plan."""
    _, jparams, carried = smoke(arch)
    _, tpol = policies(POLICIES[name])
    tq, _, _ = tsl.quantize_params(carried, tpol)
    path = tck.save_quantized(str(tmp_path), 5, tq, tpol)
    with open(os.path.join(path, "leaf00000.npy"), "rb") as f:
        assert np.lib.format.read_array(f).dtype == np.uint32
    back, jextras = jck.restore_quantized(str(tmp_path), jparams)
    assert_bit_equal(tq, back)
    assert statics(back, (jsl.QTensor, jsl.StackedQTensor)) == \
        statics(tq, (tsl.QTensor, tsl.StackedQTensor))
    assert jck.restored_plan(jextras).to_json() == \
        PlanSpec.from_policy(tpol).to_json()


def test_words_with_the_top_bit_set_round_trip(tmp_path):
    """A packed word >= 2**31 (a negative int32 in the port) is written as
    that uint32 and read back as the same bits, never by a value cast."""
    words = torch.tensor([[-1, -2147483648], [2147483647, 5]],
                         dtype=torch.int32)
    qt = tsl.QTensor(packed=words, scales=torch.ones(1, 2),
                     codebook=torch.zeros(16), bits=4, group_size=8, k=8)
    tck.save(str(tmp_path), 1, {"w": qt})
    raw = np.load(os.path.join(tmp_path, "step_00000001", "leaf00000.npy"))
    assert raw.dtype == np.uint32 and raw[0, 0] == 0xFFFFFFFF
    assert raw[0, 1] == 0x80000000
    back, _ = tck.restore(str(tmp_path), {"w": qt})
    assert torch.equal(back["w"].packed, words)
    assert (back["w"].bits, back["w"].k) == (4, 8)


def test_save_refuses_what_it_would_pickle(tmp_path):
    for leaf in ("text", object(), np.array([{"a": 1}], dtype=object)):
        with pytest.raises(TypeError, match="leaf"):
            tck.save(str(tmp_path), 1, {"x": leaf})
    assert tck.latest_step(str(tmp_path)) is None


def test_meta_template_needs_a_device(tmp_path):
    tck.save(str(tmp_path), 1, {"w": torch.arange(6.0).reshape(2, 3)})
    meta = {"w": torch.empty(2, 3, device="meta")}
    with pytest.raises(ValueError, match="meta"):
        tck.restore(str(tmp_path), meta)
    back, _ = tck.restore(str(tmp_path), meta, device="cpu")
    assert torch.equal(back["w"], torch.arange(6.0).reshape(2, 3))


def test_restore_quantized_asks_for_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    _, _, carried = smoke("tinymistral_248m")
    _, tpol = policies(POLICIES["uniform4"])
    tck.save_quantized(str(tmp_path), 1,
                       tsl.quantize_params(carried, tpol)[0], tpol)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.restore_quantized(str(tmp_path), carried)


# --- the reference's round-trip tests, ported ------------------------------

def tiny():
    """The reference tests' tiny config (both packages) and its weights."""
    fields = dict(name="tiny", family="dense", vocab=64, d_model=32,
                  n_layers=2, n_heads=4, n_kv=2, d_ff=64, act="swiglu",
                  attn_chunk=16, max_seq=128)
    jcfg, tcfg = JModelConfig(**fields), TModelConfig(**fields)
    return tcfg, params_from_numpy(numpy_params(jcfg), device="cpu")


@pytest.mark.parametrize("b_a,b_b,b_l0,b_l1", [(2, 8, 2, 8), (3, 5, 4, 4),
                                              (6, 4, 8, 2)])
def test_checkpoint_roundtrip_mixed(b_a, b_b, b_l0, b_l1, tmp_path):
    """``tests/test_mixed_precision.py:219-250``, seeded: a mixed tree (a
    per-layer allocation segments the stack unless its layers agree)
    round-trips against its own template and from the raw tree alone."""
    _, params = tiny()
    alloc = tsl.BitAllocation(per_path={
        "['blocks']['attn']['wq']": (b_l0, b_l1),
        "['blocks']['mlp']['w_up']": b_a,
        "['lm_head']": b_b})
    pol = tsl.QuantPolicy(bits=4, allocation=alloc, **BASE)
    qtree, _, _ = tsl.quantize_params(params, pol)
    tck.save_quantized(str(tmp_path), 1, qtree, pol)
    back, _ = tck.restore(str(tmp_path), qtree)
    flat = tree_leaves(qtree)
    assert all(torch.equal(a, b) for a, b in zip(flat, tree_leaves(back)))
    back2, _ = tck.restore_quantized(str(tmp_path), params, device="cpu")
    qcls = (tsl.QTensor, tsl.StackedQTensor)
    assert statics(back2, qcls) == statics(qtree, qcls)
    assert isinstance(back2["blocks"], list) == (b_l0 != b_l1)
    assert all(torch.equal(a, b) for a, b in zip(flat, tree_leaves(back2)))


def test_checkpoint_roundtrip_activation_allocation(tmp_path):
    """``tests/test_joint_precision.py:452-469``: per-layer weight and
    activation bits come back leaf for leaf."""
    _, params = tiny()
    alloc = tsl.BitAllocation(
        per_path={"['blocks']['attn']['wq']": (6, 4)},
        act_per_path={"['blocks']['attn']['wq']": (8, 4),
                      "['blocks']['mlp']['w_up']": 6})
    pol = tsl.QuantPolicy(bits=4, allocation=alloc, act_bits=8, **BASE)
    qtree, _, _ = tsl.quantize_params(params, pol)
    tck.save_quantized(str(tmp_path), 1, qtree, pol)
    back, _ = tck.restore_quantized(str(tmp_path), params, device="cpu")
    qcls = (tsl.QTensor, tsl.StackedQTensor)
    got = {p: (b, ab) for p, (b, ab, _) in statics(back, qcls).items()}
    assert got == {p: (b, ab) for p, (b, ab, _) in
                   statics(qtree, qcls).items()}
    assert any(ab == 4 for _, ab in got.values())
    assert all(torch.equal(a, b)
               for a, b in zip(tree_leaves(qtree), tree_leaves(back)))


def test_checkpoint_carries_plan(tmp_path):
    """``tests/test_planning.py:502-524``: a solved plan rides along and
    rebuilds its policy; without one, a plan derived from the policy
    records the caller's ``quant_kv``."""
    cfg, params = tiny()
    base = tsl.QuantPolicy(bits=4, **BASE)
    toks = tsens.calibration_tokens(cfg.vocab, 2, 16)
    planner = Planner(params, cfg, PlanSpec.parse("auto:q4a8"), base=base,
                      tokens=toks,
                      scores=tsens.output_sensitivity(params, cfg, toks,
                                                      base),
                      act_scores=tsens.activation_sensitivity(
                          params, cfg, toks, base))
    res = planner.solve()
    qtree, _, _ = tsl.quantize_params(params, res.policy)
    tck.save_quantized(str(tmp_path), 0, qtree, res.policy, plan=res.spec)
    _, extras = tck.restore_quantized(str(tmp_path), params, device="cpu")
    plan = tck.restored_plan(extras)
    assert plan == res.spec and plan.spec_hash == res.spec.spec_hash
    assert plan.to_policy(base).allocation == res.policy.allocation
    # the reference reads the same plan
    assert JPlanSpec.from_json(extras["plan"]).spec_hash == plan.spec_hash
    tck.save_quantized(str(tmp_path), 1, qtree, res.policy, quant_kv=False)
    _, extras1 = tck.restore_quantized(str(tmp_path), params, step=1,
                                       device="cpu")
    derived = tck.restored_plan(extras1)
    assert derived is not None and derived.quant_kv is False
    assert derived.to_policy(base).allocation == res.policy.allocation
    assert tck.restored_plan({}) is None
