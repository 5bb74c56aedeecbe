"""Placement and data parallelism in the port against the JAX reference.

The placement plan (``make_plan``, ``param_spec``, ``_trim_spec``,
``param_shardings``, ``data_shardings``, ``cache_shardings``) is held to
the reference's ``tuple(PartitionSpec)`` for every leaf of every
family's smoke tree, raw and quantized, under meshes (2, 1), (4, 2) and
(1, 1), FSDP on and off (``tests/test_dist.py:26-37`` included).  The
multi-rank cases run once, in gloo ranks on the CPU
(``tests/_torch_dp_ranks.py other``: a group of two and one of four): a
masked batch whose mask differs across ranks, the compressed all-reduce
against the reference's on four devices, and a (2, 2) mesh's groups.  The
reference runs in one JAX process with eight host devices, beside the
ranks.  The train steps are ``tests/test_torch_dp_train.py``'s."""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_dp_ranks as ranks
import repro.configs as JC
import repro_torch.configs as TC
from _torch_dp_runs import run_both
from repro.dist import compress as jcompress
from repro.dist import sharding as jsh
from repro.models import lm as jlm
from repro_torch.dist import sharding as tsh
from repro_torch.launch.mesh import Mesh
from repro_torch.models import encdec as tencdec
from repro_torch.models import lm as tlm
from repro_torch.models import sail_linear as tsl
from repro_torch.tree import tree_flatten_with_path

RTOL = 1e-5                # loss and nll, relative
MESHES = ((2, 1), (4, 2), (1, 1))
POLICY = dict(bits=4, group_size=32, min_size=1024)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the reference: the placement of every family's trees on meshes of up to
# 8 host devices, the compressed all-reduce on 4
REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    import repro.configs as C
    from repro.checkpoint import quantized_template
    from repro.dist import sharding as sh
    from repro.dist.compress import (init_error_state,
                                     make_compressed_allreduce)
    from repro.launch.mesh import make_mesh
    from repro.models import encdec, lm
    from repro.models.sail_linear import QuantPolicy
    from jax.sharding import PartitionSpec as P

    inputs = pickle.load(open(sys.argv[1], "rb"))
    out = {"placement": {}}

    def specs(tree):
        return {jax.tree_util.keystr(p): tuple(s.spec) for p, s in
                jax.tree_util.tree_flatten_with_path(tree)[0]}

    for arch in C.ARCHS:
        cfg = C.get_smoke(arch)
        init = encdec.init_params if cfg.family == "encdec" else \\
            lm.init_params
        raw = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), cfg))
        quant = quantized_template(raw, QuantPolicy(**%(policy)r))
        batch = {"tokens": jax.ShapeDtypeStruct((8, 17), jnp.int32)}
        if cfg.family != "encdec":
            cache = jax.eval_shape(lambda p: lm.init_cache(p, cfg, 4, 16,
                                                          quant_kv=True),
                                   raw)
        for shape in %(meshes)r:
            mesh = make_mesh(shape, ("data", "model"))
            for fsdp in (True, False):
                plan = sh.make_plan(mesh, cfg, fsdp)
                rec = dict(
                    plan=(plan.dp_axes, plan.tp_axis, plan.fsdp),
                    raw=specs(sh.param_shardings(mesh, raw, cfg, plan)),
                    quant=specs(sh.param_shardings(mesh, quant, cfg, plan)),
                    data=specs(sh.data_shardings(mesh, batch, plan)))
                if cfg.family != "encdec":
                    rec["cache"] = specs(sh.cache_shardings(mesh, cache,
                                                            plan))
                out["placement"][(arch, shape, fsdp)] = rec
    out["default_plan"] = {
        shape: (lambda p: (p.dp_axes, p.tp_axis, p.fsdp))(
            sh.make_plan(make_mesh(shape, ("data", "model")), None))
        for shape in %(meshes)r}

    mesh = make_mesh((4,), ("data",))
    spec = {k: P("data", None) for k in inputs["compress"][0]}
    fn = make_compressed_allreduce(mesh, ("data",), spec)
    err = init_error_state(inputs["compress"][0])
    rounds = []
    with mesh:
        for grads in inputs["compress"]:
            mean, err = fn({k: jnp.asarray(v) for k, v in grads.items()},
                           err)
            rounds.append(dict(
                mean={k: jax.device_get(v) for k, v in mean.items()},
                err={k: jax.device_get(v) for k, v in err.items()}))
    out["compress"] = rounds
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's results, {(world, rank): the port's})."""
    inputs, want, got = run_both(
        tmp_path_factory.mktemp("dp"), "other",
        [REFERENCE % dict(policy=POLICY, meshes=MESHES)])
    return inputs, want[0], got


def layout(shape) -> Mesh:
    """A mesh's layout alone (no process group): what the placement
    functions read."""
    return Mesh(axis_names=("data", "model"), shape=shape,
                ranks=np.arange(int(np.prod(shape))).reshape(shape),
                groups={}, rank=0)


def port_specs(tree):
    return {p: tuple(s) for p, s in tree_flatten_with_path(tree)}


# --- placement -------------------------------------------------------------

def test_param_spec_rules():
    """``tests/test_dist.py:26-37`` in both packages."""
    cfg = TC.get_smoke("llama3_2_1b")
    plan = tsh.Plan(dp_axes=("data",), fsdp=True)
    jplan = jsh.Plan(dp_axes=("data",), fsdp=True)
    for path, shape, want in (
            ("['blocks']['attn']['wq']", (2, 64, 128), (None, "data",
                                                        "model")),
            ("['blocks']['attn']['wo']", (2, 128, 64), (None, "model",
                                                        "data")),
            ("['embed']", (256, 64), ("model", None)),
            ("['final_norm']['scale']", (64,), (None,)),
            ("['blocks']['attn']['wq'].packed", (2, 8, 128),
             (None, "data", "model")),
            ("['blocks']['attn']['wq'].codebook", (2, 16), (None, None)),
            ("['x']", (), ())):
        got = tsh.param_spec(path, shape, cfg, plan)
        assert tuple(got) == want == tuple(jsh.param_spec(path, shape, cfg,
                                                          jplan)), path


def test_trim_spec_matches_reference():
    """Absent axes and axes that do not divide their dim are dropped, the
    rank padded and cut, tuples of axes narrowed."""
    class RefMesh:           # what the reference's _trim_spec reads
        def __init__(self, shape):
            self.axis_names = ("data", "model")
            self.devices = np.empty(shape)
    for shape in MESHES:
        for spec, dims in ((("data", "model"), (8, 6)),
                           ((("pod", "data"), None), (4, 4)),
                           ((("data", "model"),), (16,)),
                           (("model",), (3, 5, 7)), ((), (2,)),
                           (("data", None, "model"), (4, 4))):
            want = jsh._trim_spec(jax.sharding.PartitionSpec(*spec), dims,
                                  RefMesh(shape))
            assert tuple(tsh._trim_spec(spec, dims, layout(shape))) == \
                tuple(want), (shape, spec, dims)
            assert tsh._axis_size(layout(shape), spec[0] if spec else None) \
                == jsh._axis_size(RefMesh(shape), spec[0] if spec else None)


@pytest.mark.parametrize("arch", sorted(TC.ARCHS))
def test_placement_matches_reference(arch, runs):
    """Every leaf of ``arch``'s raw and quantized smoke trees, its input
    batch and (decoders) its int8 decode cache, under each mesh with FSDP
    on and off: the reference's specs."""
    _, want, _ = runs
    cfg = TC.get_smoke(arch)
    init = tencdec.init_params if cfg.family == "encdec" else tlm.init_params
    raw = init(cfg, None, device="meta")
    quant = tsl.quantized_shapes(raw, tsl.QuantPolicy(**POLICY))
    batch = {"tokens": torch.empty((8, 17), dtype=torch.int32,
                                   device="meta")}
    cache = None if cfg.family == "encdec" else tlm.init_cache(
        cfg, 4, 16, quant_kv=True, device="meta")
    for shape in MESHES:
        mesh = layout(shape)
        assert (lambda p: (p.dp_axes, p.tp_axis, p.fsdp))(
            tsh.make_plan(mesh, cfg)) == want["default_plan"][shape]
        for fsdp in (True, False):
            rec = want["placement"][(arch, shape, fsdp)]
            plan = tsh.make_plan(mesh, cfg, fsdp)
            assert (plan.dp_axes, plan.tp_axis, plan.fsdp) == rec["plan"]
            assert port_specs(tsh.param_shardings(mesh, raw, cfg, plan)) == \
                rec["raw"]
            assert port_specs(tsh.param_shardings(mesh, quant, cfg,
                                                  plan)) == rec["quant"]
            assert port_specs(tsh.data_shardings(mesh, batch, plan)) == \
                rec["data"]
            if cache is not None:
                got = port_specs(tsh.cache_shardings(mesh, cache, plan))
                assert got == rec["cache"]


@pytest.mark.parametrize("arch", sorted(ranks.MASKED))
def test_masked_loss_is_the_global_batch_loss(arch, runs):
    """A mask dense on rank 0's rows and sparse on rank 1's: the ranks'
    summed shares give the reference's loss and nll of the whole batch
    (the nll's denominator and the MoE fractions are the batch's)."""
    inputs, _, got = runs
    tree, _, masked = inputs[arch]
    jcfg = JC.get_smoke(arch)
    loss, m = jlm.loss_fn(jax.tree_util.tree_map(jnp.asarray, tree),
                          {k: jnp.asarray(v) for k, v in masked.items()},
                          jcfg)
    for r in range(2):
        g_loss, g_nll = got[(2, r)]["masked"][arch]
        assert abs(g_loss - float(loss)) <= RTOL * abs(float(loss))
        assert abs(g_nll - float(m["nll"])) <= RTOL * abs(float(m["nll"]))
    if jcfg.family == "moe":
        assert float(m["aux"]) > 0


def test_compressed_allreduce_matches_reference(runs):
    """Two rounds on four ranks with error feedback: each rank's codes
    equal the reference's quantize-dequantize of its ``grad + err`` bit for
    bit, the error state is bit-equal, the mean within one f32 ulp."""
    _, want, got = runs
    n = ranks.COMPRESS_ROWS
    for i, ref in enumerate(want["compress"]):
        for r in range(4):
            rec = got[(4, r)]["compress"][i]
            rows = slice(r * n, (r + 1) * n)
            for k in ref["err"]:
                y = np.asarray(jcompress._quantize_dequantize(
                    jnp.asarray(rec["x"][k])))
                codes = rec["codes"][k].astype(np.float32)
                assert np.array_equal(codes * np.float32(rec["scale"][k]), y)
                assert np.abs(rec["codes"][k]).max() == 127
                assert np.array_equal(rec["err"][k],
                                      np.asarray(ref["err"][k])[rows]), k
                w = np.asarray(ref["mean"][k])[rows]
                ulp = np.spacing(np.abs(w).astype(np.float32))
                assert (np.abs(rec["mean"][k] - w) <= ulp).all(), k
                # every rank holds the same mean
                assert np.array_equal(rec["mean"][k],
                                      got[(4, 0)]["compress"][i]["mean"][k])


def test_mesh_groups(runs):
    """A (2, 2) mesh over four ranks: rank r sits at (r // 2, r % 2); the
    data group sums a column's ranks and the model group a row's."""
    _, _, got = runs
    for r in range(4):
        d, m = r // 2, r % 2
        rec = got[(4, r)]["mesh"]
        assert rec["data"] == (d, float(m + (m + 2)))
        assert rec["model"] == (m, float(2 * d + (2 * d + 1)))
    assert got[(4, 0)]["mesh"]["describe"].startswith(
        "mesh {'data': 2, 'model': 2} on 4 ranks (gloo")


def test_one_process_mesh_and_refusals():
    """Without a process group a mesh is one process; a mesh larger than
    the group, a model axis in training over a config that does not train
    tensor-parallel yet (xlstm's recurrent state, ROADMAP Queue 1 item 5d
    (ii)), and a split that would cut MoE dispatch groups across ranks
    are refused."""
    from repro_torch.launch.mesh import describe, make_mesh
    from repro_torch.launch.steps import build_train_step
    mesh = make_mesh((1, 1), ("data", "model"))
    assert mesh.groups == {"data": None, "model": None}
    assert describe(mesh) == "mesh {'data': 1, 'model': 1} on 1 ranks " \
        "(none; this rank 0)"
    with pytest.raises(ValueError, match="process group of 2"):
        make_mesh((2, 1), ("data", "model"))
    cfg = TC.get_smoke("xlstm_350m")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_train_step(cfg, mesh=layout((1, 2)), microbatches=1,
                         bf16_compute=False, device="cpu")
    # one rank of two: granite at 2 x 128 tokens per rank would cut the
    # global batch's 512-token dispatch group in two
    dp = build_train_step(TC.get_smoke("granite_moe_1b_a400m"),
                          mesh=layout((2, 1)), microbatches=1,
                          bf16_compute=False, device="cpu").meta["dp"]
    batch = {"tokens": torch.zeros((2, 129), dtype=torch.int32)}
    with pytest.raises(ValueError, match="straddle"):
        dp.check_dispatch(batch, 1)
    dp.check_dispatch({"tokens": torch.zeros((2, 257), dtype=torch.int32)},
                      1)
    rows = dp.rows({"x": torch.arange(8)}, microbatches=2)
    assert rows["x"].tolist() == [0, 1, 4, 5]
