"""Tensor-parallel training on the CPU: the port's train step over a
``(data, model)`` mesh against the JAX reference's ``build_train_step``
on a mesh of as many devices — tinymistral at (1, 2) and (2, 2) with FSDP
on and off, llama3_2_1b (tied embeddings) at (4, 2), the reference test's
mesh (``tests/test_dist.py``), qwen3_0_6b (qk-norm) at (1, 2),
starcoder2 (attention biases) at (1, 2), granite (MoE) at (1, 2) and at
(2, 2) with FSDP, mixtral (MoE, sliding window) at (1, 2), three steps
each; Megatron's collectives (``tp_all_reduce`` and ``tp_copy``) in one
forward and backward at (1, 2), of the loss and of one MoE layer and one
starcoder2 attention, and in serving's forward; a (2, 2) checkpoint
resumed on one device and restored by the reference; the launcher's
``--mesh 1x2`` for tinymistral and granite; ``build_train_step``'s
reference signature (the shape third, its defaults).

The port's ranks run once, in gloo groups of two, four and eight on the
CPU (``tests/_torch_tp_train_ranks.py``), beside one reference process
per config with eight JAX host devices and the launcher's two ranks."""
import dataclasses
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_train_ranks as ranks
import repro.checkpoint as jck
import repro.configs as JC
import repro_torch.configs as TC
from repro.optim.adamw import AdamWState as JAdamWState
from repro_torch.checkpoint import latest_step, restore
from repro_torch.convert import params_from_numpy
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.dist.sharding import tp_all_reduce, tp_context, tp_copy
from repro_torch.launch import train as ttrain
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.steps import build_train_step, tp_train_supported
from repro_torch.serving.distributed import tp_supported
from repro_torch.models import lm
from repro_torch.optim.adamw import AdamWState
from repro_torch.training.loop import TrainLoop, TrainLoopConfig
from repro_torch.tree import tree_flatten_with_path, tree_leaves

from _torch_models import numpy_params

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")
TIMEOUT_S = 300
RTOL = 1e-5                # loss, nll and grad norm, relative
PARAM_TOL = 1e-5           # parameters after the steps, of each leaf's max
GRAD_TOL = 1e-5            # one backward's gradients, of each leaf's max
# the update (after - init) against the reference's, as in
# tests/test_torch_dp_train.py: within UPDATE_TOL of the leaf's largest
# update plus one f32 ulp of the parameter per step, in all but
# UPDATE_OUTLIERS of a leaf's elements; a leaf left at its init would miss
# it in more than UNCHANGED_MISS of its elements (one of qwen3's 64
# k-norm entries steps by under 1e-6 in the reference)
UPDATE_TOL = 1e-3
UPDATE_OUTLIERS = 1e-2
UNCHANGED_MISS = 0.9
LAUNCH_ARGS = ["--arch", "tinymistral_248m", "--smoke", "--device", "cpu",
               "--global-batch", "8", "--seq", "32", "--steps", "2"]
LAUNCH_ARCHS = ("tinymistral_248m", "granite_moe_1b_a400m")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the reference's train steps of one config, each on a mesh of as many
# host devices
REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    import repro.configs as C
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_step

    inputs = pickle.load(open(sys.argv[1], "rb"))
    shard = lambda t: [x.sharding.shard_shape(x.shape)
                       for x in jax.tree_util.tree_leaves(t)]
    out = {}
    for arch, shape, fsdp in %(cases)r:
        cfg = C.get_smoke(arch)
        tree, batches = inputs[arch]
        mesh = make_mesh(shape, ("data", "model"))
        built = build_train_step(cfg, mesh, fsdp=fsdp, microbatches=1,
                                 bf16_compute=False)
        params = jax.tree_util.tree_map(jnp.asarray, tree)
        opt_state = built.meta["optimizer"].init(params)
        metrics = []
        with mesh:
            for batch in batches:
                params, opt_state, m = built.fn(
                    params, opt_state,
                    {k: jnp.asarray(v) for k, v in batch.items()})
                metrics.append({k: float(v) for k, v in m.items()})
        out[(arch, shape, fsdp)] = dict(
            metrics=metrics, params=jax.device_get(params),
            shard_shapes=shard(params), moment_shapes=shard(opt_state.mu))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def env(**extra):
    out = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    out["PYTHONPATH"] = SRC + os.pathsep + out.get("PYTHONPATH", "")
    return out


def make_inputs():
    """{config: (numpy weights, the train steps' global batches)}:
    tinymistral's from ``SyntheticLM``; llama's one batch three times, as
    the reference test steps twice on one batch."""
    out = {}
    for arch, (b, t) in ranks.SHAPES.items():
        cfg = TC.get_smoke(arch)
        data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t,
                                      global_batch=b))
        batches = [data.next_batch() for _ in range(ranks.STEPS)]
        if arch == "llama3_2_1b":
            batches = [batches[0]] * ranks.STEPS
        out[arch] = (numpy_params(JC.get_smoke(arch)), batches)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Everything that runs in other processes, side by side: (inputs,
    the reference's results by case, {(world, rank): the port's}, the
    launcher's (1, 2) and one-device checkpoint directories and its
    output, the directory the (2, 2) loop checkpointed to)."""
    tmp = tmp_path_factory.mktemp("tp_train")
    inputs = make_inputs()
    inputs_path = str(tmp / "inputs.pkl")
    with open(inputs_path, "wb") as f:
        pickle.dump(inputs, f)
    procs = []
    for i, arch in enumerate(ranks.SHAPES):
        code = REFERENCE % dict(cases=[c for c in ranks.CASES
                                       if c[0] == arch])
        out = str(tmp / f"reference{i}.pkl")
        procs.append((out, subprocess.Popen(
            [sys.executable, "-c", code, inputs_path, out],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env(XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8"))
        )))
    launchers = {}
    for arch in LAUNCH_ARCHS:
        mesh_dir = str(tmp / f"launch12_{arch}")
        launchers[arch] = (mesh_dir, str(tmp / f"launch1_{arch}"),
                           subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.train"]
            + launch_args(arch) + ["--mesh", "1x2", "--ckpt", mesh_dir],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env()))
    try:
        port = subprocess.run(
            [sys.executable, ranks.__file__, str(tmp), inputs_path],
            capture_output=True, text=True, env=env(), timeout=TIMEOUT_S)
        launched = {}
        for arch, (_, one_dir, proc) in launchers.items():
            ttrain.main(launch_args(arch) + ["--ckpt", one_dir])
            launched[arch] = proc.communicate(timeout=TIMEOUT_S)
        errs = [p.communicate(timeout=TIMEOUT_S)[1] for _, p in procs]
    finally:
        for _, _, proc in launchers.values():
            proc.kill()
        for _, p in procs:
            p.kill()
    assert port.returncode == 0, port.stderr[-3000:]
    for arch, (_, _, proc) in launchers.items():
        assert proc.returncode == 0, launched[arch][1][-3000:]
    want = {}
    for (out, p), err in zip(procs, errs):
        assert p.returncode == 0, err[-3000:]
        with open(out, "rb") as f:
            want.update(pickle.load(f))
    got = {}
    for world in (2, 4, 8):
        for r in range(world):
            with open(tmp / f"w{world}_rank{r}.pkl", "rb") as f:
                got[(world, r)] = pickle.load(f)
    return dict(inputs=inputs, want=want, got=got, launch={
        arch: (mesh_dir, one_dir, launched[arch][0])
        for arch, (mesh_dir, one_dir, _) in launchers.items()},
        ckpt=str(tmp / "ckpt22"))


def launch_args(arch):
    args = LAUNCH_ARGS[:]
    args[args.index("tinymistral_248m")] = arch
    return args


def world_of(shape):
    return shape[0] * shape[1]


@pytest.mark.parametrize("case", ranks.CASES,
                         ids=[f"{a.split('_')[0]}-{d}x{m}-"
                              f"{'default' if f is None else 'fsdp' if f else 'replicated'}"
                              for a, (d, m), f in ranks.CASES])
def test_train_step_matches_reference_mesh(case, runs):
    """Three steps: loss, nll and grad norm within 1e-5 relative of the
    reference's step on a mesh of as many devices, the step counter equal,
    every rank alike; each rank's local parameter and moment shapes the
    reference's per-device shards; leaves the model axis does not shard
    bit-equal across each data coordinate's model ranks; the parameters
    after the steps within 1e-5 of each leaf's max, and their updates the
    reference's in all but UPDATE_OUTLIERS of each leaf's elements."""
    arch, shape, fsdp = case
    ref = runs["want"][case]
    world = world_of(shape)
    recs = [runs["got"][(world, r)] for r in range(world)]
    first = recs[0]["train"][case]
    assert first["plan"] == (("data",), "model",
                             shape[0] > 1 if fsdp is None else fsdp)
    for rec in recs:
        mine = rec["train"][case]
        for m, w in zip(mine["metrics"], ref["metrics"]):
            assert m["step"] == w["step"]
            for key in ("loss", "nll", "grad_norm"):
                assert abs(m[key] - w[key]) <= RTOL * abs(w[key]), key
        assert mine["metrics"] == first["metrics"]
        assert mine["local_shapes"] == [tuple(s) for s in
                                        ref["shard_shapes"]]
        assert mine["moment_shapes"] == [tuple(s) for s in
                                         ref["moment_shapes"]]
    # the leaves stored whole along the model axis (the final norm), and
    # every leaf whose local shape is its full shape, bit-equal across a
    # data coordinate's model ranks
    full = [tuple(np.shape(x)) for x in jax.tree_util.tree_leaves(
        ref["params"])]
    for d in range(shape[0]):
        group = [rec["train"][case] for rec in recs
                 if rec["coords"][0] == d]
        for i, s in enumerate(first["local_shapes"]):
            if s == full[i] or len(s) == 1:
                for other in group[1:]:
                    assert np.array_equal(other["local"][i],
                                          group[0]["local"][i]), i
    if arch == "llama3_2_1b":             # tests/test_dist.py's check
        assert first["metrics"][1]["loss"] < first["metrics"][0]["loss"]
        assert ref["metrics"][1]["loss"] < ref["metrics"][0]["loss"]
    flat = tree_flatten_with_path(first["params"])
    init = jax.tree_util.tree_leaves(runs["inputs"][arch][0])
    for (path, p), w, p0 in zip(
            flat, jax.tree_util.tree_leaves(ref["params"]), init):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(p - w).max()) <= PARAM_TOL * scale, path
        tol = (UPDATE_TOL * float(np.abs(w - p0).max())
               + ranks.STEPS * np.spacing(np.abs(w)))
        assert (np.abs(p - w) > tol).mean() <= UPDATE_OUTLIERS, path
        assert (np.abs(p0 - w) > tol).mean() > UNCHANGED_MISS, path


def one_device_grads(inputs, remat):
    """The port's one-device loss and gradients of tinymistral's first
    batch, by path."""
    arch = "tinymistral_248m"
    tree, batches = inputs[arch]
    cfg = dataclasses.replace(TC.get_smoke(arch), remat=remat)
    params = params_from_numpy(tree, device="cpu")
    ps = [p.requires_grad_() for p in tree_leaves(params)]
    loss, _ = lm.loss_fn(params, {k: torch.from_numpy(v) for k, v in
                                  batches[0].items()}, cfg, device="cpu")
    gs = torch.autograd.grad(loss, ps)
    return float(loss.detach()), {path: g.numpy() for (path, _), g in
                         zip(tree_flatten_with_path(params), gs)}


def one_device_layer_grads(inputs, arch, layer, mode, remat):
    """The port's one-device loss and gradients of ``ranks.layer_loss``
    on layer 0's whole weights, by name (``"x"``: the input's)."""
    _, _, b, t = next(e for e in ranks.LAYERS if e[0] == arch)
    cfg = dataclasses.replace(TC.get_smoke(arch), remat=remat)
    full = ranks.layer_params(params_from_numpy(inputs[arch][0],
                                                device="cpu"), layer)
    p = {k: v.requires_grad_() for k, v in full.items()}
    x0, w = ranks.layer_inputs(torch, arch, b, t)
    x = x0.requires_grad_()
    loss = ranks.layer_loss(torch, layer, p, x, w, cfg, remat, mode)
    gs = torch.autograd.grad(loss, list(p.values()) + [x])
    return float(loss.detach()), {k: g.numpy() for k, g in
                                  zip(list(p) + ["x"], gs)}


def assert_layer_collectives(runs, remat):
    """Each ``ranks.LAYERS`` entry at (1, 2): the loss and every gradient
    within 1e-5 of one device's (each leaf's max; a sharded leaf's
    rank slice), the whole leaves' and the input's bit-equal on both
    ranks; remat off, a MoE layer issues 1 all-reduce forward (the
    combined [T, D] output) and 2 backward (``tp_copy`` of the experts'
    [T, D] input and of the [T, k] routing weights), an attention 1 and
    1 of [T, D]; remat on, at least those, in the same order on both
    ranks."""
    for arch, layer, b, t in ranks.LAYERS:
        cfg = TC.get_smoke(arch)
        act = (b * t * cfg.d_model, "torch.float32")
        modes = ("dispatch", "dense") if layer == "moe" else ("dispatch",)
        for mode in modes:
            key = (arch, mode, remat)
            loss, want = one_device_layer_grads(runs["inputs"], arch, layer,
                                                mode, remat)
            recs = [runs["got"][(2, r)]["layers"][key] for r in range(2)]
            for r, rec in enumerate(recs):
                assert abs(rec["loss"] - loss) <= RTOL * abs(loss), key
                assert rec["grads"].keys() == want.keys()
                for name, g in rec["grads"].items():
                    w = want[name]
                    if g.shape != w.shape:      # rank r's shard
                        axis = next(i for i, (a, c) in enumerate(
                            zip(g.shape, w.shape)) if a != c)
                        w = np.split(w, 2, axis=axis)[r]
                    scale = max(float(np.abs(w).max()), 1e-30)
                    assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, \
                        (key, name)
            whole = [n for n, g in recs[0]["grads"].items()
                     if g.shape == want[n].shape]
            assert "x" in whole and ("router" in whole if layer == "moe"
                                     else "bo" in whole), whole
            for name in whole:
                assert np.array_equal(recs[0]["grads"][name],
                                      recs[1]["grads"][name]), (key, name)
            want_calls = {act} | ({(b * t * cfg.top_k, "torch.float32")}
                                  if layer == "moe" else set())
            assert set(recs[0]["calls"]) == want_calls, key
            n = 3 if layer == "moe" else 2
            assert (len(recs[0]["calls"]) >= n if remat
                    else len(recs[0]["calls"]) == n), key
            assert recs[0]["calls"] == recs[1]["calls"], key


@pytest.mark.parametrize("remat", [False, True])
def test_collectives_give_whole_gradients(runs, remat):
    """One forward and backward at (1, 2) under ``tp_context``: every
    model rank holds the one-device gradients of the norms and the
    embedding (within 1e-5 of each leaf's max, bit-equal across the
    ranks) and its slice of the block matrices'; remat off, the ranks
    issue 2 all-reduces per layer forward (``wo``, ``w_down``) and 2
    backward (``tp_copy`` before ``wq/wk/wv`` and ``w_gate/w_up``), each
    of one [B, T, D] f32 activation; remat on, at least those, the
    recomputed forward's in the same order on both ranks.  The same for
    one MoE layer (dispatch and dense modes: the router's gradient whole,
    the experts' sliced) and one starcoder2 attention (``bq`` / ``bk`` /
    ``bv`` sliced with their heads, ``bo`` whole):
    ``assert_layer_collectives``."""
    assert_layer_collectives(runs, remat)
    cfg = TC.get_smoke("tinymistral_248m")
    loss, want = one_device_grads(runs["inputs"], remat)
    recs = [runs["got"][(2, r)]["collectives"][f"grad_remat{int(remat)}"]
            for r in range(2)]
    b, t = ranks.SHAPES["tinymistral_248m"]
    act = (b * t * cfg.d_model, "torch.float32")
    for r, rec in enumerate(recs):
        assert abs(rec["loss"] - loss) <= RTOL * abs(loss)
        for path, g in rec["grads"].items():
            w = want[path]
            if g.shape != w.shape:          # a block matrix: rank r's slice
                axis = next(i for i, (a, c) in enumerate(zip(g.shape,
                                                             w.shape))
                            if a != c)
                w = np.split(w, 2, axis=axis)[r]
            scale = max(float(np.abs(w).max()), 1e-30)
            assert float(np.abs(g - w).max()) <= GRAD_TOL * scale, path
        assert set(rec["calls"]) == {act}
        if not remat:
            assert len(rec["calls"]) == 4 * cfg.n_layers
        else:
            assert len(rec["calls"]) >= 4 * cfg.n_layers
    for path in ("['embed']", "['final_norm']['scale']",
                 "['blocks']['attn_norm']['scale']",
                 "['blocks']['mlp_norm']['scale']"):
        assert np.array_equal(recs[0]["grads"][path],
                              recs[1]["grads"][path]), path
    assert recs[0]["calls"] == recs[1]["calls"]


def test_serving_forward_launches_what_it_did(runs):
    """The forward pass at (1, 2) under ``no_grad`` and with grad on over
    plain tensors (serving's mode): 2 all-reduces per layer, each of one
    [B, T, D] f32 activation, and no ``tp_copy`` collective; the logits
    equal on both ranks and within 1e-5 of the one-device forward's."""
    arch = "tinymistral_248m"
    cfg = TC.get_smoke(arch)
    tree, batches = runs["inputs"][arch]
    tokens = torch.from_numpy(batches[0]["tokens"][:, :-1])
    with torch.no_grad():
        want, _ = lm.forward(params_from_numpy(tree, device="cpu"), tokens,
                             cfg, device="cpu")
    want = want.numpy()
    act = (tokens.numel() * cfg.d_model, "torch.float32")
    for name in ("no_grad", "plain"):
        recs = [runs["got"][(2, r)]["collectives"][name] for r in range(2)]
        for rec in recs:
            assert rec["calls"] == [act] * (2 * cfg.n_layers)
            err = float(np.abs(rec["logits"] - want).max())
            assert err <= 1e-5 * float(np.abs(want).max()), name
        assert np.array_equal(recs[0]["logits"], recs[1]["logits"])


def test_collectives_outside_a_context_and_the_int8_wire():
    """Outside a ``tp_context`` both operators are the identity, with or
    without grad; inside one, training refuses the int8 wire before any
    collective, and ``tp_copy`` of a tensor autograd does not record
    returns it as is."""
    x = torch.randn(3, 4, requires_grad=True)
    assert tp_all_reduce(x) is x and tp_copy(x) is x
    y = torch.randn(3, 4)
    with tp_context(None, 8):
        assert tp_copy(y) is y
        with pytest.raises(ValueError, match="wire 32"):
            tp_all_reduce(x * 2)


def test_checkpoint_resumes_on_one_device_and_in_the_reference(runs):
    """The (2, 2) FSDP loop's checkpoint after 2 steps (full arrays,
    written by rank 0): resumed on a (1, 1) mesh it runs step 3 as the
    uninterrupted one-device run does (every leaf within 1e-5 of its
    max); the reference's ``restore`` reads it bit for bit."""
    arch = "tinymistral_248m"
    cfg = TC.get_smoke(arch)
    b, t = ranks.SHAPES[arch]
    ckpt = runs["ckpt"]
    assert runs["got"][(4, 0)]["ckpt_step"] == ranks.CKPT_STEPS
    assert latest_step(ckpt) == ranks.CKPT_STEPS

    def loop(mesh, directory, steps):
        built = build_train_step(cfg, mesh=mesh, microbatches=1,
                                 bf16_compute=False, device="cpu")
        params = params_from_numpy(runs["inputs"][arch][0], device="cpu")
        return TrainLoop(
            built.fn, params, built.meta["optimizer"].init(params),
            SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t,
                                   global_batch=b)),
            TrainLoopConfig(total_steps=steps, log_every=1,
                            checkpoint_dir=directory),
            dp=built.meta.get("dp"))
    resumed = loop(make_mesh((1, 1), ("data", "model")), ckpt,
                   ranks.STEPS)
    assert resumed.maybe_restore() and resumed.step == ranks.CKPT_STEPS
    resumed.run()
    whole = loop(None, None, ranks.STEPS)
    whole.run()
    for (path, p), w in zip(
            tree_flatten_with_path((resumed.params, resumed.opt_state)),
            tree_leaves((whole.params, whole.opt_state))):
        w = w.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(p.numpy() - w).max()) <= PARAM_TOL * scale, path
    # the reference restores the (2, 2) directory bit for bit
    raw = jax.tree_util.tree_map(
        lambda x: jnp.zeros(np.shape(x), jnp.float32),
        runs["inputs"][arch][0])
    template = (raw, JAdamWState(jnp.zeros((), jnp.int32), raw, raw))
    out, extras = jck.restore(ckpt, template, step=ranks.CKPT_STEPS)
    assert extras["step"] == ranks.CKPT_STEPS
    mine, _ = restore(ckpt, (lm.init_params(cfg, None, device="meta"),
                             AdamWState(torch.zeros((), dtype=torch.int32,
                                                    device="meta"),
                                        lm.init_params(cfg, None,
                                                       device="meta"),
                                        lm.init_params(cfg, None,
                                                       device="meta"))),
                      step=ranks.CKPT_STEPS, device="cpu")
    for got, want in zip(jax.tree_util.tree_leaves(out), tree_leaves(mine)):
        assert np.array_equal(np.asarray(got), want.numpy())


def test_launcher_mesh_1x2_equals_one_device(runs):
    """``launch/train.py --mesh 1x2 --smoke --device cpu`` spawns two
    ranks, prints the mesh, and its checkpoint after 2 steps equals the
    one-device launcher's within 1e-5 of each leaf's max."""
    assert_launch_equals_one_device(runs, "tinymistral_248m")


def test_launcher_mesh_1x2_trains_moe_as_one_device(runs):
    """The same for granite, a MoE decoder: ``--arch granite_moe_1b_a400m
    --smoke --mesh 1x2`` equals one device."""
    assert_launch_equals_one_device(runs, "granite_moe_1b_a400m")


@pytest.mark.parametrize("arch", ["hymba_1_5b", "xlstm_350m",
                                  "whisper_large_v3"])
def test_model_axis_refuses_the_families_still_to_port(arch):
    """A model axis of 2 over hymba, xlstm or whisper raises
    ``NotImplementedError`` naming ROADMAP's item, in ``build_train_step``
    and in the launcher before any rank starts; so does a config with
    MLP biases.  The three configs this file trains tensor-parallel pass
    the training predicate, while tensor-parallel serving refuses them,
    as the reference's ``tp_supported`` does."""
    mesh = Mesh(axis_names=("data", "model"), shape=(1, 2),
                ranks=np.arange(2).reshape(1, 2), groups={}, rank=0)
    with pytest.raises(NotImplementedError, match=r"ROADMAP.*5d \(ii\)"):
        build_train_step(TC.get_smoke(arch), mesh=mesh, microbatches=1,
                         bf16_compute=False, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrain.main(launch_args(arch) + ["--mesh", "1x2"])
    biased = dataclasses.replace(TC.get_smoke("starcoder2_7b"),
                                 mlp_bias=True)
    assert "5d (ii)" in tp_train_supported(biased, 2)
    for name in ("starcoder2_7b", "granite_moe_1b_a400m", "mixtral_8x7b"):
        for cfg in (TC.get_smoke(name), TC.get_config(name)):
            assert tp_train_supported(cfg, 2) is None, name
            assert tp_supported(cfg, 2) is not None, name
    assert "expert_ffn=64 not divisible by tp=3" in tp_train_supported(
        dataclasses.replace(TC.get_smoke("granite_moe_1b_a400m"),
                            n_heads=6, n_kv=3, d_ff=66), 3)


def test_build_train_step_takes_the_reference_signature():
    """A call written for the reference's signature, shape third,
    builds that shape's step: ``build_train_step(cfg, None, "train_4k")``
    takes ``auto_microbatches``' count (full tinymistral: 16 on one
    device, 1 at smoke size), bf16 compute, and the cell's meta-device
    arguments; ``device`` and ``local_batch`` stay keywords; a batch
    whose rows do not split into the microbatches is refused."""
    from repro_torch.launch.steps import auto_microbatches
    full = TC.get_config("tinymistral_248m")
    built = build_train_step(full, None, "train_4k", device="cpu")
    assert built.meta["kind"] == "train"
    assert built.meta["microbatches"] == 16 == auto_microbatches(
        full, None, "train_4k")
    params, opt_state, batch = built.args
    assert batch["tokens"].shape == (256, 4097)
    assert batch["tokens"].dtype == torch.int32
    assert params["embed"].is_meta and opt_state.mu["embed"].is_meta
    assert opt_state.step.dtype == torch.int32
    with pytest.raises(TypeError):
        build_train_step(full, None, "train_4k", None, None, True, 3e-4,
                         "full", "cpu")
    cfg = TC.get_smoke("tinymistral_248m")
    built = build_train_step(cfg, None, "train_4k", None, 2, False,
                             device="cpu")
    assert set(built.meta) == {"optimizer", "init", "kind", "microbatches"}
    assert build_train_step(cfg, None, "train_4k", device="cpu").meta[
        "microbatches"] == 1
    params = built.meta["init"](cfg, torch.Generator().manual_seed(0),
                                device="cpu")
    tokens = torch.zeros((3, 17), dtype=torch.int32)
    with pytest.raises(ValueError, match="3 rows .* 2 microbatches"):
        built.fn(params, built.meta["optimizer"].init(params),
                 {"tokens": tokens})


def assert_launch_equals_one_device(runs, arch):
    mesh_dir, one_dir, out = runs["launch"][arch]
    assert "mesh {'data': 1, 'model': 2} on 2 ranks (gloo" in out
    assert latest_step(mesh_dir) == latest_step(one_dir) == 2
    cfg = TC.get_smoke(arch)
    raw = lm.init_params(cfg, None, device="meta")
    template = (raw, AdamWState(torch.zeros((), dtype=torch.int32,
                                            device="meta"), raw, raw))
    got, extras = restore(mesh_dir, template, device="cpu")
    want, _ = restore(one_dir, template, device="cpu")
    assert extras["step"] == 2
    for (path, p), w in zip(tree_flatten_with_path(got), tree_leaves(want)):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((p - w).abs().max()) <= PARAM_TOL * scale, path
