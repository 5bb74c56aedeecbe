"""The port's data-parallel train step against the JAX reference's
``build_train_step`` on a mesh of as many devices: tinymistral and granite
(its MoE load-balancing term over the whole batch, its dispatch groups
whole on every rank) at dp 2 with FSDP on and off, at dp 4, and at dp 2 x
microbatches 2, three steps each.  The ranks run once, in gloo groups of
two and four on the CPU (``tests/_torch_dp_ranks.py train``), beside two
reference processes (one per config) with eight JAX host devices."""
import textwrap

import jax
import numpy as np
import pytest
import torch

import _torch_dp_ranks as ranks
from _torch_dp_runs import run_both
from repro_torch.tree import tree_flatten_with_path

RTOL = 1e-5                # loss, nll and grad norm, relative
PARAM_TOL = 1e-5           # parameters after the steps, of each leaf's max
# the update (after - init) against the reference's: an element agrees
# within UPDATE_TOL of its leaf's largest update plus one f32 ulp of the
# parameter per step (each step rounds p + u once in either run; at a
# norm's 1.0 an ulp is ~1% of three warm-up updates).  At most
# UPDATE_OUTLIERS of a leaf's elements may not: Adam's early steps are
# ~lr * sign(m), so where a gradient lies within rounding of 0 the two
# runs step apart (granite's w_gate has one such element of 32768).  A
# leaf left at its init misses it in >99% of its elements.
UPDATE_TOL = 1e-3
UPDATE_OUTLIERS = 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's smoke-sized CPU ops are tiny: one intra-op thread runs
    them fastest, and keeps them off the other test workers' cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# the reference's train steps of one config, each on a mesh of ``world``
# host devices
REFERENCE = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp
    import repro.configs as C
    from repro.launch.mesh import make_mesh
    from repro.launch.steps import build_train_step

    inputs = pickle.load(open(sys.argv[1], "rb"))
    out = {}
    for arch, world, fsdp, mb in %(cases)r:
        cfg = C.get_smoke(arch)
        tree, batches, _ = inputs[arch]
        mesh = make_mesh((world, 1), ("data", "model"))
        built = build_train_step(cfg, mesh, fsdp=fsdp, microbatches=mb,
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
        out[(arch, world, fsdp, mb)] = dict(
            metrics=metrics, params=jax.device_get(params))
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's results by case, {(world, rank): the port's})."""
    codes = [REFERENCE % dict(cases=[c for c in ranks.CASES if c[0] == arch])
             for arch in ranks.SHAPES]
    inputs, want, got = run_both(tmp_path_factory.mktemp("dp_train"),
                                 "train", codes)
    return inputs, {k: v for w in want for k, v in w.items()}, got


@pytest.mark.parametrize("case", ranks.CASES,
                         ids=[f"{a.split('_')[0]}-dp{w}-"
                              f"{'fsdp' if f else 'replicated'}-mb{m}"
                              for a, w, f, m in ranks.CASES])
def test_train_step_matches_reference_mesh(case, runs):
    """Three steps: loss, nll and grad norm within 1e-5 relative of the
    reference's step on a mesh of as many devices, the step counter equal,
    every rank alike; the parameters after them within 1e-5 of each
    leaf's max, and their updates (after - init) the reference's in all
    but UPDATE_OUTLIERS of each leaf's elements; under FSDP each rank
    holds 1/D of every sharded leaf."""
    inputs, want, got = runs
    arch, world, fsdp, mb = case
    ref = want[case]
    for r in range(world):
        rec = got[(world, r)]["train"][case]
        assert rec["plan"] == (("data",), None, fsdp)
        for m, w in zip(rec["metrics"], ref["metrics"]):
            assert m["step"] == w["step"]
            for key in ("loss", "nll", "grad_norm"):
                assert abs(m[key] - w[key]) <= RTOL * abs(w[key]), (r, key)
        assert rec["metrics"] == got[(world, 0)]["train"][case]["metrics"]
    full = [np.prod(x.shape) for x in
            jax.tree_util.tree_leaves(ref["params"])]
    local = [np.prod(s) for s in got[(world, 0)]["train"][case][
        "local_shapes"]]
    if fsdp:
        assert sum(local) < 0.6 * sum(full)
    else:
        assert local == full
    flat = tree_flatten_with_path(got[(world, 0)]["train"][case]["params"])
    init = jax.tree_util.tree_leaves(inputs[arch][0])
    for (path, p), w, p0 in zip(
            flat, jax.tree_util.tree_leaves(ref["params"]), init):
        w = np.asarray(w)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(p - w).max()) <= PARAM_TOL * scale, path
        tol = (UPDATE_TOL * float(np.abs(w - p0).max())
               + ranks.STEPS * np.spacing(np.abs(w)))
        assert (np.abs(p - w) > tol).mean() <= UPDATE_OUTLIERS, path
        assert (np.abs(p0 - w) > tol).mean() > 0.99, path
