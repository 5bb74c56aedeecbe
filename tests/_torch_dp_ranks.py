"""The rank side of ``tests/test_torch_dp.py`` and
``tests/test_torch_dp_train.py``: gloo ranks on the CPU
(``repro_torch.launch.mesh.run_ranks``), one group of two and one of
four, run every multi-process case of one of those files once and each
rank writes its results to ``<out>/w<world>_rank<r>.pkl``.

    python tests/_torch_dp_ranks.py <out dir> <inputs.pkl> train|other

``train``: the data-parallel train steps; ``other``: the masked loss,
the compressed all-reduce and a (2, 2) mesh's groups.

``inputs.pkl`` holds, per config, the reference's smoke weights as a
numpy tree, the global batches of the train steps and a masked batch.
The file imports only the port: the test process holds the results
against the JAX reference.
"""
from __future__ import annotations

import os
import pickle
import sys

# (config, data-parallel ranks, FSDP, microbatches) of the train steps
CASES = [(arch, world, fsdp, mb)
         for arch in ("tinymistral_248m", "granite_moe_1b_a400m")
         for world, fsdp, mb in ((2, True, 1), (2, False, 1), (4, True, 1),
                                 (2, True, 2))]
# global batch (rows, tokens per row) of each config: granite's dispatch
# groups of 512 tokens stay whole on every rank at dp 2 and 4, and per
# microbatch at dp 2 x microbatches 2
SHAPES = {"tinymistral_248m": (8, 16), "granite_moe_1b_a400m": (8, 256)}
MASKED = {"tinymistral_248m": (4, 16), "granite_moe_1b_a400m": (4, 256)}
STEPS = 3
COMPRESS_ROWS = 2          # rows of each rank's gradient leaves


def train_cases(torch, mesh, world, inputs):
    """Each case of ``world`` ranks: ``STEPS`` steps of the data-parallel
    step from the numpy weights on the global batches; the metrics, and
    the parameters after the last step (gathered)."""
    import repro_torch.configs as C
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.steps import build_train_step
    from repro_torch.tree import tree_leaves
    out = {}
    for arch, w, fsdp, mb in CASES:
        if w != world:
            continue
        tree, batches, _ = inputs[arch]
        built = build_train_step(C.get_smoke(arch), mesh=mesh, fsdp=fsdp,
                                 microbatches=mb, bf16_compute=False,
                                 device="cpu")
        dp = built.meta["dp"]
        params = dp.shard(params_from_numpy(tree, device="cpu"))
        opt_state = built.meta["optimizer"].init(params)
        shapes = [tuple(x.shape) for x in tree_leaves(params)]
        metrics = []
        for batch in batches:
            params, opt_state, m = built.fn(params, opt_state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        out[(arch, w, fsdp, mb)] = dict(
            metrics=metrics, local_shapes=shapes,
            params=params_to_numpy(dp.gather(params)),
            plan=(built.meta["plan"].dp_axes, built.meta["plan"].tp_axis,
                  built.meta["plan"].fsdp))
    return out


def masked_losses(torch, mesh, inputs):
    """The loss and nll of a masked batch whose mask differs across the
    ranks, each rank's share summed over the group."""
    import torch.distributed as dist
    import repro_torch.configs as C
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import dp_context
    from repro_torch.launch.steps import build_train_step
    from repro_torch.models import lm
    out = {}
    for arch, (tree, _, masked) in inputs.items():
        cfg = C.get_smoke(arch)
        dp = build_train_step(cfg, mesh=mesh, microbatches=1,
                              bf16_compute=False, device="cpu").meta["dp"]
        local = dp.rows({k: torch.from_numpy(v) for k, v in masked.items()})
        params = params_from_numpy(tree, device="cpu")
        with dp_context(dp.group):
            loss, m = lm.loss_fn(params, local, cfg, device="cpu")
        both = torch.stack([loss.detach(), m["nll"].detach()])
        dist.all_reduce(both)
        out[arch] = [float(x) for x in both]
    return out


def compressed(torch, rank, inputs):
    """Two rounds of the compressed all-reduce with error feedback on this
    rank's rows of ``inputs["compress"]`` (two gradient trees)."""
    from repro_torch.dist.compress import (_quantize, init_error_state,
                                           make_compressed_allreduce)
    fn = make_compressed_allreduce()
    rows = slice(rank * COMPRESS_ROWS, (rank + 1) * COMPRESS_ROWS)
    rounds = []
    err = None
    for grads in inputs["compress"]:
        g = {k: torch.from_numpy(v[rows]) for k, v in grads.items()}
        err = init_error_state(g) if err is None else err
        x = {k: g[k] + err[k] for k in g}
        codes = {k: _quantize(v) for k, v in x.items()}
        mean, err = fn(g, err)
        rounds.append(dict(
            x={k: v.numpy() for k, v in x.items()},
            codes={k: c.numpy() for k, (c, _) in codes.items()},
            scale={k: float(s) for k, (_, s) in codes.items()},
            mean={k: v.numpy() for k, v in mean.items()},
            err={k: v.numpy() for k, v in err.items()}))
    return rounds


def mesh_groups(torch, world):
    """A (2, 2) mesh over four ranks: each axis's group sums the ranks of
    this rank's line along it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import describe, make_mesh
    mesh = make_mesh((2, world // 2), ("data", "model"))
    out = {"describe": describe(mesh)}
    for axis in mesh.axis_names:
        t = torch.tensor([float(mesh.rank)])
        dist.all_reduce(t, group=mesh.groups[axis])
        out[axis] = (mesh.coord(axis), float(t))
    return out


def rank_main(rank, world, out_dir, inputs_path, part):
    import torch
    from repro_torch.launch.mesh import make_mesh
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    mesh = make_mesh((world, 1), ("data", "model"))
    models = {k: v for k, v in inputs.items() if k != "compress"}
    if part == "train":
        res = {"train": train_cases(torch, mesh, world, models)}
    elif world == 2:
        res = {"masked": masked_losses(torch, mesh, models)}
    else:
        res = {"compress": compressed(torch, rank, inputs),
               "mesh": mesh_groups(torch, world)}
    with open(os.path.join(out_dir, f"w{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def main(out_dir, inputs_path, part):
    from repro_torch.launch.mesh import run_ranks
    for world in (2, 4):
        run_ranks(rank_main, world, args=(world, out_dir, inputs_path, part),
                  rendezvous_dir=out_dir)


if __name__ == "__main__":
    main(*sys.argv[1:4])
