"""The rank side of ``tests/test_torch_tp_train.py``: gloo ranks on the
CPU (``repro_torch.launch.mesh.run_ranks``), one group each of two, four
and eight, run every multi-process case of that file once (the train
steps, and the collectives of tinymistral's loss, of a MoE layer and of
a starcoder2 attention), and each rank writes its results to
``<out>/w<world>_rank<r>.pkl``.

    python tests/_torch_tp_train_ranks.py <out dir> <inputs.pkl>

``inputs.pkl`` holds, per config, the reference's smoke weights as a
numpy tree and the global batches of the train steps.  The file imports
only the port: the test process holds the results against the JAX
reference.
"""
from __future__ import annotations

import os
import pickle
import sys

# (config, mesh (data, model), FSDP) of the train steps; None: make_plan's
# default (FSDP when the data axis is larger than 1)
CASES = [("tinymistral_248m", (1, 2), None), ("tinymistral_248m", (1, 2), True),
         ("tinymistral_248m", (2, 2), True),
         ("tinymistral_248m", (2, 2), False),
         ("llama3_2_1b", (4, 2), None), ("qwen3_0_6b", (1, 2), None),
         ("starcoder2_7b", (1, 2), None),
         ("granite_moe_1b_a400m", (1, 2), None),
         ("granite_moe_1b_a400m", (2, 2), True),
         ("mixtral_8x7b", (1, 2), None)]
# global batch (rows, tokens per row) of each config (qwen3: qk-norm
# scales applied to each rank's heads; starcoder2: attention biases
# sharded with their heads; granite: two data ranks of one 512-token MoE
# dispatch group each; mixtral: T past its 64-token window)
SHAPES = {"tinymistral_248m": (8, 16), "llama3_2_1b": (8, 64),
          "qwen3_0_6b": (8, 16), "starcoder2_7b": (8, 16),
          "granite_moe_1b_a400m": (8, 128), "mixtral_8x7b": (4, 96)}
# (config, layer, rows, tokens) of the one-layer collectives checks: a
# MoE layer in both modes and a starcoder2 attention with its biases
LAYERS = [("granite_moe_1b_a400m", "moe", 4, 32),
          ("starcoder2_7b", "attn", 4, 16)]
STEPS = 3
CKPT_STEPS = 2             # the (2, 2) loop's steps to its checkpoint


def train_cases(torch, mesh, inputs):
    """Each case on this mesh: ``STEPS`` steps from the numpy weights on
    the global batches; the metrics, this rank's local shapes and leaves,
    and the parameters after the last step (gathered)."""
    import repro_torch.configs as C
    from repro_torch.convert import params_from_numpy, params_to_numpy
    from repro_torch.launch.steps import build_train_step
    from repro_torch.tree import tree_leaves
    out = {}
    for arch, shape, fsdp in CASES:
        if shape != mesh.shape:
            continue
        tree, batches = inputs[arch]
        built = build_train_step(C.get_smoke(arch), mesh=mesh, fsdp=fsdp,
                                 microbatches=1, bf16_compute=False,
                                 device="cpu")
        dp = built.meta["dp"]
        params = dp.shard(params_from_numpy(tree, device="cpu"))
        opt_state = built.meta["optimizer"].init(params)
        metrics = []
        for batch in batches:
            params, opt_state, m = built.fn(params, opt_state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        plan = built.meta["plan"]
        out[(arch, shape, fsdp)] = dict(
            metrics=metrics,
            local_shapes=[tuple(x.shape) for x in tree_leaves(params)],
            moment_shapes=[tuple(x.shape) for x in
                           tree_leaves(opt_state.mu)],
            local=[x.numpy() for x in tree_leaves(params)],
            params=params_to_numpy(dp.gather(params)),
            plan=(plan.dp_axes, plan.tp_axis, plan.fsdp))
    return out


def checkpointed(torch, mesh, inputs, ckpt):
    """The (2, 2) FSDP loop from the numpy weights: ``CKPT_STEPS`` steps
    of tinymistral on ``SyntheticLM``, its checkpoint written by rank 0."""
    import repro_torch.configs as C
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training.loop import TrainLoop, TrainLoopConfig
    arch = "tinymistral_248m"
    cfg = C.get_smoke(arch)
    b, t = SHAPES[arch]
    built = build_train_step(cfg, mesh=mesh, microbatches=1,
                             bf16_compute=False, device="cpu")
    dp = built.meta["dp"]
    params = dp.shard(params_from_numpy(inputs[arch][0], device="cpu"))
    loop = TrainLoop(built.fn, params, built.meta["optimizer"].init(params),
                     SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=t,
                                            global_batch=b)),
                     TrainLoopConfig(total_steps=CKPT_STEPS, log_every=1,
                                     checkpoint_every=CKPT_STEPS,
                                     checkpoint_dir=ckpt), dp=dp)
    return loop.run()["final_step"]


class Counted:
    """Within the block, every ``torch.distributed.all_reduce`` of this
    process is recorded: [(elements, dtype name)]."""

    def __init__(self):
        import torch.distributed as dist
        self.dist, self.calls = dist, []

    def __enter__(self):
        self.orig = self.dist.all_reduce

        def counted(t, *args, **kw):
            self.calls.append((t.numel(), str(t.dtype)))
            return self.orig(t, *args, **kw)
        self.dist.all_reduce = counted
        return self

    def __exit__(self, *exc):
        self.dist.all_reduce = self.orig
        return False


def collectives(torch, rank, inputs):
    """At (1, 2), this rank's shard of tinymistral's weights (the block
    matrices sliced as tensor-parallel serving slices them, the rest
    whole): one forward and backward of the loss under ``tp_context``
    (its gradients and its all-reduces, with remat off and on), and the
    forward pass under ``no_grad`` and with grad on over plain tensors,
    as serving runs it (logits and all-reduces)."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import tp_context
    from repro_torch.models import lm
    from repro_torch.serving.distributed import local_config, slice_params
    from repro_torch.tree import (tree_flatten_with_path, tree_leaves,
                                  tree_unflatten)
    arch = "tinymistral_248m"
    tree, batches = inputs[arch]
    cfg = C.get_smoke(arch)
    local = slice_params(params_from_numpy(tree, device="cpu"), rank, 2)
    batch = {k: torch.from_numpy(v) for k, v in batches[0].items()}
    out = {}
    for remat in (False, True):
        lcfg = dataclasses.replace(local_config(cfg, 2), remat=remat)
        ps = [p.detach().requires_grad_() for p in tree_leaves(local)]
        fp = tree_unflatten(local, ps)
        with tp_context(None, 32), Counted() as c:
            loss, _ = lm.loss_fn(fp, batch, lcfg, device="cpu")
            gs = torch.autograd.grad(loss, ps)
        out[f"grad_remat{int(remat)}"] = dict(
            loss=float(loss), calls=c.calls,
            grads={path: g.numpy() for (path, _), g in
                   zip(tree_flatten_with_path(local), gs)})
    lcfg = local_config(cfg, 2)
    tokens = batch["tokens"][:, :-1]
    for name, grad in (("no_grad", False), ("plain", True)):
        with torch.set_grad_enabled(grad), tp_context(None, 32), \
                Counted() as c:
            logits, _ = lm.forward(local, tokens, lcfg, device="cpu")
        out[name] = dict(logits=logits.numpy(), calls=c.calls)
    return out


def layer_inputs(torch, arch, b, t):
    """A layer's input [b, t, D] and the weights of the scalar loss taken
    of its output, from a numpy seed."""
    import numpy as np
    import repro_torch.configs as C
    rng = np.random.default_rng(7)
    d = C.get_smoke(arch).d_model
    return (torch.from_numpy(rng.standard_normal((b, t, d), np.float32)),
            torch.from_numpy(rng.standard_normal((b, t, d), np.float32)))


def layer_loss(torch, layer, p, x, w, cfg, remat, mode="dispatch"):
    """One layer (layer 0's weights ``p``, under ``models.remat`` when
    ``remat``) on ``x``: sum(out * w), plus the MoE load-balancing term."""
    from repro_torch.models import layers, moe
    from repro_torch.models.remat import remat as run

    def body(p, x):
        if layer == "moe":
            out, aux = moe.apply_moe(p, x, cfg, mode=mode)
            return torch.sum(out * w) + aux
        positions = torch.arange(x.shape[1]).expand(x.shape[0], -1)
        return torch.sum(layers.apply_attention(
            p, x, cfg, positions=positions, window=cfg.window) * w)
    return run(body, p, x, on=remat)


def layer_params(tree, layer):
    """Layer 0's weights of ``layer`` (``"moe"`` or ``"attn"``)."""
    return {k: v[0] for k, v in tree["blocks"][layer].items()}


def layer_collectives(torch, rank, inputs):
    """At (1, 2), each LAYERS entry with this rank's shard of layer 0's
    weights (the experts' F slice, the attention's heads and their
    ``bq`` / ``bk`` / ``bv``; the router and ``bo`` whole), as the
    training step holds them: one forward and backward under
    ``tp_context``, remat off and on (a MoE layer also in dense mode);
    the loss, every gradient and the all-reduces."""
    import dataclasses
    import repro_torch.configs as C
    from repro_torch.convert import params_from_numpy
    from repro_torch.dist.sharding import tp_context
    from repro_torch.launch.steps import train_local_config, train_model_dim
    out = {}
    for arch, layer, b, t in LAYERS:
        full = layer_params(params_from_numpy(inputs[arch][0], device="cpu"),
                            layer)
        local = {}
        for k, v in full.items():
            dim = train_model_dim(f"['{k}']", v.shape)
            local[k] = v if dim is None else v.chunk(2, dim)[rank].clone()
        x0, w = layer_inputs(torch, arch, b, t)
        modes = ("dispatch", "dense") if layer == "moe" else ("dispatch",)
        for mode in modes:
            for remat in (False, True):
                cfg = dataclasses.replace(
                    train_local_config(C.get_smoke(arch), 2), remat=remat)
                p = {k: v.detach().requires_grad_() for k, v in
                     local.items()}
                x = x0.clone().requires_grad_()
                with tp_context(None, 32), Counted() as c:
                    loss = layer_loss(torch, layer, p, x, w, cfg, remat,
                                      mode)
                    gs = torch.autograd.grad(loss, list(p.values()) + [x])
                out[(arch, mode, remat)] = dict(
                    loss=float(loss), calls=c.calls,
                    grads={k: g.numpy() for k, g in zip(list(p) + ["x"],
                                                        gs)})
    return out


def rank_main(rank, world, out_dir, inputs_path):
    import torch
    from repro_torch.launch.mesh import make_mesh
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    shape = {2: (1, 2), 4: (2, 2), 8: (4, 2)}[world]
    mesh = make_mesh(shape, ("data", "model"))
    res = {"coords": (mesh.coord("data"), mesh.coord("model")),
           "train": train_cases(torch, mesh, inputs)}
    if world == 2:
        res["collectives"] = collectives(torch, rank, inputs)
        res["layers"] = layer_collectives(torch, rank, inputs)
    if world == 4:
        res["ckpt_step"] = checkpointed(torch, mesh, inputs,
                                        os.path.join(out_dir, "ckpt22"))
    with open(os.path.join(out_dir, f"w{world}_rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def main(out_dir, inputs_path):
    from repro_torch.launch.mesh import run_ranks
    for world in (2, 4, 8):
        run_ranks(rank_main, world, args=(world, out_dir, inputs_path),
                  rendezvous_dir=out_dir)


if __name__ == "__main__":
    main(*sys.argv[1:3])
