"""The train step (port of the train part of ``repro.launch.steps``), on
one device or data-parallel over a mesh.

``build_train_step`` returns ``fn(params, opt_state, batch) -> (params,
opt_state, metrics)``: the loss and its gradients (averaged over
``microbatches``), AdamW under the reference's schedule
(``cosine_schedule(peak_lr, 100, 10000)``), and metrics ``loss``,
``nll``, ``grad_norm`` and ``step``.

The master parameters are plain f32 tensors that do not require grad.
Inside the step the loss is taken over detached copies that do
(``bf16_compute``: leaves of two or more dimensions cast to bf16 once,
outside the microbatch loop), ``torch.autograd.grad`` gives their
gradients, which go back to f32, and the step returns new plain tensors.
So a trained tree goes straight into ``sail_linear.quantize_params`` and
the ``Engine``, where a tree that required grad would record autograd
graphs through the KV pool's in-place writes.

**Data parallelism** (``mesh``, a ``launch.mesh.Mesh`` of shape (D, 1)
over ``("data", "model")``): the step computes the reference's step over
the global batch, which the reference's ``jit`` runs as one program.
Each rank takes its rows (``DataParallel.rows``) and runs the model under
``dist.sharding.dp_context``, where the loss's denominators are the whole
batch's: its loss is its share of the global batch's loss, a ``mask``
that differs across ranks and the MoE load-balancing term included, and
the shares' gradients sum to the global gradient.  One all-reduce per
step sums them (every gradient leaf and the loss in one flat buffer).
Under FSDP (``make_plan``'s default for D > 1) each rank keeps only its
slice of every parameter and AdamW moment (the data entry of
``param_spec``, trimmed) and gathers the full tree for the forward pass;
the gathered gradient's norm clips every rank's slice alike.  gloo on
CUDA tensors offers ``all_reduce`` and ``broadcast`` only, so the gather
is an all-reduce of zero-filled buffers: exact, since each element has
one nonzero term.  A model axis larger than 1 (tensor-parallel training)
is refused.

The serving steps (``build_prefill_step``, ``build_serve_step``) and
``auto_microbatches`` are built on the reference's mesh and shape specs;
they wait for the port's dry-run tools (ROADMAP, Queue 1 item 6c).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (dp_context, make_plan,
                                       param_shardings)
from repro_torch.models import encdec, lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import MOE_GROUP_TOKENS
from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_schedule,
                                     global_norm)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class BuiltStep:
    fn: Any
    meta: Dict[str, Any]


def _cast_bf16(params):
    return tree_map(
        lambda p: p.to(torch.bfloat16)
        if (p.dtype == torch.float32 and p.ndim >= 2) else p, params)


def _dispatch_group(tokens: int) -> int:
    """``moe.apply_moe_dispatch``'s group size at ``tokens`` tokens."""
    tg = min(MOE_GROUP_TOKENS, tokens)
    return tokens if tokens % tg else tg


class DataParallel:
    """One rank's view of data parallelism over ``mesh``'s data axis:
    its rows of a batch, its slices of the FSDP-sharded trees, and the
    collectives of the step and the loop over the axis's group."""

    def __init__(self, mesh, cfg: ModelConfig, plan, init, device):
        if len(plan.dp_axes) != 1:
            raise ValueError(f"one data axis expected, got {plan.dp_axes}")
        axis = plan.dp_axes[0]
        self.mesh, self.cfg, self.plan = mesh, cfg, plan
        self.group = mesh.groups.get(axis)
        self.size, self.index = mesh.axis_size(axis), mesh.coord(axis)
        self.device = device
        # the full tree's shapes, and where each leaf's data axis lies
        self.template = init(cfg, None, device="meta")
        specs = tree_leaves(param_shardings(mesh, self.template, cfg, plan))
        self.dims: List[Optional[int]] = [
            next((i for i, e in enumerate(s) if e == plan.dp), None)
            if plan.fsdp else None for s in specs]

    # --- rows ---------------------------------------------------------
    def rows(self, batch, microbatches: int = 1):
        """This rank's rows of a global batch: its 1/D of each of the
        ``microbatches`` consecutive row blocks (all its rows at 1)."""
        def one(v):
            b = v.shape[0]
            if b % (microbatches * self.size):
                raise ValueError(f"a batch of {b} rows does not split into "
                                 f"{microbatches} microbatches over "
                                 f"{self.size} data-parallel ranks")
            per = b // (microbatches * self.size)
            blocks = v.reshape((microbatches, b // microbatches)
                               + tuple(v.shape[1:]))
            mine = blocks[:, self.index * per:(self.index + 1) * per]
            return mine.reshape((microbatches * per,) + tuple(v.shape[1:]))
        return {k: one(v) for k, v in batch.items()}

    def check_dispatch(self, batch, microbatches: int) -> None:
        """Refuse a split whose MoE dispatch groups would straddle ranks:
        each rank's groups must be the global microbatch's groups."""
        if self.cfg.n_experts == 0 or self.size == 1:
            return
        t = batch["tokens"].shape[1] - 1
        if "prefix_embeds" in batch:
            t += batch["prefix_embeds"].shape[1]
        local = batch["tokens"].shape[0] // microbatches * t
        whole = local * self.size
        if _dispatch_group(local) != _dispatch_group(whole):
            raise ValueError(
                f"MoE dispatch groups of {_dispatch_group(whole)} tokens "
                f"would straddle data-parallel ranks of {local} tokens per "
                f"microbatch: give each rank a multiple of "
                f"{_dispatch_group(whole)} tokens")

    # --- FSDP slices --------------------------------------------------
    def _slice(self, x, dim):
        if dim is None:
            return x
        n = x.shape[dim] // self.size
        return x.narrow(dim, self.index * n, n).clone()

    def shard(self, tree):
        """This rank's slice of every leaf of a full parameter-shaped
        tree (identity without FSDP)."""
        if not self.plan.fsdp:
            return tree
        return tree_unflatten(tree, [self._slice(x, d) for x, d in
                                     zip(tree_leaves(tree), self.dims)])

    def gather(self, tree):
        """The full tree from every rank's slices (a collective; identity
        without FSDP)."""
        if not self.plan.fsdp or self.size == 1:
            return tree
        leaves = tree_leaves(tree)
        full = []
        for x, d in zip(leaves, self.dims):
            if d is None:
                full.append(x)
                continue
            shape = list(x.shape)
            shape[d] *= self.size
            buf = x.new_zeros(shape)
            n = x.shape[d]
            buf.narrow(d, self.index * n, n).copy_(x)
            full.append(buf)
        self.all_sum([t for t, d in zip(full, self.dims) if d is not None])
        return tree_unflatten(tree, full)

    def shard_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step, mu=self.shard(state.mu),
                          nu=self.shard(state.nu))

    def gather_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step, mu=self.gather(state.mu),
                          nu=self.gather(state.nu))

    # --- collectives --------------------------------------------------
    def context(self):
        """``dp_context`` over the data axis (none for one rank)."""
        if self.size == 1:
            return contextlib.nullcontext()
        return dp_context(self.group)

    def all_sum(self, tensors: List[torch.Tensor]) -> None:
        """Sum ``tensors`` over the data axis in place: one all-reduce of
        one flat buffer per dtype."""
        if self.size == 1 or not tensors:
            return
        for dtype in dict.fromkeys(t.dtype for t in tensors):
            group = [t for t in tensors if t.dtype == dtype]
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
            off = 0
            for t in group:
                t.copy_(flat[off:off + t.numel()].view(t.shape))
                off += t.numel()

    def all_max(self, values: List[float]) -> List[float]:
        """The data axis's maximum of each of ``values`` (host floats)."""
        if self.size == 1:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64)
        if dist.get_backend(self.group) != "gloo":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t.tolist()


def build_train_step(cfg: ModelConfig, mesh=None, fsdp: Optional[bool] = None,
                     microbatches: int = 1, bf16_compute: bool = False,
                     peak_lr: float = 3e-4, device="cuda",
                     local_batch: bool = False) -> BuiltStep:
    """The train step on ``device``; over ``mesh`` (None: one device) it is
    one rank's part of the data-parallel step, which takes the global
    batch and keeps its rows, or, with ``local_batch``, takes this rank's
    rows as given (each host's own stream, as ``--distributed`` reads
    it).  ``meta``: ``optimizer``, ``init``, and over a mesh ``plan`` and
    ``dp`` (the ``DataParallel`` that shards the trees and the loop's
    checkpoints)."""
    dev = resolve_device(device)
    opt = AdamW(learning_rate=cosine_schedule(peak_lr, 100, 10000))
    if cfg.family == "encdec":
        base_loss = lambda p, b: encdec.loss_fn(p, b, cfg, device=dev)
        init = encdec.init_params
    else:
        base_loss = lambda p, b: lm.loss_fn(p, b, cfg, device=dev)
        init = lm.init_params

    def loss_fn(params, batch):
        if bf16_compute and "prefix_embeds" in batch:
            batch = dict(batch, prefix_embeds=batch["prefix_embeds"].to(
                torch.bfloat16))
        return base_loss(params, batch)

    def grads_of(fp, batch):
        """(loss, nll, f32 gradients) of one (micro)batch."""
        with torch.enable_grad():
            leaves = tree_leaves(fp)
            loss, m = loss_fn(fp, batch)
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              if g is None else g.to(torch.float32)
              for p, g in zip(leaves, gs)]
        return loss.detach(), m["nll"].detach(), gs

    def loss_and_grads(params, batch):
        """(loss, nll, gradients) of ``params`` on ``batch``, averaged over
        the microbatches."""
        # the bf16 cast sits outside the microbatch loop; d(cast)/dp = 1,
        # so gradients with respect to the cast leaves are the masters'
        fp = _cast_bf16(params) if bf16_compute else params
        fp = tree_map(lambda p: p.detach().requires_grad_(), fp)
        if microbatches == 1:
            return grads_of(fp, batch)
        acc, ls, nlls = None, [], []
        for i in range(microbatches):
            mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                               + v.shape[1:])[i]
                  for k, v in batch.items()}
            loss_i, nll_i, gs = grads_of(fp, mb)
            acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
            ls.append(loss_i)
            nlls.append(nll_i)
        return (torch.stack(ls).mean(), torch.stack(nlls).mean(),
                [g / microbatches for g in acc])

    def finish(params, opt_state, grads, loss, nll, gnorm=None):
        updates, opt_state, gnorm = opt.update(grads, opt_state, params,
                                               gnorm=gnorm)
        params = opt.apply(params, updates)
        metrics = {"loss": loss.to(torch.float32),
                   "nll": nll.to(torch.float32),
                   "grad_norm": gnorm.to(torch.float32),
                   "step": opt_state.step}
        return params, opt_state, metrics

    def as_device(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def train_step(params, opt_state, batch):
        loss, nll, gs = loss_and_grads(params, as_device(batch))
        return finish(params, opt_state, tree_unflatten(params, gs), loss,
                      nll)

    meta: Dict[str, Any] = {"optimizer": opt, "init": init}
    if mesh is None:
        return BuiltStep(fn=train_step, meta=meta)

    if mesh.axis_size("model") > 1:
        raise NotImplementedError(
            "tensor-parallel training (a model axis larger than 1) is not "
            "ported: ROADMAP, Queue 1")
    plan = make_plan(mesh, cfg, fsdp)
    dp = DataParallel(mesh, cfg, plan, init, dev)

    def dp_train_step(params, opt_state, batch):
        batch = as_device(batch)
        if not local_batch:
            batch = dp.rows(batch, microbatches)
        dp.check_dispatch(batch, microbatches)
        full = dp.gather(params)
        with dp.context():
            loss, nll, gs = loss_and_grads(full, batch)
        loss, nll = loss.to(torch.float32), nll.to(torch.float32)
        dp.all_sum(gs + [loss, nll])
        grads = tree_unflatten(full, gs)
        return finish(params, opt_state, dp.shard(grads), loss, nll,
                      gnorm=global_norm(grads))

    meta.update(plan=plan, dp=dp)
    return BuiltStep(fn=dp_train_step, meta=meta)
