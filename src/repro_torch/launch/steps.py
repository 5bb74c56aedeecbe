"""The train step (port of the train part of ``repro.launch.steps``), on
one device or over a ``(data, model)`` mesh of ranks.

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

**Over a mesh** (``mesh``, a ``launch.mesh.Mesh`` over ``("data",
"model")``) the step computes the reference's step over the global
batch, which the reference's ``jit`` runs as one program on the mesh.
Each rank stores its ``param_spec`` slice of the masters and of both
AdamW moments, on both axes (``MeshRank.shard``).

*Data axis.*  Each rank takes the rows of its data coordinate
(``MeshRank.rows``) and runs the model under
``dist.sharding.dp_context``, where the loss's denominators are the whole
batch's: its loss is its share of the global batch's loss, a ``mask``
that differs across ranks and the MoE load-balancing term included, and
the shares' gradients sum to the global gradient.  One all-reduce over
the data axis per step sums them (every gradient leaf and the loss in one
flat buffer).  Under FSDP (``make_plan``'s default for D > 1) the step
gathers the data axis's slices for the forward pass and keeps its slice
of the summed gradient.  gloo on CUDA tensors offers ``all_reduce`` and
``broadcast`` only, so a gather is an all-reduce of zero-filled buffers:
exact, since each element has one nonzero term.

*Model axis* (M > 1, tensor parallelism, Megatron style; the configs
``tp_train_supported`` accepts: the dense and MoE decoders, attention
biases included, with heads, KV heads, ``d_ff`` and the experts' FFN
divisible by M).  The block matrices stay sharded, and so do the
attention's ``bq`` / ``bk`` / ``bv``, which add to this rank's heads:
the model runs ``train_local_config(cfg, M)`` over this rank's heads and
FFN slice inside ``tp_context`` (wire 32), whose differentiable
collectives make the gradient of every replicated activation whole.  A
MoE layer's experts split their FFN dim F on the model axis, as the
reference's ``param_spec`` places them; the reference's placement does
not read ``cfg.moe_shard``, so granite's ``"expert"`` splits F too.
Every other leaf the model axis shards (the embedding's and
``lm_head``'s vocabulary, the stacked norms' width, ``bo``, the MoE
router's experts) is gathered over the model axis, so the embedding, the
norms, the router, the logits and the loss run replicated, as in
tensor-parallel serving; their gradients come out whole and the same on
every model rank, which keeps its slice.  The global
gradient norm sums the model-sharded leaves' squares over the model axis
and adds the others' once.  The M ranks of a data coordinate see the
same rows, and the metrics are the same on every rank.

``build_train_step`` takes the reference's signature and defaults:
the ``train_4k`` shape, bf16 compute over f32 masters, and a microbatch
count from ``auto_microbatches`` (the reference's formula: the layers'
bf16 residual carries of a data rank's rows within 3e9 bytes); its
``args`` are the step's (params, opt_state, batch) as trees on the meta
device, the reference's ``BuiltStep.args``.  The serving step builders
(``build_prefill_step``, ``build_serve_step``, ``build_step``) are still
to port (ROADMAP, Queue 1 item 6c (ii)).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device
from repro_torch.dist.sharding import (_NAME_RE, dp_context, make_plan,
                                       param_shardings, tp_context)
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.specs import SHAPES, input_specs
from repro_torch.models import encdec, lm
from repro_torch.models.common import ModelConfig
from repro_torch.models.moe import MOE_GROUP_TOKENS
from repro_torch.optim.adamw import (AdamW, AdamWState, cosine_schedule,
                                     global_norm)
from repro_torch.serving.distributed import (local_config,
                                             serving_param_spec)
from repro_torch.tree import (tree_flatten_with_path, tree_leaves, tree_map,
                              tree_unflatten)


# the attention biases that add to this rank's heads under tensor
# parallelism (``bo`` adds after the sum and stays whole)
_HEAD_BIASES = ("bq", "bk", "bv")


def tp_train_supported(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why this config cannot train over a model axis of ``tp``, ``None``
    when it can: the dense and MoE decoders, attention biases included,
    with heads, KV heads, ``d_ff`` and the experts' FFN divisible by
    ``tp``.  Tensor-parallel serving keeps its own, narrower predicate
    (``serving.distributed.tp_supported``, the reference's)."""
    if tp <= 1:
        return None
    if cfg.family not in ("dense", "moe"):
        return (f"family={cfg.family!r} does not train tensor-parallel yet "
                "(ROADMAP, Queue 1 item 5d (ii))")
    if cfg.mlp_bias:
        return ("MLP biases do not train tensor-parallel yet (ROADMAP, "
                "Queue 1 item 5d (ii))")
    for name, n in (("n_heads", cfg.n_heads), ("n_kv", cfg.n_kv),
                    ("d_ff", cfg.d_ff)) + (
            (("expert_ffn", cfg.expert_ffn),) if cfg.family == "moe"
            else ()):
        if n % tp:
            return f"{name}={n} not divisible by tp={tp}"
    return None


def train_local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One training rank's view of ``cfg``: serving's ``local_config``
    (its heads and FFN slice) and its slice of the experts' FFN."""
    local = local_config(cfg, tp)
    if tp <= 1 or cfg.moe_ffn is None:
        return local
    return dataclasses.replace(local, moe_ffn=cfg.moe_ffn // tp)


def train_model_dim(path: str, shape) -> Optional[int]:
    """The dim of one parameter the model computes on as this rank's
    shard (None: the model needs it whole): serving's block matrices,
    the MoE experts among them, and the attention's head biases."""
    names = _NAME_RE.findall(path)
    if names and names[-1] in _HEAD_BIASES:
        return len(shape) - 1
    return _first(serving_param_spec(path, tuple(shape)), "model")


@dataclasses.dataclass
class BuiltStep:
    fn: Any
    args: tuple                # (params, opt_state, batch) on the meta device
    meta: Dict[str, Any]


def _cast_bf16(params):
    return tree_map(
        lambda p: p.to(torch.bfloat16)
        if (p.dtype == torch.float32 and p.ndim >= 2) else p, params)


def _dispatch_group(tokens: int) -> int:
    """``moe.apply_moe_dispatch``'s group size at ``tokens`` tokens."""
    tg = min(MOE_GROUP_TOKENS, tokens)
    return tokens if tokens % tg else tg


def _all_sum(tensors: List[torch.Tensor], group) -> None:
    """Sum ``tensors`` over ``group`` in place: one all-reduce of one flat
    buffer per dtype."""
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view(t.shape))
            off += t.numel()


def _narrow(x, dim, index: int, size: int):
    """Slice ``index`` of ``size`` along ``dim`` (``x`` itself at None)."""
    if dim is None:
        return x
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n).clone()


def _first(spec, axis) -> Optional[int]:
    return next((i for i, e in enumerate(spec) if e == axis), None) \
        if axis is not None else None


class MeshRank:
    """One rank's view of a training mesh: data parallelism over its data
    axis (its rows of a batch, its FSDP slices, the gradient sum) and
    tensor parallelism over its model axis (its shards of the trees, the
    gathers the forward pass needs, the gradient norm); the loop's
    checkpoints gather and shard through it."""

    def __init__(self, mesh, cfg: ModelConfig, plan, init, device):
        if len(plan.dp_axes) != 1:
            raise ValueError(f"one data axis expected, got {plan.dp_axes}")
        axis = plan.dp_axes[0]
        self.mesh, self.cfg, self.plan = mesh, cfg, plan
        self.group = mesh.groups.get(axis)
        self.size, self.index = mesh.axis_size(axis), mesh.coord(axis)
        tp = plan.tp_axis
        self.tp_group = mesh.groups.get(tp) if tp else None
        self.tp_size = mesh.axis_size(tp) if tp else 1
        self.tp_index = mesh.coord(tp) if tp else 0
        self.device = device
        # the full tree's shapes; per leaf, the dim its data-axis slice
        # (FSDP) and its model-axis shard lie on, and whether the model
        # computes on the shard (a block matrix, a head bias) or on the
        # whole leaf
        self.template = init(cfg, None, device="meta")
        flat = tree_flatten_with_path(self.template)
        specs = tree_leaves(param_shardings(mesh, self.template, cfg, plan))
        self.dims: List[Optional[int]] = [
            _first(s, plan.dp) if plan.fsdp else None for s in specs]
        self.model_dims: List[Optional[int]] = [
            _first(s, tp) if self.tp_size > 1 else None for s in specs]
        self.sharded: List[bool] = []
        for (path, leaf), dim in zip(flat, self.model_dims):
            local = train_model_dim(path, leaf.shape) \
                if self.tp_size > 1 else None
            if local is not None and local != dim:
                raise ValueError(f"{path}: the model axis shards dim {dim}, "
                                 f"the tensor-parallel model dim {local}")
            self.sharded.append(local is not None)

    # --- rows ---------------------------------------------------------
    def rows(self, batch, microbatches: int = 1):
        """This rank's rows of a global batch: its data coordinate's 1/D
        of each of the ``microbatches`` consecutive row blocks (all its
        rows at 1)."""
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

    # --- slices -------------------------------------------------------
    def shard(self, tree):
        """This rank's slice of every leaf of a full parameter-shaped
        tree, on both axes (identity on a mesh that shards nothing)."""
        if not self.plan.fsdp and self.tp_size == 1:
            return tree
        return tree_unflatten(tree, [
            _narrow(_narrow(x, m, self.tp_index, self.tp_size), d,
                    self.index, self.size)
            for x, d, m in zip(tree_leaves(tree), self.dims,
                               self.model_dims)])

    def _gather(self, leaves, dims, size, index, group):
        """Each leaf with a dim in ``dims`` made whole along it from the
        ``size`` ranks of ``group`` (zero-filled buffers, one
        all-reduce)."""
        full = []
        for x, d in zip(leaves, dims):
            if d is None:
                full.append(x)
                continue
            shape = list(x.shape)
            shape[d] *= size
            buf = x.new_zeros(shape)
            n = x.shape[d]
            buf.narrow(d, index * n, n).copy_(x)
            full.append(buf)
        _all_sum([t for t, d in zip(full, dims) if d is not None], group)
        return full

    def _gather_data(self, tree):
        if not self.plan.fsdp or self.size == 1:
            return tree
        return tree_unflatten(tree, self._gather(
            tree_leaves(tree), self.dims, self.size, self.index, self.group))

    def _gather_model(self, tree, dims):
        if self.tp_size == 1:
            return tree
        return tree_unflatten(tree, self._gather(
            tree_leaves(tree), dims, self.tp_size, self.tp_index,
            self.tp_group))

    def gather(self, tree):
        """The full tree from every rank's slices (a collective on both
        axes; identity on a mesh that shards nothing)."""
        return self._gather_model(self._gather_data(tree), self.model_dims)

    def forward_view(self, tree):
        """What the forward pass runs on: every leaf whole along the data
        axis, and along the model axis too but for the block matrices and
        head biases, which stay this rank's shards."""
        return self._gather_model(self._gather_data(tree), [
            None if s else m for m, s in zip(self.model_dims, self.sharded)])

    def model_slices(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of ``forward_view``'s leaves cut to this rank's
        model shards: the leaves gathered over the model axis got whole
        gradients, the same on every model rank."""
        return [g if s else _narrow(g, m, self.tp_index, self.tp_size)
                for g, m, s in zip(grads, self.model_dims, self.sharded)]

    def data_slices(self, tree):
        """This rank's FSDP slice of every leaf (identity without FSDP)."""
        if not self.plan.fsdp:
            return tree
        return tree_unflatten(tree, [
            _narrow(x, d, self.index, self.size)
            for x, d in zip(tree_leaves(tree), self.dims)])

    def shard_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step, mu=self.shard(state.mu),
                          nu=self.shard(state.nu))

    def gather_state(self, state: AdamWState) -> AdamWState:
        return AdamWState(step=state.step, mu=self.gather(state.mu),
                          nu=self.gather(state.nu))

    # --- collectives --------------------------------------------------
    def context(self):
        """``dp_context`` over the data axis and ``tp_context`` (wire 32)
        over the model axis, where each is larger than 1."""
        stack = contextlib.ExitStack()
        if self.size > 1:
            stack.enter_context(dp_context(self.group))
        if self.tp_size > 1:
            stack.enter_context(tp_context(self.tp_group, 32))
        return stack

    def all_sum(self, tensors: List[torch.Tensor]) -> None:
        """Sum ``tensors`` over the data axis in place: one all-reduce of
        one flat buffer per dtype."""
        if self.size == 1 or not tensors:
            return
        _all_sum(tensors, self.group)

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of gradients whole along the data axis and cut
        to this rank's model shards: the model-sharded leaves' squares
        summed over the model axis, the others' counted once."""
        if self.tp_size == 1:
            return global_norm(grads)
        sq = [torch.sum(torch.square(g.to(torch.float32))) for g in grads]
        shards = torch.stack([q for q, m in zip(sq, self.model_dims)
                              if m is not None]).sum()
        dist.all_reduce(shards, op=dist.ReduceOp.SUM, group=self.tp_group)
        whole = [q for q, m in zip(sq, self.model_dims) if m is None]
        return torch.sqrt(shards + torch.stack(whole).sum()
                          if whole else shards)

    def all_max(self, values: List[float]) -> List[float]:
        """Every rank's maximum of each of ``values`` (host floats)."""
        if self.mesh.size == 1:
            return list(values)
        t = torch.tensor(values, dtype=torch.float64)
        if dist.get_backend() != "gloo":
            t = t.to(self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return t.tolist()


def auto_microbatches(cfg: ModelConfig, mesh, shape: str,
                      budget_bytes: float = 3e9) -> int:
    """Gradient-accumulation factor sized so that the per-layer residual
    carries (n_layers x [B_local, T, D] bf16) fit the activation budget:
    the smallest power of two, at most the rows per data rank, that
    brings them within ``budget_bytes``.  ``mesh``: a ``Mesh``, a
    ``MeshSpec`` (``make_production_mesh``), or None for one device; its
    ``pod`` and ``data`` axes divide the batch."""
    s = SHAPES[shape]
    dp = 1 if mesh is None else mesh.axis_size("pod") * mesh.axis_size(
        "data")
    b_local = max(1, s["batch"] // dp)
    n_layers = cfg.n_layers + cfg.n_enc_layers
    carries = n_layers * b_local * s["seq"] * cfg.d_model * 2
    m = 1
    while carries / m > budget_bytes and m < b_local:
        m *= 2
    return m


def build_train_step(cfg: ModelConfig, mesh: Optional[Mesh] = None,
                     shape: str = "train_4k", fsdp: Optional[bool] = None,
                     microbatches: Optional[int] = None,
                     bf16_compute: bool = True, peak_lr: float = 3e-4,
                     remat_policy: str = "full", *, device="cuda",
                     local_batch: bool = False) -> BuiltStep:
    """The train step of ``shape`` on ``device``, with the reference's
    defaults: bf16 compute, and ``microbatches=None`` taking
    ``auto_microbatches(cfg, mesh, shape)``.  ``remat_policy`` is
    accepted and not read, as in the reference (each layer runs under
    remat when ``cfg.remat``).  Over ``mesh`` (None: one device) it is
    one rank's part of the mesh step, which takes the global batch and
    keeps its data coordinate's rows, or, with ``local_batch``, takes
    this rank's rows as given (each host's own stream, as
    ``--distributed`` reads it).  A model axis larger than 1 takes the
    configs ``tp_train_supported`` accepts and raises
    ``NotImplementedError`` for the others.  ``args``: (params, opt_state,
    batch) of the cell on the meta device, whole trees as the reference's
    are.  ``meta``: ``optimizer``, ``init``, ``kind`` ("train"),
    ``microbatches``, and over a mesh ``plan`` and ``dp`` (the
    ``MeshRank`` that shards the trees and the loop's checkpoints)."""
    if mesh is not None and not isinstance(mesh, Mesh):
        raise ValueError(f"{type(mesh).__name__} has no ranks: a train step "
                         "runs over a mesh from make_mesh")
    dev = resolve_device(device)
    if microbatches is None:
        microbatches = auto_microbatches(cfg, mesh, shape)
    tp = mesh.axis_size("model") if mesh is not None else 1
    reason = tp_train_supported(cfg, tp)
    if reason is not None:
        raise NotImplementedError(
            f"tensor-parallel training of {cfg.name} over a model axis of "
            f"{tp}: {reason} (ROADMAP, Queue 1)")
    run_cfg = train_local_config(cfg, tp)   # this rank's heads, FFN slice
    opt = AdamW(learning_rate=cosine_schedule(peak_lr, 100, 10000))
    if cfg.family == "encdec":
        base_loss = lambda p, b: encdec.loss_fn(p, b, run_cfg, device=dev)
        init = encdec.init_params
    else:
        base_loss = lambda p, b: lm.loss_fn(p, b, run_cfg, device=dev)
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
        rows = next(iter(batch.values())).shape[0]
        if rows % microbatches:
            raise ValueError(f"a batch of {rows} rows does not split into "
                             f"{microbatches} microbatches")
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

    p_shapes = init(cfg, None, device="meta")
    args = (p_shapes, opt.init(p_shapes), input_specs(cfg, shape))
    meta: Dict[str, Any] = {"optimizer": opt, "init": init, "kind": "train",
                            "microbatches": microbatches}
    if mesh is None:
        return BuiltStep(fn=train_step, args=args, meta=meta)

    plan = make_plan(mesh, cfg, fsdp)
    dp = MeshRank(mesh, cfg, plan, init, dev)

    def mesh_train_step(params, opt_state, batch):
        batch = as_device(batch)
        if not local_batch:
            batch = dp.rows(batch, microbatches)
        dp.check_dispatch(batch, microbatches)
        view = dp.forward_view(params)
        with dp.context():
            loss, nll, gs = loss_and_grads(view, batch)
        gs = dp.model_slices(gs)
        loss, nll = loss.to(torch.float32), nll.to(torch.float32)
        dp.all_sum(gs + [loss, nll])
        gnorm = dp.grad_norm(gs)
        return finish(params, opt_state,
                      dp.data_slices(tree_unflatten(params, gs)), loss, nll,
                      gnorm=gnorm)

    meta.update(plan=plan, dp=dp)
    return BuiltStep(fn=mesh_train_step, args=args, meta=meta)
