"""Placement and collectives (port of ``repro.dist.sharding``).

**Placement.**  One plan covers training and serving: a data axis carries
the batch, a model axis carries tensor-parallel weight shards
(``launch.mesh.Mesh``).  The rules are the reference's, name-based over
``repro_torch.tree`` keystr paths, and one vocabulary (``_ROW_PARALLEL``,
``_EMBED``, ``_QUANT_FIELDS``, ``_NAME_RE``) serves both roles
(``serving.distributed`` reads it too):

  * column-parallel matrices: last dim on the model axis, the one before
    it on the data axes under FSDP;
  * row-parallel (``wo``, ``w_down``): the model axis on the reduction
    dim, the data axes on the output dim under FSDP;
  * embeddings: dim 0 on the model axis;
  * a quantized leaf's ``.packed`` / ``.scales`` follow the matrix they
    encode (the same dim order), its ``.codebook`` replicates;
  * 1-D leaves replicate.

A spec is a ``Spec``: a tuple with one entry per dim, each ``None``, an
axis name or a tuple of names (``tuple(PartitionSpec)`` in the
reference), and a leaf of the port's trees.  ``_trim_spec`` drops every
axis that the mesh lacks or that does not divide its dim.

**Collectives.**  Model code stays unaware of the shard count.  Under
tensor parallelism, row-parallel matmuls (``wo``, ``w_down``) pass their
partial sums through ``tp_all_reduce``, a replicated tensor passes
through ``tp_copy`` where it meets this rank's shard (the activation
entering the column-parallel ``wq / wk / wv`` and ``w_gate / w_up``, the
qk-norm scales applied to this rank's heads), and the activation
quantization of a K-sharded input passes its per-token absmax through
``tp_axis_max``.
Under data-parallel training, the loss's denominators
(``lm.chunked_nll``'s token count, the MoE load-balancing fractions)
pass through ``dp_sum``, so each rank's loss is its share of the global
batch's.  Outside a ``tp_context`` / ``dp_context`` all four are the
identity, so single-device code launches exactly what it launched
before; inside, each is one ``torch.distributed`` all-reduce over the
context's process group, or none.

Tensor-parallel training differentiates through Megatron's pair of
operators (``torch.autograd.Function``s), taken only where autograd
records the call (grad mode on and the input requiring grad):
``tp_all_reduce`` sums in the forward pass and passes the gradient
through; ``tp_copy`` passes the activation through and sums its gradient
over the group in the backward pass.  So the gradient of every
replicated activation, and of every replicated leaf (norms, embeddings,
the qk-norm scales), is whole and the same on every rank.  Serving records
nothing and takes the plain paths: ``tp_copy`` launches nothing, and
``tp_all_reduce`` sums in place, at wire 8 or 32.  A backward pass that
recomputes a layer (``models.remat``) issues that layer's forward
collectives again, in the same order on every rank, up to the last
tensor the backward pass needs (in a block, ``wo``'s sum and not
``w_down``'s).

The reference's ``maybe_constrain`` (a sharding hint to XLA) is a no-op
without an XLA mesh, and the port omits its calls.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import re
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from repro_torch.dist.compress import _quantize_dequantize
from repro_torch.tree import tree_flatten_with_path, tree_map, tree_unflatten

AxisName = Union[str, Tuple[str, ...], None]

# the placement vocabulary: row-parallel leaves shard their reduction dim;
# embeddings their rows; a quantized leaf's fields follow the matrix they
# encode (its codebook replicates); keystr paths name dict keys in quotes
_ROW_PARALLEL = ("wo", "w_down")
_EMBED = ("embed", "pos_embed")
_QUANT_FIELDS = (".packed", ".scales", ".codebook")
_NAME_RE = re.compile(r"\['([^']+)'\]")


class Spec(tuple):
    """A placement spec: one entry per dim (``None``, an axis name or a
    tuple of names).  A leaf of the port's trees."""

    def __repr__(self) -> str:
        return f"Spec{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class Plan:
    """Logical placement plan resolved against a concrete mesh."""
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: Optional[str] = "model"
    fsdp: bool = False

    @property
    def dp(self) -> AxisName:
        if not self.dp_axes:
            return None
        return self.dp_axes[0] if len(self.dp_axes) == 1 else self.dp_axes


def make_plan(mesh, cfg=None, fsdp: Optional[bool] = None) -> Plan:
    """The plan of ``mesh``: its data axes carry the batch, ``model`` (when
    larger than 1) the shards; FSDP by default when a data axis is larger
    than 1."""
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    dp_axes = tuple(a for a in ("pod", "data", "batch") if a in sizes)
    tp = "model" if sizes.get("model", 1) > 1 else None
    if fsdp is None:
        fsdp = any(sizes.get(a, 1) > 1 for a in dp_axes)
    return Plan(dp_axes=dp_axes, tp_axis=tp, fsdp=bool(fsdp))


def param_spec(path: str, shape: Sequence[int], cfg, plan: Plan) -> Spec:
    """The spec of one parameter, by keystr path and shape (before
    ``_trim_spec``).  Leading stacked-layer / expert dims never shard."""
    nd = len(shape)
    if nd == 0:
        return Spec()
    quant_field = next((f for f in _QUANT_FIELDS if path.endswith(f)), None)
    if quant_field is not None:
        if quant_field == ".codebook":
            return Spec((None,) * nd)
        # packed [(K//G)*wpg, N] and scales [K//G, N] keep the matrix's
        # (K-derived, N) dim order: its rule applies at this rank
        return param_spec(path[: -len(quant_field)], shape, cfg, plan)
    names = _NAME_RE.findall(path)
    leaf = names[-1] if names else ""
    if nd == 1:
        return Spec((None,))
    spec: list = [None] * nd
    if any(e in leaf for e in _EMBED) or (not names and nd == 2):
        spec[0] = plan.tp_axis
    elif leaf in _ROW_PARALLEL:
        spec[-2] = plan.tp_axis
        if plan.fsdp:
            spec[-1] = plan.dp
    else:
        spec[-1] = plan.tp_axis
        if plan.fsdp:
            spec[-2] = plan.dp
    return Spec(spec)


def _axis_size(mesh, entry: AxisName) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.shape))
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(sizes.get(a, 1) for a in entry)
    return sizes.get(entry, 1)


def _trim_spec(spec: Sequence, shape: Sequence[int], mesh) -> Spec:
    """Fit a spec to a concrete shape: pad / truncate it to the rank and
    drop any axis that the mesh lacks or that does not divide its dim."""
    names = set(mesh.axis_names)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries[:len(shape)]):
        if isinstance(entry, (tuple, list)):
            entry = tuple(a for a in entry if a in names) or None
            if entry is not None and len(entry) == 1:
                entry = entry[0]
        elif entry is not None and entry not in names:
            entry = None
        if entry is not None and dim % _axis_size(mesh, entry) != 0:
            entry = None
        out.append(entry)
    return Spec(out)


def _shape_of(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_shardings(mesh, tree, cfg, plan: Plan):
    """The trimmed spec of every leaf of a parameter (or AdamW moment)
    tree, as a tree of ``Spec`` leaves."""
    flat = tree_flatten_with_path(tree)
    return tree_unflatten(tree, [
        _trim_spec(param_spec(path, _shape_of(leaf), cfg, plan),
                   _shape_of(leaf), mesh) for path, leaf in flat])


def data_shardings(mesh, tree, plan: Plan):
    """Dim 0 (the batch) over the data axes, for every leaf of an input
    tree."""
    return tree_map(lambda leaf: _trim_spec(Spec((plan.dp,)),
                                            _shape_of(leaf), mesh), tree)


def cache_shardings(mesh, tree, plan: Plan):
    """Decode-cache placement: the batch at dim 1 of the stacked per-layer
    arrays ([L, B, ...]) and at dim 0 of a 1-D ``length``; the rest
    replicated."""
    def one(leaf):
        shape = _shape_of(leaf)
        if len(shape) == 1:
            spec = (plan.dp,)
        elif len(shape) >= 2:
            spec = (None, plan.dp)
        else:
            spec = ()
        return _trim_spec(spec, shape, mesh)
    return tree_map(one, tree)


_TP_STATE: list = []


@contextlib.contextmanager
def tp_context(group=None, wire_bits: int = 32):
    """Make ``tp_all_reduce`` / ``tp_axis_max`` collectives over ``group``
    (None: the default group) for the calls inside this block;
    ``wire_bits`` 8 sends int8+scale partial sums."""
    _TP_STATE.append((group, int(wire_bits)))
    try:
        yield
    finally:
        _TP_STATE.pop()


def tp_active() -> bool:
    """Whether the calls here run inside a ``tp_context``."""
    return bool(_TP_STATE)


def _records(x: torch.Tensor) -> bool:
    """Whether autograd records an op on ``x`` (training, not serving)."""
    return torch.is_grad_enabled() and x.requires_grad


class _SumForward(torch.autograd.Function):
    """Forward: the sum over ``group``; backward: the gradient as is."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumBackward(torch.autograd.Function):
    """Forward: the identity; backward: the gradient's sum over
    ``group`` (the group of the forward call, whatever context the
    backward pass runs in)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, op=dist.ReduceOp.SUM, group=ctx.group)
        return g, None


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum row-parallel partial results over the group (identity outside
    a ``tp_context``).  At wire 8 each rank sends its partial sums
    quantize-dequantized to int8 codes with one scale for the whole
    tensor (``dist.compress``): no error feedback, since inference has
    no next iteration to carry a residual into.  Where autograd records
    the call (training) the sum is a new tensor whose gradient passes
    through unchanged, at wire 32 only."""
    if not tp_active():
        return x
    group, wire = _TP_STATE[-1]
    if _records(x):
        if wire != 32:
            raise ValueError(
                f"tensor-parallel training sums at wire 32, not {wire}: "
                "the int8 wire has no gradient")
        return _SumForward.apply(x, group)
    x = _quantize_dequantize(x) if wire == 8 else x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """A replicated tensor meeting this rank's shard (an activation
    entering column-parallel matmuls, a scale applied to this rank's
    heads): the identity, whose gradient is summed over the group where
    autograd records the call (each rank's shard gives a partial
    gradient).
    Launches nothing in the forward pass; the identity outside a
    ``tp_context`` and wherever autograd records nothing (serving)."""
    if not tp_active() or not _records(x):
        return x
    return _SumBackward.apply(x, _TP_STATE[-1][0])


def tp_axis_max(x: torch.Tensor) -> torch.Tensor:
    """Max over the group, in place (identity outside a ``tp_context``):
    the per-token absmax of a K-sharded input, so its activation codes
    and scale are the unsharded computation's bit for bit."""
    if not tp_active():
        return x
    group, _ = _TP_STATE[-1]
    x = x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


_DP_STATE: list = []


@contextlib.contextmanager
def dp_context(group=None):
    """Make ``dp_sum`` an all-reduce over ``group`` (the data axis's
    process group; None: the default group) for the calls inside this
    block, the backward passes that recompute them included."""
    _DP_STATE.append(group)
    try:
        yield
    finally:
        _DP_STATE.pop()


def dp_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the data-parallel group (identity outside a
    ``dp_context``); ``x`` carries no gradient (a count, a fraction's
    numerator)."""
    if not _DP_STATE:
        return x
    x = x.detach().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_DP_STATE[-1])
    return x
