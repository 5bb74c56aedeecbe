"""Tensor-parallel quantized serving: the LUT weight tree sharded over a
``torch.distributed`` process group (port of ``repro.serving.distributed``).

The reference shards the quantized tree over a ``(1, M)`` mesh and runs
the serving entry points under ``shard_map``.  Here each of the ``M``
ranks of a process group is one shard: it keeps its own slice of the tree
and runs the unchanged model code (``models.lm``) over
``local_config(cfg, M)`` inside ``dist.sharding.tp_context``, Megatron
style:

  * column-parallel (``wq/wk/wv/w_gate/w_up``): output dim sliced, so a
    rank owns ``n_heads/M`` query heads, ``n_kv/M`` KV heads and
    ``d_ff/M`` of the gate/up projection;
  * row-parallel (``wo``, ``w_down``): reduction dim sliced, partial sums
    combined by one all-reduce per attention and one per MLP (the
    ``tp_all_reduce`` hooks in ``models``), at wire 32 (f32, exact up to
    summation order) or wire 8 (int8 + one scale per tensor,
    ``dist.compress``);
  * quantized leaves: packed codes and group scales are sliced along the
    logical axes of the matrix they encode (whole groups of K for a
    row-parallel leaf); codebooks and every 1-D param replicate;
  * embeddings, ``lm_head`` and norms replicate, so every rank computes
    the full logits row and greedy decode needs no gather;
  * each rank's KV pool holds its ``n_kv/M`` heads (axis 3 of the ring
    ``[L, B, S, n_kv, Dh]`` and paged ``[L, NB, BS, n_kv, Dh]`` layouts);
    block tables, lengths and all pool accounting stay logical and the
    same on every rank, so the engine's scheduler and block manager never
    see TP.

Every rank runs the same engine on the same requests (SPMD); only the
model's collectives cross ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import _NAME_RE, _QUANT_FIELDS, _ROW_PARALLEL
from repro_torch.models.common import ModelConfig
from repro_torch.models.sail_linear import QTensor, StackedQTensor, _walk
from repro_torch.planning.cost import tp_allreduce_elems

__all__ = [
    "TPServing", "local_config", "localize_params", "serving_param_spec",
    "shard_alignment_error", "slice_params", "tp_allreduce_elems",
    "tp_supported",
]

# The seven block matrices TP shards; everything else is replicated so
# every rank holds the full LUT machinery and the full logits path.
_COLUMN_PARALLEL = ("wq", "wk", "wv", "w_gate", "w_up")


def tp_supported(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why this (config, shard count) cannot serve tensor-parallel,
    ``None`` when it can: dense GQA attention only, no biases (their
    addition would have to move after the reduce), and heads, KV heads
    and ``d_ff`` divisible by ``tp``."""
    if tp <= 1:
        return None
    if cfg.family != "dense":
        return (f"family={cfg.family!r} is not tensor-parallel servable "
                "(dense attention only — recurrent/expert state does not "
                "shard on the model axis)")
    if cfg.attention_bias or cfg.mlp_bias:
        return ("attention/MLP biases are not supported under TP (bias "
                "addition must move after the partial-sum reduce)")
    if cfg.n_heads % tp:
        return f"n_heads={cfg.n_heads} not divisible by tp={tp}"
    if cfg.n_kv % tp:
        return f"n_kv={cfg.n_kv} not divisible by tp={tp}"
    if cfg.d_ff % tp:
        return f"d_ff={cfg.d_ff} not divisible by tp={tp}"
    return None


def local_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """One rank's view of ``cfg``: its heads and FFN slice.  ``d_head`` is
    pinned because it defaults to ``d_model // n_heads`` and must not
    change when ``n_heads`` shrinks."""
    if tp <= 1:
        return cfg
    return dataclasses.replace(
        cfg, n_heads=cfg.n_heads // tp, n_kv=cfg.n_kv // tp,
        d_ff=cfg.d_ff // tp, d_head=cfg.head_dim)


def serving_param_spec(path: str, shape: Tuple[int, ...]) -> tuple:
    """Which axis of one serving parameter carries the shard ("model"),
    as the reference's PartitionSpec entries: the output dim of a
    column-parallel matrix, the reduction dim of a row-parallel one, none
    elsewhere.  Quantized fields (``path`` ending ``.packed`` /
    ``.scales`` / ``.codebook``) follow the matrix they encode; codebooks
    replicate."""
    nd = len(shape)
    quant_field = next((f for f in _QUANT_FIELDS if path.endswith(f)), None)
    if quant_field is not None:
        if quant_field == ".codebook":
            return (None,) * nd
        return serving_param_spec(path[: -len(quant_field)], shape)
    names = _NAME_RE.findall(path)
    leaf = names[-1] if names else ""
    spec: list = [None] * nd
    if nd >= 2 and leaf in _ROW_PARALLEL:
        spec[-2] = "model"
    elif nd >= 2 and leaf in _COLUMN_PARALLEL:
        spec[-1] = "model"
    return tuple(spec)


def _is_qtensor(x) -> bool:
    return isinstance(x, (QTensor, StackedQTensor))


def _leaf_name(path: str) -> str:
    names = _NAME_RE.findall(path)
    return names[-1] if names else ""


def localize_params(params, tp: int):
    """Each row-parallel quantized leaf with ``k`` rewritten to ``k // tp``,
    its rank's K range, so ``unpack_grouped`` and the kernels see a
    self-consistent local tensor.  Column-parallel and replicated leaves
    keep their full K."""
    if tp <= 1:
        return params

    def one(path, leaf):
        if _is_qtensor(leaf) and _leaf_name(path) in _ROW_PARALLEL:
            return dataclasses.replace(leaf, k=leaf.k // tp)
        return leaf
    return _walk(params, one)


def shard_alignment_error(params, tp: int) -> Optional[str]:
    """Why this quantized tree cannot shard ``tp`` ways, ``None`` when it
    can.  A row-parallel leaf splits its K, so each rank's slice must
    cover whole quantization groups: ``(k // group_size) % tp == 0``."""
    if tp <= 1:
        return None
    problems = []

    def one(path, leaf):
        if _is_qtensor(leaf) and _leaf_name(path) in _ROW_PARALLEL:
            groups = leaf.k // leaf.group_size
            if groups % tp:
                problems.append(
                    f"{_leaf_name(path)}: {groups} quant groups (k={leaf.k}, "
                    f"G={leaf.group_size}) not divisible by tp={tp}")
        return leaf
    _walk(params, one)
    return "; ".join(problems) if problems else None


def _slice(t: torch.Tensor, spec: tuple, rank: int, tp: int) -> torch.Tensor:
    """Rank ``rank``'s contiguous block of ``t`` along the axis ``spec``
    marks "model" (the whole tensor when none is)."""
    if "model" not in spec:
        return t
    axis = spec.index("model")
    size = t.shape[axis] // tp
    return t.narrow(axis, rank * size, size).contiguous()


def slice_params(params, rank: int, tp: int):
    """Rank ``rank``'s shard of a (quantized or raw) parameter tree: each
    sliced tensor its contiguous block, made contiguous, and row-parallel
    ``k`` localized.  Column-parallel leaves are sliced on N (``packed``,
    ``scales``, a stacked leaf's last axis), row-parallel ones on whole
    groups of K (the ``(K/G) * wpg`` rows of ``packed``, the ``K/G`` rows
    of ``scales``); codebooks and everything else replicate.

    Raises when a row-parallel quantized leaf's group count does not
    divide the shard count: a K-slice cutting a group is wrong, not
    slow."""
    err = shard_alignment_error(params, tp)
    if err is not None:
        raise ValueError(
            f"quantized tree cannot shard tp={tp} ways: {err} — use a "
            "group_size whose per-matrix group count divides the shard "
            "count")

    def one(path, leaf):
        if _is_qtensor(leaf):
            return dataclasses.replace(
                leaf,
                packed=_slice(leaf.packed, serving_param_spec(
                    path + ".packed", leaf.packed.shape), rank, tp),
                scales=_slice(leaf.scales, serving_param_spec(
                    path + ".scales", leaf.scales.shape), rank, tp))
        if isinstance(leaf, torch.Tensor):
            return _slice(leaf, serving_param_spec(path, leaf.shape), rank,
                          tp)
        return leaf
    return localize_params(_walk(params, one), tp)


class TPServing:
    """One rank's placement in a ``tp``-rank process group: its shard of
    the tree (:meth:`shard_params`) and the all-reduce bytes a decode
    iteration moves (:meth:`allreduce_bytes_per_iter`).

    The engine constructs one when ``tp > 1`` and runs the ``lm`` entry
    points over ``local_config(cfg, tp)`` inside ``tp_context(group,
    wire_bits)``, its KV pool allocated there at this rank's ``n_kv/tp``
    heads; scheduling, sampling and block accounting stay logical."""

    def __init__(self, cfg: ModelConfig, tp: int, wire_bits: int = 32,
                 group=None):
        reason = tp_supported(cfg, tp)
        if reason is not None:
            raise ValueError(f"tensor-parallel serving unavailable: {reason}")
        if wire_bits not in (8, 32):
            raise ValueError(f"wire_bits must be 8 or 32, got {wire_bits}")
        world = dist.get_world_size(group) if dist.is_initialized() else 1
        if world != tp:
            raise ValueError(
                f"tp={tp} needs a process group of {tp} ranks, but the "
                f"group has {world} — start the ranks with "
                "repro_torch.launch.mesh.run_ranks (the launcher's --tp) "
                "and build one engine on each")
        self.cfg = cfg
        self.tp = int(tp)
        self.wire_bits = int(wire_bits)
        self.group = group
        self.rank = dist.get_rank(group)

    def shard_params(self, params):
        """This rank's shard of ``params`` (:func:`slice_params`)."""
        return slice_params(params, self.rank, self.tp)

    def allreduce_bytes_per_iter(self, batch: int) -> int:
        """All-reduce bytes one decode iteration moves per rank (the ring
        all-reduce's 2(M-1)/M factor applied to the payload)."""
        payload = batch * tp_allreduce_elems(self.cfg) * self.wire_bits // 8
        return int(payload * 2 * (self.tp - 1) / self.tp)
