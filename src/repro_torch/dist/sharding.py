"""Tensor-parallel collectives for serving (port of the serving part of
``repro.dist.sharding``).

Model code stays unaware of the shard count: row-parallel matmuls (``wo``,
``w_down``) pass their partial sums through ``tp_all_reduce``, and the
activation quantization of their K-sharded inputs passes its per-token
absmax through ``tp_axis_max``.  Outside a ``tp_context`` both are the
identity, so single-device serving launches exactly what it launched
before.  The serving engine enters ``tp_context`` around each model
call under TP; there they become ``torch.distributed`` collectives over
the context's process group, one ``all_reduce`` each.

The reference's ``maybe_constrain`` (a sharding hint to XLA) is a no-op
without a mesh, and the port omits its calls.  Its training placement
(``Plan``, ``make_plan``, ``param_spec``, ``param_shardings``,
``data_shardings``, ``cache_shardings``) waits for the port's training
slice and dry-run tools (ROADMAP, Queue 1 items 5-6).
"""
from __future__ import annotations

import contextlib
import re

import torch
import torch.distributed as dist

from repro_torch.dist.compress import _quantize_dequantize

# the reference's placement vocabulary: row-parallel leaves shard their
# reduction dim; a quantized leaf's fields follow the matrix they encode
# (its codebook replicates); keystr paths name their dict keys in quotes
_ROW_PARALLEL = ("wo", "w_down")
_QUANT_FIELDS = (".packed", ".scales", ".codebook")
_NAME_RE = re.compile(r"\['([^']+)'\]")

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


def tp_all_reduce(x: torch.Tensor) -> torch.Tensor:
    """Sum row-parallel partial results over the group (identity outside
    a ``tp_context``).  At wire 8 each rank sends its partial sums
    quantize-dequantized to int8 codes with one scale for the whole
    tensor (``dist.compress``): no error feedback, since inference has
    no next iteration to carry a residual into."""
    if not tp_active():
        return x
    group, wire = _TP_STATE[-1]
    x = _quantize_dequantize(x) if wire == 8 else x.contiguous()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


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
