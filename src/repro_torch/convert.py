"""Carry a parameter tree of the JAX reference into the port.

``params_from_numpy`` takes the reference's tree after
``jax.tree_util.tree_map(np.asarray, tree)`` — nested dicts/lists of
numpy arrays, raw f32 or quantized, of any family (xlstm's ``subs``
lists, hymba's SSM leaves, whisper's ``enc_blocks`` / ``dec_blocks``) —
and returns the port's tree of tensors on ``device``.  Quantized leaves are recognised by their fields
(``packed``, ``scales``, ``codebook``, ``bits``, ``group_size``, ``k``,
``abits``), so this module needs neither JAX nor the reference package.
Packed uint32 words become int32 tensors with the same bit patterns.
``params_to_numpy`` carries a raw tree (tensors only, as training leaves
it) back: numpy leaves, the same layout.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant import QTensor
from repro_torch.device import resolve_device
from repro_torch.models.sail_linear import StackedQTensor
from repro_torch.tree import tree_map

_QFIELDS = ("packed", "scales", "codebook", "bits", "group_size", "k",
            "abits")


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Reference tree (numpy leaves) -> port tree (tensors on device)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if all(hasattr(x, f) for f in _QFIELDS):
            cls = QTensor if np.ndim(x.packed) == 2 else StackedQTensor
            return cls(packed=_tensor(x.packed, dev),
                       scales=_tensor(x.scales, dev),
                       codebook=_tensor(x.codebook, dev), bits=int(x.bits),
                       group_size=int(x.group_size), k=int(x.k),
                       abits=None if x.abits is None else int(x.abits))
        return _tensor(x, dev)

    return conv(tree)


def params_to_numpy(tree):
    """Port tree of tensors (raw, unquantized) -> the same layout with
    numpy leaves on the host."""
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)
