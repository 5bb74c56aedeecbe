"""Rematerialisation for training (the reference's ``jax.checkpoint``).

``remat(fn, *args)`` runs ``fn`` under ``torch.utils.checkpoint`` (the
non-reentrant form) when autograd would record it: grad mode is on and a
tensor among ``args`` (nested dicts and lists, a layer's parameters)
requires grad.  The backward pass then recomputes ``fn`` instead of
keeping its intermediates: memory is bounded and no value changes.
Serving, whose plain tensors require no grad, calls ``fn`` directly.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.tree import tree_leaves


def grad_needed(*args) -> bool:
    return torch.is_grad_enabled() and any(
        isinstance(a, torch.Tensor) and a.requires_grad
        for a in tree_leaves(list(args)))


def remat(fn: Callable, *args, on: bool = True) -> Any:
    if on and grad_needed(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)
