"""AdamW and its schedule (port of ``repro.optim.adamw``).

Functional, as the reference: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state, grad norm)``,
``apply(params, updates)``.  f32 moments, bias correction, clipping at
the global norm ``clip_norm`` and decoupled weight decay on leaves of two
or more dimensions only.  ``torch.optim.AdamW`` is not used: it decays
every leaf, before the moment update, and does not clip.

Parameter trees are the port's (nested dicts and lists of tensors, as
``lm.init_params`` / ``encdec.init_params`` emit them).  The updates run
under ``torch.no_grad()``, so a tree of plain tensors stays one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple, Optional, Union

import torch

from repro_torch.tree import tree_leaves, tree_map


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32, 0-d
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    learning_rate: Union[Callable[[torch.Tensor], torch.Tensor], float] = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: Optional[float] = 1.0

    def init(self, params) -> AdamWState:
        leaves = tree_leaves(params)
        dev = leaves[0].device if leaves else None
        zeros = lambda t: tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32), t)
        return AdamWState(step=torch.zeros((), dtype=torch.int32,
                                           device=dev),
                          mu=zeros(params), nu=zeros(params))

    def lr(self, step):
        if callable(self.learning_rate):
            return self.learning_rate(step)
        return self.learning_rate

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params, gnorm=None):
        """``gnorm``: the global norm of the whole gradient when ``grads``
        is this rank's slice of it (FSDP); None takes ``grads``' own."""
        step = state.step + 1
        if gnorm is None:
            gnorm = global_norm(grads)
        if self.clip_norm is not None:
            scale = torch.clamp(self.clip_norm / (gnorm + 1e-9), max=1.0)
            grads = tree_map(lambda g: g * scale, grads)

        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                      state.mu, grads)
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state.nu, grads)
        stepf = step.to(torch.float32)
        c1 = 1 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                        device=stepf.device), stepf)
        c2 = 1 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                        device=stepf.device), stepf)
        lr = self.lr(step)

        def upd(p, m, v):
            u = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if self.weight_decay and p.ndim >= 2:
                u = u + self.weight_decay * p.to(torch.float32)
            return (-lr * u).to(p.dtype)

        updates = tree_map(upd, params, mu, nu)
        return updates, AdamWState(step=step, mu=mu, nu=nu), gnorm

    @torch.no_grad()
    def apply(self, params, updates):
        return tree_map(lambda p, u: p + u, params, updates)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int,
                    final_frac: float = 0.1):
    """Linear warmup to ``peak_lr``, then a cosine down to
    ``final_frac * peak_lr`` at ``total_steps``; ``fn(step)`` takes the
    step as a tensor and returns an f32 0-d tensor."""
    def fn(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps) /
                        max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) *
                         0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)
    return fn
