"""The train step (port of the train part of ``repro.launch.steps``), for
one device and no mesh.

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

The serving steps (``build_prefill_step``, ``build_serve_step``) and
``auto_microbatches`` are built on the reference's mesh and shape specs;
they wait for the port's dry-run tools.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models import encdec, lm
from repro_torch.models.common import ModelConfig
from repro_torch.optim.adamw import AdamW, cosine_schedule
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass
class BuiltStep:
    fn: Any
    meta: Dict[str, Any]


def _cast_bf16(params):
    return tree_map(
        lambda p: p.to(torch.bfloat16)
        if (p.dtype == torch.float32 and p.ndim >= 2) else p, params)


def build_train_step(cfg: ModelConfig, microbatches: int = 1,
                     bf16_compute: bool = False, peak_lr: float = 3e-4,
                     device="cuda") -> BuiltStep:
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

    def train_step(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in batch.items()}
        # the bf16 cast sits outside the microbatch loop; d(cast)/dp = 1,
        # so gradients with respect to the cast leaves are the masters'
        fp = _cast_bf16(params) if bf16_compute else params
        fp = tree_map(lambda p: p.detach().requires_grad_(), fp)
        if microbatches > 1:
            acc, ls, nlls = None, [], []
            for i in range(microbatches):
                mb = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                   + v.shape[1:])[i]
                      for k, v in batch.items()}
                loss_i, nll_i, gs = grads_of(fp, mb)
                acc = gs if acc is None else [a + g for a, g in zip(acc, gs)]
                ls.append(loss_i)
                nlls.append(nll_i)
            gs = [g / microbatches for g in acc]
            loss, nll = torch.stack(ls).mean(), torch.stack(nlls).mean()
        else:
            loss, nll, gs = grads_of(fp, batch)
        grads = tree_unflatten(params, gs)
        updates, opt_state, gnorm = opt.update(grads, opt_state, params)
        params = opt.apply(params, updates)
        metrics = {"loss": loss.to(torch.float32),
                   "nll": nll.to(torch.float32),
                   "grad_norm": gnorm.to(torch.float32),
                   "step": opt_state.step}
        return params, opt_state, metrics

    return BuiltStep(fn=train_step, meta={"optimizer": opt, "init": init})
