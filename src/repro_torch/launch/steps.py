"""Step functions for training, prefill and decode on one device.

``make_train_step`` builds the training step: the loss and its gradients
(:func:`value_and_grad`, autograd over the parameter tree), gradient
accumulation in f32 over ``tc.grad_accum`` microbatches, then
``adamw_update``.  ``make_prefill_step`` and ``make_decode_step`` wrap
the serving forwards.

The JAX package's module also holds ``input_specs``, ``lower_cell`` and
the sharding plans of its multi-pod dry-run.  They wait for the LM
dry-run (ROADMAP.md item 13b) and the multi-card slice (LM queue L6);
on one card there is no mesh to plan for.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.models import model as MDL
from repro_torch.optim import adamw_update
from repro_torch.tree import flatten, leaves, tree_map, unflatten


def value_and_grad(cfg: ModelConfig, params, batch, *, impl="chunked",
                   remat=True):
    """``(loss, metrics, grads)`` of ``forward_train`` at ``params`` (a
    parameter tree; not modified) on ``batch``: the loss and metrics
    detached, the gradients a tree shaped like ``params``."""
    flat, spec = flatten(params)
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in flat]
        on = {k: v.to(flat[0].device) for k, v in batch.items()}
        loss, metrics = MDL.forward_train(unflatten(spec, live), cfg, on,
                                          impl=impl, remat=remat)
        grads = torch.autograd.grad(loss, live)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(spec, list(grads))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, impl="chunked"):
    """Train step with optional gradient accumulation.

    With ``tc.grad_accum = N`` the batch is split into N microbatches run
    one after the other; gradients accumulate in f32 and are averaged,
    and the loss is the microbatches' mean, as in the reference.  The
    step returns new trees and leaves its inputs as they were."""

    def train_step(params, opt_state, batch):
        accum = tc.grad_accum
        if accum <= 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch,
                                                  impl=impl, remat=tc.remat)
        else:
            mbs = [{k: v.reshape((accum, v.shape[0] // accum)
                                 + tuple(v.shape[1:]))[i]
                    for k, v in batch.items()} for i in range(accum)]
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=leaves(params)[0].device)
            for mb in mbs:
                lm, metrics, g = value_and_grad(cfg, params, mb, impl=impl,
                                                remat=tc.remat)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + lm
            grads = tree_map(lambda g: g / accum, grads)
            loss = loss / accum
        params2, opt2, om = adamw_update(params, grads, opt_state, tc)
        return params2, opt2, {"loss": loss, **metrics, **om}

    return train_step


def default_train_config(cfg: ModelConfig) -> TrainConfig:
    """Production defaults: grad accumulation scaled with model size so
    activation memory stays within a device's memory."""
    n = cfg.params_total()
    if n > 1e11:
        accum = 8
    elif n > 5e9:
        accum = 4
    elif n > 3e9:
        accum = 2
    else:
        accum = 1
    return TrainConfig(grad_accum=accum)


def make_prefill_step(cfg: ModelConfig, *, impl="chunked"):
    def prefill_step(params, batch):
        return MDL.forward_prefill(params, cfg, batch, impl=impl)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        return MDL.forward_decode(params, cfg, batch["tokens"], cache)

    return decode_step
