"""AdamW with global-norm clipping and a warmup-cosine schedule.

Pure functions over parameter trees (``repro_torch.tree``), as the JAX
package's ``optim/adamw.py`` is; not ``torch.optim.AdamW``, whose update
order and decay mask differ.  The optimizer state is ``(m, v, step)``:
f32 trees shaped like the parameters and a 0-d int32 step, all on the
parameters' device.  Every scalar (learning rate, bias corrections,
norm) stays a device tensor, so a step reads nothing back to the host.
On DTensor parameters (a sharded step) the update runs on each rank's
own shards, and the global norm sums each rank's local squares and
all-reduces them once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.tree import flatten, leaves, tree_map, unflatten


class OptState(NamedTuple):
    m: object
    v: object
    step: torch.Tensor


def init_opt_state(params) -> OptState:
    first = leaves(params)[0]
    return OptState(
        m=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        v=tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                   params),
        step=torch.zeros((), dtype=torch.int32, device=first.device))


def lr_schedule(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """f32 learning rate at ``step`` (a 0-d tensor): linear warmup, then a
    cosine from the peak down to a tenth of it."""
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, tc.warmup_steps), max=1.0)
    prog = torch.clamp((step - tc.warmup_steps)
                       / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return tc.learning_rate * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    flat = leaves(tree)
    from torch.distributed.tensor import DTensor
    if flat and isinstance(flat[0], DTensor):
        return _sharded_norm(flat)
    total = 0
    for g in flat:
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def _sharded_norm(flat) -> torch.Tensor:
    """The global norm of DTensor leaves: each rank sums the squares of
    its own shards, a leaf replicated over n ranks weighted 1 / n, and
    one all-reduce over the whole group adds the ranks' sums.  Returns
    a plain tensor."""
    import torch.distributed as dist
    mesh = flat[0].device_mesh
    total = 0
    for g in flat:
        reps = 1
        for i, p in enumerate(g.placements):
            if not p.is_shard():
                reps *= mesh.size(i)
        total = total + torch.sum(torch.square(g.to_local().float())) / reps
    c10d = torch.ops._c10d_functional
    total = c10d.wait_tensor(c10d.all_reduce(total, "sum",
                                             dist.group.WORLD.group_name))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def adamw_update(params, grads, state: OptState, tc: TrainConfig):
    """One AdamW step.  Returns ``(new_params, new_state, metrics)``;
    the inputs are not modified."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip)
    step = state.step + 1
    lr = lr_schedule(state.step, tc)
    b1, b2 = tc.beta1, tc.beta2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float()
        m_new = b1 * m + (1 - b1) * g
        v_new = b2 * v + (1 - b2) * torch.square(g)
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + tc.eps)
        # decoupled weight decay on matrices only (ndim >= 2)
        wd = tc.weight_decay if p.dim() >= 2 else 0.0
        p_new = p.float() * (1.0 - lr * wd) - lr * delta
        return p_new.to(p.dtype), m_new, v_new

    flat_p, spec = flatten(params)
    out = [upd(p, g, m, v) for p, g, m, v in
           zip(flat_p, leaves(grads), leaves(state.m), leaves(state.v))]
    new_p = unflatten(spec, [o[0] for o in out])
    new_m = unflatten(spec, [o[1] for o in out])
    new_v = unflatten(spec, [o[2] for o in out])
    return new_p, OptState(new_m, new_v, step), {"grad_norm": gnorm,
                                                  "lr": lr}
