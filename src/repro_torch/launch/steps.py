"""Step functions for training, prefill and decode, their sharding
plans, and the dry-run's planning of them.

``make_train_step`` builds the training step: the loss and its gradients
(:func:`value_and_grad`, autograd over the parameter tree), gradient
accumulation in f32 over ``tc.grad_accum`` microbatches, then
``adamw_update``.  ``make_prefill_step`` and ``make_decode_step`` wrap
the serving forwards.  Each runs on plain tensors (one device) or on
DTensors laid out by the plans below under an activation policy
(``distributed/actctx.py``): a sharded step.

``batch_shardings`` and ``cache_shardings`` are the reference's plans
for a cell's batch and decode cache (``models/params.py::
param_shardings`` the parameters').  ``input_specs``,
``abstract_cache`` and ``abstract_opt_state`` give meta-tensor
stand-ins for every input of a cell (the reference's
ShapeDtypeStructs), and :func:`lower_cell` plans a cell's step on them
under the counter of ``roofline/jaxpr_cost.py``: on one device, or at a
larger mesh on DTensors of meta shards over a fake process group of the
mesh's size (``launch/mesh.py::planning_mesh``), which counts one
device's ops and tallies the collectives.  Nothing is allocated and no
card is needed.  Every family of :data:`SHARDED_FAMILIES` (all six)
runs and plans its sharded steps: the MoE routes each rank's own
token groups and keeps its expert weights where they rest
(``models/moe.py``), the SSM runs each rank's batch rows whole
(``models/mamba2.py``), the hybrid and audio families compose those
with attention, and the vlm reduces its embedding before prepending
the vision tokens (``models/model.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.distributed import actctx
from repro_torch.launch.mesh import batch_axes, planning_mesh
from repro_torch.models import model as MDL
from repro_torch.models.params import Sharding, abstract_params, \
    distribute, param_shardings, replicated_sharding
from repro_torch.optim import adamw_update, init_opt_state
from repro_torch.roofline.jaxpr_cost import Cost, CostCounter
from repro_torch.tree import flatten, leaves, tree_map, unflatten

# the families whose sharded steps run (ROADMAP.md: L6b and L6b-2);
# ``lower_cell`` and ``launch/train.py::train`` refuse any other at a
# mesh of more than one device
SHARDED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_sharded(cfg: ModelConfig, mesh) -> None:
    """Raise ``NotImplementedError`` for a family outside
    :data:`SHARDED_FAMILIES` at a mesh of more than one device."""
    if mesh.size > 1 and cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"sharded execution of the {cfg.family} family at a mesh of "
            f"{mesh.size} devices ({mesh.shape}): it is not among "
            f"SHARDED_FAMILIES {SHARDED_FAMILIES}")


def value_and_grad(cfg: ModelConfig, params, batch, *, impl="chunked",
                   remat=True):
    """``(loss, metrics, grads)`` of ``forward_train`` at ``params`` (a
    parameter tree; not modified) on ``batch``: the loss and metrics
    detached, the gradients a tree shaped like ``params``.  On DTensor
    parameters each gradient is laid out as its parameter (a partial
    sum reduced onto its placements), and the loss and metrics are
    plain tensors, the same on every rank."""
    flat, spec = flatten(params)
    with torch.enable_grad():
        live = [t.detach().requires_grad_(True) for t in flat]
        on = {k: v.to(flat[0].device) for k, v in batch.items()}
        loss, metrics = MDL.forward_train(unflatten(spec, live), cfg, on,
                                          impl=impl, remat=remat)
        grads = torch.autograd.grad(loss, live)
    if actctx.is_dtensor(flat[0]):
        grads = [g if tuple(g.placements) == tuple(p.placements)
                 else g.redistribute(p.device_mesh, p.placements)
                 for g, p in zip(grads, flat)]
        loss = loss.full_tensor()
        metrics = {k: v.full_tensor() if actctx.is_dtensor(v) else v
                   for k, v in metrics.items()}
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        unflatten(spec, list(grads))


def make_train_step(cfg: ModelConfig, tc: TrainConfig, *, impl="chunked"):
    """Train step with optional gradient accumulation.

    With ``tc.grad_accum = N`` the batch is split into N microbatches run
    one after the other; gradients accumulate in f32 and are averaged,
    and the loss is the microbatches' mean, as in the reference.  The
    step returns new trees and leaves its inputs as they were."""

    def train_step(params, opt_state, batch):
        with actctx.sharded_ctx(params):
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        accum = tc.grad_accum
        if accum <= 1:
            loss, metrics, grads = value_and_grad(cfg, params, batch,
                                                  impl=impl, remat=tc.remat)
        else:
            mbs = [{k: v.reshape((accum, v.shape[0] // accum)
                                 + tuple(v.shape[1:]))[i]
                    for k, v in batch.items()} for i in range(accum)]
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)
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
        with actctx.sharded_ctx(params.embed):
            return MDL.forward_prefill(params, cfg, batch, impl=impl)

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        with actctx.sharded_ctx(params.embed):
            return MDL.forward_decode(params, cfg, batch["tokens"], cache)

    return decode_step


# ---------------------------------------------------------------------------
# Sharding plans
# ---------------------------------------------------------------------------
def batch_shardings(cfg, shape, mesh, batch_abs):
    """Each batch tensor's B over the data axes that divide it."""
    ba = batch_axes(mesh, shape.global_batch)
    return tree_map(lambda x: Sharding(mesh, (ba,) + (None,) * (x.dim() - 1)),
                    batch_abs)


def cache_shardings(cfg: ModelConfig, mesh, batch: int, ctx_len: int):
    """Cache sharding, as the reference's: B over data axes, cache-seq
    over "model" where the window divides (KV buffers), the encoder's
    ``xk``/``xv`` likewise over ``encoder_seq``, mamba's ``h`` over its
    heads and ``conv`` over its channels where they divide; ``pos``
    replicated."""
    ba = batch_axes(mesh, batch)
    m = mesh.shape["model"]
    segs = []
    for seg in MDL.build_plan(cfg):
        if seg.kind in ("attn", "moe", "shared_attn", "xattn"):
            wlen = min(seg.window if seg.window > 0 else ctx_len, ctx_len)
            sa = "model" if wlen % m == 0 else None
            lead = () if seg.kind == "shared_attn" else (None,)
            c = {"k": Sharding(mesh, (*lead, ba, sa, None, None)),
                 "v": Sharding(mesh, (*lead, ba, sa, None, None))}
            if seg.kind == "xattn":
                xa = "model" if cfg.encoder_seq % m == 0 else None
                c["xk"] = Sharding(mesh, (*lead, ba, xa, None, None))
                c["xv"] = Sharding(mesh, (*lead, ba, xa, None, None))
            segs.append(c)
        elif seg.kind == "mamba":
            ha = "model" if cfg.ssm_nheads % m == 0 else None
            conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
            ca = "model" if conv_dim % m == 0 else None
            segs.append({
                "h": Sharding(mesh, (None, ba, ha, None, None)),
                "conv": Sharding(mesh, (None, ba, None, ca)),
            })
    return {"segments": segs, "pos": replicated_sharding(mesh)}


# ---------------------------------------------------------------------------
# The dry-run: abstract inputs and the plan of one cell
# ---------------------------------------------------------------------------
def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract batch (meta tensors) for one (arch x shape) cell, as the
    reference's:

    train/prefill: {"tokens": (B, S) int32} (+ modality stubs)
    decode:        {"tokens": (B, 1) int32}

    The audio family's ``enc_embeds`` (B, encoder_seq, d) and, but for
    decode, the vlm's ``vis_embeds`` (B, vision_tokens, d) are bf16."""
    B = shape.global_batch
    S = 1 if shape.kind == "decode" else shape.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.family == "audio":
        batch["enc_embeds"] = torch.empty(
            (B, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    if cfg.family == "vlm" and shape.kind != "decode":
        batch["vis_embeds"] = torch.empty(
            (B, cfg.vision_tokens, cfg.d_model), dtype=torch.bfloat16,
            device="meta")
    return batch


def abstract_cache(cfg: ModelConfig, batch: int, ctx_len: int):
    """``init_cache`` on meta tensors."""
    return MDL.init_cache(cfg, batch, ctx_len, device="meta")


def abstract_opt_state(spec_tree):
    """The optimizer state of ``abstract_params(spec_tree)``, on meta."""
    return init_opt_state(abstract_params(spec_tree))


def _storages(tree) -> dict:
    """The storages under a tree's tensors (a Module's parameters
    included; a DTensor's own shard), each once: storage key -> bytes."""
    if isinstance(tree, torch.nn.Module):
        tree = list(tree.parameters())
    ts = [t.to_local() if actctx.is_dtensor(t) else t
          for t in leaves(tree) if isinstance(t, torch.Tensor)]
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in ts}


def tree_bytes(tree) -> int:
    """Bytes of the tensors of a tree, each storage once."""
    return sum(_storages(tree).values())


@dataclass
class CellPlan:
    """What planning one cell counted, all of one device: its FLOPs and
    bytes (``cost``), argument bytes (parameters, optimizer state, cache
    and batch: a sharded plan's own shards), output bytes (returned
    tensors the step allocated) and temp bytes (the counter's peak of
    live storages the step allocated, outputs included), the planning
    run's wall time, and on a mesh of more than one device the
    collectives the step issued (``cost.collectives``: bytes sent and
    calls by op and group size).  Meta tensors take the plain attention
    route (``FlashAttention`` launches the kernel only on CUDA tensors),
    so the temp bytes are the plain route's."""

    cost: Cost
    arg_bytes: int
    out_bytes: int
    temp_bytes: int
    lower_s: float
    attention_route: str = "plain"


def lower_cell(cfg: ModelConfig, shape: ShapeConfig, mesh,
               tc: TrainConfig | None = None, *, impl="chunked"):
    """Plan the step of a cell on abstract inputs: run it once on meta
    tensors under the counter.  Returns ``(plan, meta)``: a
    :class:`CellPlan` and ``{"program": ...}`` (``train_step``,
    ``prefill_step`` or ``serve_step(decode)``), in the order of the
    reference's ``(lowered, meta)``.

    Every cell takes the parameters in the dtypes of ``param_spec``, the
    ones the port holds: train cells with their optimizer state, prefill
    and decode cells as ``launch/serve.py`` serves them.  (The
    reference plans serving on bf16 checkpoints; the port keeps the f32
    weights it drew, so its serving records are of f32 weights.)
    At a mesh of more than one device the step runs once on DTensors
    of meta shards laid out by ``param_shardings``, ``batch_shardings``
    and ``cache_shardings`` over :func:`~repro_torch.launch.mesh.
    planning_mesh`, under the policy the reference picks for the cell
    (train: ``make_train_policy``; prefill and decode:
    ``make_infer_policy``), and the counter counts one device's ops.
    A family outside :data:`SHARDED_FAMILIES` raises there
    (:func:`check_sharded`)."""
    tc = tc or default_train_config(cfg)
    if mesh.size == 1:
        return _plan(cfg, shape, tc, impl, None, None)
    check_sharded(cfg, mesh)
    ba = batch_axes(mesh, shape.global_batch)
    policy = actctx.make_train_policy(mesh, batch_axes=ba) \
        if shape.kind == "train" else \
        actctx.make_infer_policy(mesh, batch_axes=ba)
    with planning_mesh(mesh) as dm, actctx.policy(policy):
        return _plan(cfg, shape, tc, impl, mesh, dm)


def _plan(cfg, shape, tc, impl, mesh, dm):
    """:func:`lower_cell`'s planning run: one device's (``mesh`` None)
    or, on the ``DeviceMesh`` ``dm``, each input a DTensor of its plan."""
    spec_tree = MDL.param_spec(cfg)
    params = abstract_params(spec_tree)
    batch = input_specs(cfg, shape)

    def place(tree, shardings):
        return tree if dm is None else distribute(tree, shardings, dm)

    if mesh is not None:
        param_sh = param_shardings(spec_tree, mesh)
        params = place(params, param_sh)
        batch = place(batch, batch_shardings(cfg, shape, mesh, batch))
    if shape.kind == "train":
        opt = init_opt_state(params)
        args = (params, opt, batch)
        fn, program = make_train_step(cfg, tc, impl=impl), "train_step"
    else:
        model = MDL.Transformer(cfg, params)
        if shape.kind == "prefill":
            args = (model, batch)
            fn, program = make_prefill_step(cfg, impl=impl), "prefill_step"
        else:
            cache = abstract_cache(cfg, shape.global_batch, shape.seq_len)
            if mesh is not None:
                cache = place(cache, cache_shardings(
                    cfg, mesh, shape.global_batch, shape.seq_len))
            args = (model, cache, batch)
            fn, program = make_decode_step(cfg), "serve_step(decode)"
    arg_bytes = sum(tree_bytes(a) for a in args)
    counter = CostCounter()
    t0 = time.perf_counter()
    # no_grad, not inference_mode: under inference_mode the dispatcher
    # hands einsum to the counter whole instead of its bmm
    with counter, torch.set_grad_enabled(shape.kind == "train"):
        out = fn(*args)
    lower_s = time.perf_counter() - t0
    arg_keys = set().union(*(_storages(a) for a in args))
    plan = CellPlan(cost=counter.cost, arg_bytes=arg_bytes,
                    out_bytes=sum(b for k, b in _storages(out).items()
                                  if k not in arg_keys),
                    temp_bytes=int(counter.cost.peak_live_bytes),
                    lower_s=lower_s)
    return plan, {"program": program}
