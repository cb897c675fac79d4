"""Activation-sharding context, and the per-rank pieces of a sharded step.

The model code is mesh-agnostic; drivers (train, the dry-run) install a
sharding policy here before running a step on DTensors.  ``constrain(x,
kind)`` redistributes a DTensor to the policy's layout for ``kind`` (the
role of the reference's ``with_sharding_constraint``) and is the
identity with no policy, on a plain tensor, or where the layout already
holds, so one-device runs are unaffected.

Kinds (a policy maps each to a ``Sharding`` by ndim, or to a rule that
picks one from the tensor):
  "resid"  -- (B, S, D) residual stream.  The train policy shards S over
              "model" (Megatron-style sequence parallelism).
  "batch"  -- (B, ...) batch-leading tensors; B over the data axes.
  "heads"  -- (B, S, H, D) attention tensors: B over the data axes, H over
              "model" (replicated heads when H is under the axis size).
  "ffn"    -- (B, S, F) hidden activations: F over "model".

The rest is what DTensor does not do the way the reference's GSPMD
does: :func:`gather` all-gathers a parameter's data-axis shards at its
use (explicit ZeRO-3: left sharded, DTensor would move the activations
onto the contracted dim instead); :func:`per_shard` runs attention on
each rank's own (B, H) slice, so the flash kernel never sees a DTensor;
:func:`scatter_partial` reduces a partial sum at once (decode's
embedding lookup: torch 2.11 can reduce its masked partial sum only
once); :func:`sharded_ctx` lets plain tensors (positions, masks, schedule
scalars) meet DTensors as replicated values; :class:`StagedCollectives`
moves the collectives a DTensor issues on CUDA tensors through pinned
host memory where the backend moves host memory only (gloo).
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_POLICY: Optional[dict] = None

# the mesh axes a batch and a ZeRO-3 parameter shard over
DATA_AXES = ("pod", "data")


def set_policy(policy: Optional[dict]):
    global _POLICY
    _POLICY = policy


@contextlib.contextmanager
def policy(p: Optional[dict]):
    global _POLICY
    old = _POLICY
    _POLICY = p
    try:
        yield
    finally:
        _POLICY = old


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def layout(x, kind: str) -> Optional[Sharding]:
    """The policy's :class:`Sharding` for ``x`` of ``kind``, or None."""
    if _POLICY is None:
        return None
    sh = _POLICY.get(kind)
    if sh is None:
        return None
    if callable(sh):
        return sh(x)
    return sh.get(x.ndim)


def constrain(x, kind: str):
    if _POLICY is None or not is_dtensor(x):
        return x
    sh = layout(x, kind)
    if sh is None:
        return x
    placements = tuple(sh.placements())
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def _heads_rule(mesh, batch_axes):
    """(B, S, H, D) attention tensors: B over batch axes, H over model.

    Falls back to replicated heads when H < model-axis size (tiny models)
    to avoid mostly-padding shards.
    """
    from repro_torch.models.params import Sharding
    m = mesh.shape["model"]

    def rule(x):
        if x.ndim != 4:
            return None
        ha = "model" if x.shape[2] >= m else None
        return Sharding(mesh, (batch_axes, None, ha, None))

    return rule


def _ffn_rule(mesh, batch_axes):
    """(B, S, F) hidden activations: F over model (Megatron pattern:
    gather the sequence, shard the hidden width)."""
    from repro_torch.models.params import Sharding
    m = mesh.shape["model"]

    def rule(x):
        if x.ndim != 3:
            return None
        fa = "model" if x.shape[2] >= m else None
        return Sharding(mesh, (batch_axes, None, fa))

    return rule


def _policy(mesh, ba, seq_axis):
    from repro_torch.models.params import Sharding
    return {
        "resid": {3: Sharding(mesh, (ba, seq_axis, None))},
        "batch": {2: Sharding(mesh, (ba, None)),
                  3: Sharding(mesh, (ba, None, None))},
        "heads": _heads_rule(mesh, ba),
        "ffn": _ffn_rule(mesh, ba),
    }


def make_train_policy(mesh, *, batch_axes, seq_axis="model"):
    """Residual stream (B,S,D): B over batch_axes, S over seq_axis (SP)."""
    return _policy(mesh, batch_axes if batch_axes else None, seq_axis)


def make_infer_policy(mesh, *, batch_axes):
    return _policy(mesh, batch_axes if batch_axes else None, None)


# ---------------------------------------------------------------------------
# Per-rank pieces of a sharded step
# ---------------------------------------------------------------------------
def gather(t):
    """A parameter at its use: its shards over the data axes all-gathered,
    its "model" shards kept (explicit ZeRO-3).  Under autograd the
    gradient goes back as a reduce-scatter onto the parameter's own
    placements.  A plain tensor, or one with no data-axis shard, is
    returned as it is."""
    if not is_dtensor(t):
        return t
    from torch.distributed.tensor import Replicate, Shard
    names = t.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in DATA_AXES and isinstance(p, Shard) else p
               for n, p in zip(names, t.placements))
    if pl == tuple(t.placements):
        return t
    return t.redistribute(t.device_mesh, pl)


def unsplit(x, dim: int):
    """The DTensor ``x`` with dim ``dim`` whole on every rank (its shards
    over any mesh axis all-gathered), its other placements kept; a
    plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_shard(dim) else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def scatter_partial(x, dim: int):
    """The DTensor ``x`` with its partial sums reduce-scattered onto dim
    ``dim``, its other placements kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Shard
    pl = tuple(Shard(dim) if p.is_partial() else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def gather_tree(tree: dict) -> dict:
    """:func:`gather` over a dict of dicts of parameters (a layer's)."""
    return {name: {k: gather(t) for k, t in sub.items()}
            if isinstance(sub, dict) else gather(sub)
            for name, sub in tree.items()}


def per_shard(fn, *xs):
    """``fn`` on each rank's own shards of the DTensors ``xs``, which
    share one layout that splits dims 0 and 2 only ((B, S, H, D):
    batch and heads), its result wrapped back in that layout; on plain
    tensors, ``fn(*xs)``.  Gradients pass through (``to_local`` and
    ``from_local`` are differentiable)."""
    if not is_dtensor(xs[0]):
        return fn(*xs)
    from torch.distributed.tensor import DTensor, Shard
    mesh, pl = xs[0].device_mesh, tuple(xs[0].placements)
    for x in xs:
        if not is_dtensor(x) or tuple(x.placements) != pl:
            raise ValueError("per_shard needs DTensors of one layout, got "
                             f"{[getattr(x, 'placements', None) for x in xs]}")
    if not all(isinstance(p, Shard) and p.dim in (0, 2) or p.is_replicate()
               for p in pl):
        raise ValueError(f"per_shard splits batch and heads only, not {pl}")
    out = fn(*(x.to_local() for x in xs))
    return DTensor.from_local(out, mesh, pl, run_check=False)


@contextlib.contextmanager
def sharded_ctx(tree):
    """Inside, plain tensors meet DTensors as replicated values (every
    rank holds the same positions, masks and scalars), when ``tree``'s
    first leaf is a DTensor; otherwise nothing changes."""
    from repro_torch.tree import leaves
    first = leaves(tree)[0]
    if not is_dtensor(first):
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication():
        yield


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


# the collectives DTensor issues (``torch.distributed._functional_
# collectives``), each staged whole when the backend moves host memory
FUNCOL_OPS = ("all_gather_into_tensor", "reduce_scatter_tensor",
              "all_reduce", "all_to_all_single")


def staged_backend(backend: str, device_type: str) -> bool:
    """Whether a collective of ``backend`` on ``device_type`` tensors
    goes through pinned host memory: gloo on CUDA tensors (under torch
    2.11 each of :data:`FUNCOL_OPS` on a CUDA tensor ends its process
    with SIGSEGV; gloo moves host memory in any case)."""
    return backend == "gloo" and device_type == "cuda"


class StagedCollectives(TorchDispatchMode):
    """Runs each functional collective on CUDA tensors on pinned host
    copies of them: the payload is copied out, the collective runs on
    the host copy and is waited for, and the result is copied back to
    the card.  :attr:`staged` counts the ops it staged by name.  Enter
    it only where :func:`staged_backend` says so; the choice is made by
    backend and device, never on a failure."""

    def __init__(self):
        super().__init__()
        self.staged: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented       # DTensor desugars to local ops first
        kwargs = kwargs or {}
        name = func.name()
        if not name.startswith("_c10d_functional::") \
                or name.split("::")[1] not in FUNCOL_OPS:
            return func(*args, **kwargs)
        dev = args[0].device
        if dev.type != "cuda":
            return func(*args, **kwargs)
        op = name.split("::")[1]
        self.staged[op] = self.staged.get(op, 0) + 1
        host = torch.empty(args[0].shape, dtype=args[0].dtype,
                           pin_memory=True)
        host.copy_(args[0])
        out = torch.ops._c10d_functional.wait_tensor(
            func(host, *args[1:], **kwargs))
        return out.to(dev)
