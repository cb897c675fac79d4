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

The MoE and the SSM run their bodies on each rank's own tokens, as
plain tensors (``models/moe.py``, ``models/mamba2.py``):
:func:`token_layout` keeps a tensor's batch (and sequence) shards,
:func:`spread` shares rows that several ranks hold out among them,
:func:`local_tokens` and :func:`from_tokens` go to and from the plain
tensor, :func:`whole` gives a weight whole on every rank with its
gradient summed over the ranks whose tokens differ, and
:func:`token_sum` adds up per-rank sums.  :func:`relayout` (which
``constrain`` uses too) moves a split from one tensor dim to another by
an all-to-all, or by a gather and a slice where the backend has no
all-to-all for a DTensor (:func:`all_to_all_route`).
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
    return relayout(x, sh.placements())


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


def reduce_partial(x):
    """The DTensor ``x`` with its partial sums all-reduced (replicated),
    its other placements kept; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    if pl == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def gather_tree(tree: dict, keep: dict | None = None) -> dict:
    """:func:`gather` over a dict of dicts of parameters (a layer's),
    but for the leaves ``keep`` names (``{sub-dict: keys}``), which stay
    as they are."""
    keep = keep or {}
    return {name: {k: t if k in keep.get(name, ()) else gather(t)
                   for k, t in sub.items()}
            if isinstance(sub, dict) else gather(sub)
            for name, sub in tree.items()}


def token_layout(x, dims=(0,)) -> tuple:
    """Placements of the DTensor ``x`` that keep its shards of the dims
    ``dims`` (its token dims: the batch, and the sequence where a
    caller can split it) where they split evenly, and make the rest
    whole: a partial sum reduced, any other shards gathered (a decode
    batch split more ways than it has rows included)."""
    from torch.distributed.tensor import Replicate
    sizes, out = list(x.shape), []
    for i, p in enumerate(x.placements):
        n = x.device_mesh.size(i)
        if p.is_shard() and p.dim in dims and sizes[p.dim] % n == 0:
            sizes[p.dim] //= n
            out.append(p)
        else:
            out.append(Replicate())
    return tuple(out)


def splits(layout, mesh, dim: int) -> int:
    """How many ways the placements ``layout`` on ``mesh`` split dim
    ``dim``."""
    import math
    return math.prod(mesh.size(i) for i, q in enumerate(layout)
                     if q.is_shard(dim))


def spread(layout, mesh, rows: int, dim: int = 0) -> tuple:
    """``layout`` with dim ``dim`` also split over each mesh dim that it
    replicates, in order, wherever the ``rows`` of that dim a rank holds
    (under ``layout``) divide: the ranks that held the same tokens then
    share them out, so no work is repeated across them."""
    from torch.distributed.tensor import Shard
    out = []
    for i, q in enumerate(layout):
        if q.is_replicate() and rows % mesh.size(i) == 0:
            q = Shard(dim)
            rows //= mesh.size(i)
        out.append(q)
    return tuple(out)


def all_to_all_route(mesh) -> bool:
    """Whether :func:`relayout` moves a split on ``mesh`` by an
    all-to-all: everywhere but where the collectives are staged through
    host memory (:func:`staged_backend`: gloo on CUDA tensors, where
    DTensor's own all-to-all is not a functional collective to stage and
    hung a probe under torch 2.11), which gathers and slices."""
    import torch.distributed as dist
    return not staged_backend(str(dist.get_backend()), mesh.device_type)


def relayout(x, placements):
    """``x.redistribute`` to ``placements``, a mesh dim whose split moves
    from one tensor dim to another moved by :func:`_move_split`: the
    other mesh dims change first, then each move in turn.  Gradients go
    back the same way."""
    pl, cur = tuple(placements), tuple(x.placements)
    if pl == cur:
        return x
    moves = [i for i, (c, t) in enumerate(zip(cur, pl))
             if c.is_shard() and t.is_shard() and c != t]
    mid = tuple(c if i in moves else t for i, (c, t) in enumerate(zip(cur,
                                                                      pl)))
    if mid != cur:
        x = x.redistribute(x.device_mesh, mid)
    for i in moves:
        x = _move_split(x, i, pl[i])
    return x


def _move_split(x, i: int, dst):
    """The DTensor ``x`` with mesh dim ``i``'s split moved to ``dst``'s
    tensor dim.  By an all-to-all of each rank's local shard where
    :func:`all_to_all_route` says so, no other mesh dim splits either
    tensor dim and both divide evenly; else by a gather on mesh dim
    ``i`` and a local slice (DTensor on a CPU mesh, the planner's,
    falls back to that for an all-to-all of its own)."""
    from torch.distributed.tensor import DTensor, Replicate
    import torch.distributed._functional_collectives as funcol
    mesh, pl = x.device_mesh, list(x.placements)
    src, n = pl[i].dim, mesh.size(i)
    others = pl[:i] + pl[i + 1:]
    if not all_to_all_route(mesh) \
            or any(q.is_shard(src) or q.is_shard(dst.dim) for q in others) \
            or x.shape[src] % n or x.shape[dst.dim] % n:
        pl[i] = Replicate()
        x = x.redistribute(mesh, pl)
        pl[i] = dst
        return x.redistribute(mesh, pl)
    # piece r of this rank's dst dim goes to rank r; what comes back
    # from rank r is its src block r of this rank's dst piece
    send = torch.stack(x.to_local().chunk(n, dim=dst.dim))
    got = funcol.all_to_all_single_autograd(send, None, None,
                                            (mesh, i))
    y = torch.cat(list(got.unbind(0)), dim=src)
    pl[i] = dst
    return DTensor.from_local(y, mesh, pl, run_check=False)


def local_tokens(x, layout, grad_placements=None):
    """This rank's own tokens of the DTensor ``x`` laid out by
    ``layout`` (:func:`token_layout`), as a plain tensor; gradients pass
    back through it, laid out as ``grad_placements`` say (by default as
    ``layout``: a ``Partial`` where each rank's gradient is a share of
    the sum)."""
    return relayout(x, layout).to_local(grad_placements=grad_placements)


def from_tokens(t, like, layout):
    """The plain tensor ``t`` (this rank's tokens) as a DTensor laid out
    by ``layout`` on ``like``'s mesh: the inverse of
    :func:`local_tokens`."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(t, like.device_mesh, layout, run_check=False)


def whole(w, layout):
    """The DTensor parameter ``w`` whole on every rank, as a plain tensor
    used against tokens laid out by ``layout``: its gradient goes back
    as a partial sum over the mesh dims that split the tokens (each rank
    saw its own share) and replicated over the others (every rank saw
    the same).  A plain tensor as it is."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Partial, Replicate
    full = w.redistribute(w.device_mesh,
                          [Replicate()] * w.device_mesh.ndim)
    return full.to_local(grad_placements=[
        Partial() if p.is_shard() else Replicate() for p in layout])


def token_sum(t, like, layout):
    """The sums ``t`` of this rank's tokens (laid out by ``layout`` on
    ``like``'s mesh) added up over every rank's tokens: a DTensor whose
    value, replicated, is the sum over the whole batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    pl = [Partial() if p.is_shard() else Replicate() for p in layout]
    return DTensor.from_local(t, like.device_mesh, pl, run_check=False) \
        .redistribute(like.device_mesh, [Replicate()] * len(pl))


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
