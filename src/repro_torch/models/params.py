"""Parameter-spec system: declare shapes and logical axes once, derive
materialized parameters from the same tree.

A model definition builds a nested dict (lists for the segments) of
``ParamSpec`` leaves.  ``init_params`` materializes it from a
``torch.Generator``, and ``abstract_params`` gives its meta-tensor
stand-ins, which the dry-run plans against.  ``params_from_arrays``
builds the model from the JAX package's parameter tree, and
``params_to_arrays`` gives a model's or a parameter tree's values back
as that tree, so tests can hold the two against each other on the same
weights both ways.

The sharding half resolves the logical axes onto a mesh's axes as the
reference does (:data:`DEFAULT_RULES`, :func:`resolve_axes`,
:func:`param_shardings`): each leaf gets a :class:`Sharding`, the
reference's ``NamedSharding``, which gives its shard shape and the
DTensor placements of a ``DeviceMesh`` over the same axes.
:func:`distribute` puts a tree of full tensors (every rank holding the
same values) onto a ``DeviceMesh`` as DTensors, each rank keeping its
own shard; on meta tensors it builds a planning run's shards.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axis name per dim (or None)
    init: str = "normal"              # normal | zeros | ones | arange_neg
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec(shape, axes, init="normal", scale=0.02,
         dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def tree_map_specs(fn: Callable, tree):
    """Apply ``fn`` to every ParamSpec leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_specs(fn, v) for v in tree)
    return fn(tree)


def param_count(spec_tree) -> int:
    if isinstance(spec_tree, dict):
        return sum(param_count(v) for v in spec_tree.values())
    if isinstance(spec_tree, (list, tuple)):
        return sum(param_count(v) for v in spec_tree)
    return math.prod(spec_tree.shape)


def init_params(spec_tree, generator: torch.Generator,
                device: torch.device | str):
    """Materialize a spec tree into real fp32 parameters on ``device``:
    normal x ``scale``, zeros, ones, or ``arange_neg`` (mamba's ``A_log``:
    ``log(1 .. n)`` along the last axis).  ``generator`` lives on
    ``device``; its draws follow the tree's order."""

    def make(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "arange_neg":
            base = torch.log(torch.arange(1, s.shape[-1] + 1,
                                          dtype=torch.float32, device=device))
            return base.expand(s.shape).to(s.dtype).clone()
        if s.init != "normal":
            raise ValueError(f"unknown init {s.init!r}")
        return torch.randn(s.shape, generator=generator, dtype=torch.float32,
                           device=device).mul_(s.scale).to(s.dtype)

    return tree_map_specs(make, spec_tree)


def abstract_params(spec_tree):
    """The spec tree as meta tensors (shapes and dtypes, no storage), the
    role of the reference's ShapeDtypeStruct tree; no generator is
    involved and nothing is allocated."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree)


def params_from_arrays(cfg, tree):
    """The port's ``Transformer`` on the CPU holding the values of the JAX
    package's parameter tree ``tree`` (numpy arrays, the layers of a
    segment stacked on axis 0; ``{}`` for a shared-attention segment,
    whose block is ``tree["shared"]``)."""
    from repro_torch.models.model import Transformer

    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [convert(v) for v in t]
        return torch.from_numpy(np.array(t, dtype=np.float32))

    return Transformer(cfg, convert(tree))


def params_to_arrays(cfg, model):
    """The JAX package's parameter tree (float32 numpy arrays, the layers
    of a segment stacked on axis 0) holding the values of the
    ``Transformer`` ``model``, every family's blocks, its shared block
    and its encoder included: the inverse of :func:`params_from_arrays`."""

    def arr(t):
        return t.detach().float().cpu().numpy()

    def block(b):
        return {name: {k: arr(t) for k, t in sub.items()}
                for name, sub in b.named_children()}

    def stacked(blocks):
        if len(blocks) == 0:
            return {}
        return {name: {k: np.stack([arr(getattr(b, name)[k])
                                    for b in blocks]) for k in sub}
                for name, sub in blocks[0].named_children()}

    tree = {"embed": arr(model.embed),
            "final_norm": {k: arr(t) for k, t in model.final_norm.items()}}
    if hasattr(model, "lm_head"):
        tree["lm_head"] = arr(model.lm_head)
    tree["segments"] = [stacked(blocks) for blocks in model.segments]
    if hasattr(model, "shared"):
        tree["shared"] = block(model.shared)
    if hasattr(model, "encoder"):
        enc = model.encoder
        tree["encoder"] = {
            "segments": [stacked(blocks) for blocks in enc.segments],
            "final_norm": {k: arr(t) for k, t in enc.final_norm.items()}}
    return tree


# ---------------------------------------------------------------------------
# Logical-axis -> mesh-axis resolution
# ---------------------------------------------------------------------------

# The reference's rules for the production 2D/3D mesh: "embed" shards
# parameters over the data axis (ZeRO-3), the tensor-parallel dims over
# "model".
DEFAULT_RULES: dict[str, Optional[str]] = {
    "embed": "data",        # FSDP axis (ZeRO-3)
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ffn": "model",
    "moe_ffn": "data",      # 2-D expert sharding: no weight gathers
    "experts": "model",     # expert parallelism
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "enc_seq": None,
}

# a dim's entry of a partition spec: unsharded, one mesh axis, or several
# (major to minor, as ``PartitionSpec(("pod", "data"))``)
AxisEntry = Union[None, str, tuple]


def _entry_axes(entry: AxisEntry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh`` (``launch/mesh.Mesh``): ``spec`` has
    one entry per dim, as the reference's ``PartitionSpec`` (trailing
    dims past its end are unsharded; ``()`` replicates)."""

    mesh: object
    spec: tuple = ()

    def placements(self) -> list:
        """DTensor placements over the mesh's axes in order: ``Shard(d)``
        on each axis that splits dim d, else ``Replicate()``.  An entry of
        several axes splits its dim by each in turn, major first, as a
        DTensor does over mesh dims in order."""
        from torch.distributed.tensor import Replicate, Shard
        dims = {a: d for d, e in enumerate(self.spec) for a in _entry_axes(e)}
        return [Shard(dims[a]) if a in dims else Replicate()
                for a in self.mesh.axis_names]

    def shard_shape(self, shape) -> tuple:
        """One device's shard of a tensor of ``shape``: each dim over the
        product of its axes' sizes (which must divide it)."""
        sizes = self.mesh.shape
        out = list(shape)
        for d, e in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _entry_axes(e))
            if out[d] % n:
                raise ValueError(f"dim {d} of {tuple(shape)} does not divide "
                                 f"over {e} ({n})")
            out[d] //= n
        return tuple(out)



def resolve_axes(s: ParamSpec, rules: dict, mesh) -> tuple:
    """Map logical axes to mesh axes, as the reference does.

    A dim that is not a multiple of its mesh axis's size is replicated
    (qwen2.5's 40 heads on a 16-wide model axis, say), and a mesh axis
    appears at most once in the result: a later dim that resolves to it
    again is replicated."""
    shape = mesh.shape
    out = []
    for dim, name in zip(s.shape, s.axes):
        mesh_axis = rules.get(name) if name else None
        if mesh_axis is None or mesh_axis not in shape \
                or dim % shape[mesh_axis]:
            out.append(None)
        else:
            out.append(mesh_axis)
    seen: set = set()
    dedup = []
    for a in out:
        dedup.append(None if a in seen else a)
        if a is not None:
            seen.add(a)
    return tuple(dedup)


def param_shardings(spec_tree, mesh, rules: Optional[dict] = None):
    """The :class:`Sharding` tree matching the spec tree."""
    rules = dict(DEFAULT_RULES if rules is None else rules)
    return tree_map_specs(
        lambda s: Sharding(mesh, resolve_axes(s, rules, mesh)), spec_tree)


def replicated_sharding(mesh) -> Sharding:
    return Sharding(mesh, ())


def place(t: torch.Tensor, device_mesh, placements):
    """The full tensor ``t`` (the same on every rank) as a DTensor on
    ``device_mesh`` with ``placements``: this rank keeps a contiguous
    copy of its own shard, each mesh dim splitting its tensor dim in
    turn (major first, as DTensor and the reference's multi-axis
    entries do); a meta ``t`` gives a meta shard.  Nothing is
    communicated."""
    from torch.distributed.tensor import DTensor
    local = t
    coords = device_mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            n, d = device_mesh.size(i), p.dim
            if local.shape[d] % n:
                raise ValueError(f"dim {d} of {tuple(t.shape)} does not "
                                 f"divide over {n} ranks")
            size = local.shape[d] // n
            local = local.narrow(d, coords[i] * size, size)
    # a copy even where the slice is contiguous: a view would keep the
    # whole tensor's storage alive
    local = (torch.empty(local.shape, dtype=t.dtype, device="meta")
             if t.is_meta else local.clone(
                 memory_format=torch.contiguous_format))
    return DTensor.from_local(local, device_mesh, list(placements),
                              run_check=False, shape=t.shape,
                              stride=t.stride())


def distribute(tree, shardings, device_mesh):
    """Each tensor of ``tree`` placed (:func:`place`) on ``device_mesh``
    by the matching :class:`Sharding` of ``shardings`` (a tree of the
    same structure, or one Sharding for every leaf).  A non-tensor leaf
    (a cache's ``pos``) is kept."""
    from repro_torch.tree import flatten, leaves, unflatten
    flat, spec = flatten(tree)
    shs = (leaves(shardings) if not isinstance(shardings, Sharding)
           else [shardings] * len(flat))
    if len(shs) != len(flat):
        raise ValueError(f"{len(shs)} shardings for {len(flat)} leaves")
    return unflatten(spec, [
        place(t, device_mesh, sh.placements())
        if isinstance(t, torch.Tensor) else t for t, sh in zip(flat, shs)])
