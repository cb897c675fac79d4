"""Mesh shapes of the JAX package's ``launch/mesh.py``, as plain axis
sizes, and the graph engine's mesh over processes.

Single pod:  (16, 16)    axes ("data", "model")         = 256 devices
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model")  = 512 devices
Local:       (data, model), (1, 1) by default: the one card
Graph:       (parts,)    axis ("parts",): one part a rank of the
             ``torch.distributed`` group, or all parts in one process

A :class:`Mesh` names its axes and their sizes and holds no device.
The one-card LM dry-run plans on ``make_local_mesh()``; the LM's sharded
plans over a larger mesh wait for ROADMAP.md's LM item L6b.  A launcher
of the graph engine names its deployment with :func:`make_graph_mesh`
and hands it to ``GraphEngine(mesh=)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from repro_torch.core.partitioned import GraphMesh


@dataclass(frozen=True)
class Mesh:
    """Axis names and sizes, in order (``shape`` as ``jax.sharding.Mesh``
    gives it: ``{axis: size}``)."""

    axes: tuple[tuple[str, int], ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(self.axes)

    @property
    def axis_names(self) -> tuple[str, ...]:
        return tuple(a for a, _ in self.axes)

    @property
    def size(self) -> int:
        return math.prod(n for _, n in self.axes)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh((("pod", 2), ("data", 16), ("model", 16)))
    return Mesh((("data", 16), ("model", 16)))


def make_local_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A (data, model) mesh; (1, 1) is the one card."""
    return Mesh((("data", data), ("model", model)))


def make_graph_mesh(parts: int) -> GraphMesh:
    """The mesh the caller launched, named explicitly: with an
    initialized ``torch.distributed`` process group, its ranks, one part
    each (``parts`` must be the world size, else this raises); with
    none, the one-process mesh of ``parts`` stacked parts.  A
    ``GraphEngine`` given no mesh takes the one-process mesh."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return GraphMesh(int(parts))
    world = dist.get_world_size()
    if parts != world:
        raise ValueError(
            f"make_graph_mesh({parts}): the process group has {world} "
            f"ranks, and the graph mesh holds one part a rank")
    return GraphMesh(int(parts), distributed=True)


def batch_axes(mesh: Mesh, batch: int):
    """Largest prefix of (pod, data) that divides the batch."""
    shape = mesh.shape
    chosen: list[str] = []
    size = 1
    for a in ("pod", "data"):
        if a in shape and batch % (size * shape[a]) == 0:
            chosen.append(a)
            size *= shape[a]
    if not chosen:
        return None
    return tuple(chosen) if len(chosen) > 1 else chosen[0]
