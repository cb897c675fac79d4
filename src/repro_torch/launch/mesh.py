"""Mesh shapes of the JAX package's ``launch/mesh.py``, as plain axis
sizes, and the graph engine's mesh over processes.

Single pod:  (16, 16)    axes ("data", "model")         = 256 devices
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model")  = 512 devices
Local:       (data, model), (1, 1) by default: the one card
Graph:       (parts,)    axis ("parts",): one part a rank of the
             ``torch.distributed`` group, or all parts in one process

A :class:`Mesh` names its axes and their sizes and holds no device.
The LM's sharded plans (``models/params.py::param_shardings``,
``launch/steps.py``) lay tensors out on it; :func:`device_mesh` gives
the ``DeviceMesh`` of the same axes over the ranks of the live
``torch.distributed`` group, and :func:`planning_mesh` one over a fake
group of ``mesh.size`` ranks, on which the dry-run plans a pod's step
in one process without devices.  A launcher of the graph engine names
its deployment with :func:`make_graph_mesh` and hands it to
``GraphEngine(mesh=)``.
"""

from __future__ import annotations

import contextlib
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


def device_mesh(mesh: Mesh, device_type: str = "cuda"):
    """The ``DeviceMesh`` of ``mesh``'s axes over the ranks of the live
    ``torch.distributed`` group (rank r at row-major position r), its
    tensors on ``device_type``.  The group's world size must be
    ``mesh.size``, else this raises, as :func:`make_graph_mesh` does."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("device_mesh needs an initialized "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if world != mesh.size:
        raise ValueError(f"device_mesh({mesh.shape}): the process group has "
                         f"{world} ranks, the mesh {mesh.size} devices")
    return init_device_mesh(device_type, tuple(mesh.shape.values()),
                            mesh_dim_names=mesh.axis_names)


@contextlib.contextmanager
def planning_mesh(mesh: Mesh):
    """A ``DeviceMesh`` of ``mesh``'s axes over a fake process group of
    ``mesh.size`` ranks (``torch.testing``'s ``fake`` backend: its
    collectives move nothing), seen from rank 0: DTensors on it hold
    meta shards, so a step runs at a pod's per-device shapes with no
    device and no memory.  Refuses to start inside a live group, and
    destroys the fake group on exit (``make_graph_mesh`` and the graph
    engine read the global ``torch.distributed`` state)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("planning_mesh starts a fake process group and "
                           "a torch.distributed group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


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
