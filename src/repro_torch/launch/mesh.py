"""Mesh shapes of the JAX package's ``launch/mesh.py``, as plain axis
sizes.

Single pod:  (16, 16)    axes ("data", "model")         = 256 devices
Multi-pod:   (2, 16, 16) axes ("pod", "data", "model")  = 512 devices
Local:       (data, model), (1, 1) by default: the one card

Pure Python: a :class:`Mesh` names its axes and their sizes and holds no
device.  The one-card dry-run plans on ``make_local_mesh()``; a larger
mesh waits for the multi-card slice (ROADMAP.md, LM queue L6).
"""

from __future__ import annotations

import math
from dataclasses import dataclass


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
