"""Public graph-engine API: registry-driven superstep programs over P
graph parts stacked on one device.

``GraphEngine`` binds a partitioned graph to a device.  The single entry
point is :meth:`GraphEngine.program`:

    eng = GraphEngine(g)                      # cuda, or raise
    prog = eng.program("bfs", "fast", max_levels=32)
    parents, rounds = prog(eng.device_graph(), root)

``program()`` resolves the (algo, variant) pair through
``core/registry.py``, binds the program to the engine's exchange
context, and interns the callable keyed on algorithm + params + graph
shapes + (device, parts) + layout and local-ops mode: repeated calls
return the SAME object.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import localops, registry
from repro_torch.core.graph import GraphShards
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram, run_program


class CompiledProgram:
    """A cached, callable superstep program.

    ``__call__(garr, *inputs)`` runs the shared superstep loop and returns
    ``(*outputs, rounds)``; vertex outputs are ``(P, n_local)`` tensors.
    The local-ops mode that was active when the program was built is the
    one its calls run under, as it is part of the cache key.
    """

    def __init__(self, spec: registry.ProgramSpec, program: SuperstepProgram,
                 mode: str, static_iters: int = 0):
        self.spec = spec
        self.program = program
        self.mode = mode
        self.static_iters = static_iters

    def __call__(self, garr: dict, *inputs):
        with localops.using(self.mode):
            outs, rounds = run_program(self.program, garr, *inputs,
                                       static_iters=self.static_iters)
        return (*outs, rounds)

    def __repr__(self):
        return (f"CompiledProgram({self.program.key}, "
                f"inputs={self.spec.inputs})")


def _default_device() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "GraphEngine runs on CUDA and no CUDA device is available; "
            "pass device='cpu' to run on the CPU")
    return torch.device("cuda")


@dataclass
class GraphEngine:
    g: GraphShards
    device: torch.device | str | None = None
    # "ell" ships the blocked-ELL arrays so localops takes the ELL or
    # kernel path; "coo" withholds them - every program then runs the
    # reference scatter idiom
    layout: str = "ell"
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None \
            else _default_device()
        if self.layout not in ("ell", "coo"):
            raise ValueError(f"layout {self.layout!r} not in ('ell', 'coo')")
        self.comm = StackedComm(self.g.parts, self.device)

    def program(self, algo: str, variant: str | None = None, *,
                static_iters: int = 0, **params) -> CompiledProgram:
        """Resolve, build and cache an algorithm program.

        ``static_iters > 0`` replaces the early-exit loop with a fixed
        trip count.  Params are normalized against the spec's defaults
        so an explicitly spelled default hits the same cache entry.
        """
        spec = registry.get_spec(algo, variant)
        params = {**spec.defaults, **params}
        g = self.g
        mode = localops.get_mode()
        key = (spec.algo, spec.variant, static_iters,
               tuple(sorted(params.items())),
               (g.n, g.n_orig, g.parts, g.n_local, g.e_max),
               g.layout_signature(),
               (str(self.device), g.parts),
               (self.layout, mode))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        compiled = CompiledProgram(spec, spec.build(g, self.comm, **params),
                                   mode, static_iters)
        self._cache[key] = compiled
        return compiled

    # -- helpers -------------------------------------------------------------
    def device_graph(self) -> dict:
        return self.g.device_arrays(self.layout, self.device)

    def gather_vertex_field(self, arr: torch.Tensor) -> np.ndarray:
        """(P, n_local) stacked -> (n_orig,) numpy."""
        return arr.reshape(-1)[: self.g.n_orig].cpu().numpy()

    def scatter_vertex_field(self, arr, dtype=None) -> torch.Tensor:
        """(n_orig,) host values -> (P, n_local) vertex field on the
        engine's device (the inverse of ``gather_vertex_field``).  The
        padded tail is zero-filled."""
        g = self.g
        a = np.asarray(arr)
        if a.ndim != 1 or a.shape[0] < g.n_orig:
            raise ValueError(
                f"vertex field must be 1-D with >= n_orig={g.n_orig} "
                f"entries, got shape {a.shape}")
        dt = np.dtype(dtype) if dtype is not None else a.dtype
        full = np.zeros((g.n,), dt)
        full[: g.n_orig] = a[: g.n_orig]
        return torch.from_numpy(full.reshape(g.parts, g.n_local)) \
            .to(self.device)
