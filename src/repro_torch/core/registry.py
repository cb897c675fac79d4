"""Algorithm registry: ``(algo, variant) -> SuperstepProgram`` factory
resolution.

Every engine entry point (``GraphEngine.program``, the launcher)
enumerates programs from here instead of hard-coding algorithm names,
so adding a workload is ONE registration plus an algorithm module.

Registered pairs, in the JAX package's order and with its defaults:
``bfs/bsp``, ``bfs/fast``, ``pagerank/bsp``, ``pagerank/fast``,
``sssp``, ``cc``, ``triangles``, ``kcore`` and ``betweenness``
(single-variant algorithms use the ``"default"`` variant and may be
addressed by bare algo name).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core import betweenness as _bc
from repro_torch.core import bfs as _bfs
from repro_torch.core import cc as _cc
from repro_torch.core import kcore as _kcore
from repro_torch.core import pagerank as _pr
from repro_torch.core import sssp as _sssp
from repro_torch.core import triangles as _tri
from repro_torch.core.graph import GraphShards
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import PhasedProgram, SuperstepProgram


@dataclass(frozen=True)
class ProgramSpec:
    """One algorithm x variant entry.

    ``make(g, comm, **params)`` builds the SuperstepProgram against a
    graph's shape metadata and an exchange context; ``params`` beyond
    ``defaults`` are rejected up front so typos fail fast.
    """

    algo: str
    variant: str
    make: Callable[..., SuperstepProgram | PhasedProgram]
    inputs: tuple[str, ...]              # per-query inputs ("root",) or ()
    defaults: dict = field(default_factory=dict)
    doc: str = ""
    # largest padded vertex count the implementation is sized for, or 0
    # for unbounded.  The launcher skips over-budget programs (the
    # O(n^2/P) triangle-counting bitmap).
    n_budget: int = 0
    # param overrides for batched (batch=B) builds, e.g. bfs/fast pins
    # direction="pull" as the JAX package's vmapped build must.
    # Explicit caller params always win.
    batch_defaults: dict = field(default_factory=dict)

    @property
    def key(self) -> str:
        return (self.algo if self.variant == "default"
                else f"{self.algo}/{self.variant}")

    @property
    def label(self) -> str:
        """Filesystem/record-safe spelling: "bfs_fast"."""
        return program_label(self.algo, self.variant)

    def build(self, g: GraphShards, comm: StackedComm,
              **params) -> SuperstepProgram | PhasedProgram:
        unknown = set(params) - set(self.defaults)
        if unknown:
            raise TypeError(
                f"{self.key}: unknown params {sorted(unknown)}; "
                f"accepted: {sorted(self.defaults)}")
        merged = {**self.defaults, **params}
        return self.make(g, comm, **merged)


def program_label(algo: str, variant: str) -> str:
    """Canonical "algo_variant" label ("bfs_fast"; bare algo for the
    default-only variant) used in records and result keys."""
    return algo if variant == "default" else f"{algo}_{variant}"


_REGISTRY: dict[tuple[str, str], ProgramSpec] = {}
_DEFAULT_VARIANT: dict[str, str] = {}
_EXPLICIT_DEFAULT: set[str] = set()


def register(spec: ProgramSpec, *, default: bool = False) -> ProgramSpec:
    """Register an (algo, variant) pair.

    The algo's FIRST registered variant becomes its implicit default
    until some variant claims ``default=True`` explicitly; a second
    explicit claim for the same algo raises.
    """
    key = (spec.algo, spec.variant)
    if key in _REGISTRY:
        raise ValueError(f"duplicate program registration: {key}")
    if default and spec.algo in _EXPLICIT_DEFAULT:
        raise ValueError(
            f"{spec.algo}: default variant already claimed by "
            f"{_DEFAULT_VARIANT[spec.algo]!r}; cannot also claim "
            f"{spec.variant!r}")
    _REGISTRY[key] = spec
    if default:
        _EXPLICIT_DEFAULT.add(spec.algo)
        _DEFAULT_VARIANT[spec.algo] = spec.variant
    elif spec.algo not in _DEFAULT_VARIANT:
        _DEFAULT_VARIANT[spec.algo] = spec.variant
    return spec


def default_variant(algo: str) -> str:
    """The variant bare-name resolution picks for ``algo``."""
    return _DEFAULT_VARIANT[algo]


def registered_keys() -> list[str]:
    """Human-readable registered program keys: ``["bfs/bsp", ...]``."""
    return [spec.key for spec in _REGISTRY.values()]


def get_spec(algo: str, variant: str | None = None) -> ProgramSpec:
    """Resolve an (algo, variant) pair; ``"bfs/fast"`` shorthand works.

    Unknown names raise a ``KeyError`` that lists every registered key.
    """
    if variant is None and "/" in algo:
        algo, variant = algo.split("/", 1)
    if variant is None:
        if algo not in _DEFAULT_VARIANT:
            raise KeyError(
                f"unknown algorithm {algo!r}; registered programs: "
                f"{', '.join(registered_keys())}")
        variant = _DEFAULT_VARIANT[algo]
    key = (algo, variant)
    if key not in _REGISTRY:
        raise KeyError(
            f"unknown program {algo!r}/{variant!r}; registered programs: "
            f"{', '.join(registered_keys())}")
    return _REGISTRY[key]


def available() -> list[tuple[str, str]]:
    """All registered (algo, variant) pairs, registration order."""
    return list(_REGISTRY)


# ---------------------------------------------------------------------------
# Built-in programs.  Factories receive the GraphShards for its shape
# and blocked-ELL metadata only; the device arrays arrive per call
# through the graph dict.
# ---------------------------------------------------------------------------

register(ProgramSpec(
    algo="bfs", variant="bsp",
    make=lambda g, comm, **p: _bfs.bfs_bsp_program(g, comm, **p),
    inputs=("root",), defaults={"max_levels": 64},
    doc="level-synchronous push BFS; full parent-proposal exchange "
        "(the rigid-barrier Boost/PBGL baseline)"))

register(ProgramSpec(
    algo="bfs", variant="fast",
    make=lambda g, comm, **p: _bfs.bfs_fast_program(g, comm, **p),
    inputs=("root",),
    defaults={"max_levels": 64, "pull_threshold": 0.02,
              "direction": "adaptive"},
    batch_defaults={"direction": "pull"},
    doc="direction-optimizing BFS with bit-packed frontier exchange "
        "(the HPX-adapted implementation)"), default=True)

register(ProgramSpec(
    algo="pagerank", variant="bsp",
    make=lambda g, comm, **p: _pr.pagerank_bsp_program(g, comm, **p),
    inputs=(), defaults={"iters": 50, "tol": 1e-6},
    doc="pull PageRank with full contribution all-gather (ghost "
        "replication baseline)"))

register(ProgramSpec(
    algo="pagerank", variant="fast",
    make=lambda g, comm, **p: _pr.pagerank_fast_program(g, comm, **p),
    inputs=(),
    defaults={"iters": 50, "tol": 1e-6, "compress": True,
              "switch_factor": 1e3, "err_every": 5},
    doc="push-aggregate PageRank: fused reduce-scatter + adaptive bf16 "
        "error-feedback compression"),
    default=True)

register(ProgramSpec(
    algo="sssp", variant="default",
    make=lambda g, comm, **p: _sssp.sssp_program(g, comm, **p),
    inputs=("root",), defaults={"max_rounds": 64, "weight_scale": 1.0},
    doc="frontier-pruned Bellman-Ford with MIN-combine exchange; "
        "weight_scale uniformly scales the synthesized weights (must "
        "be finite and positive — serve admission rejects the rest)"),
    default=True)

register(ProgramSpec(
    algo="cc", variant="default",
    make=lambda g, comm, **p: _cc.cc_program(g, comm, **p),
    inputs=(), defaults={"max_rounds": 64},
    doc="label propagation over both edge directions"), default=True)

register(ProgramSpec(
    algo="triangles", variant="default",
    make=lambda g, comm, **p: _tri.triangles_program(g.n, g.n_local, comm,
                                                     **p),
    inputs=(), defaults={},
    doc="rotation triangle counting: bit-packed neighbor-set exchange "
        "(ppermute ring, P supersteps), intersection as masked matmul",
    n_budget=1 << 13), default=True)

register(ProgramSpec(
    algo="kcore", variant="default",
    make=lambda g, comm, **p: _kcore.kcore_program(g, comm, **p),
    inputs=(), defaults={"max_rounds": 512},
    doc="iterative peeling (threshold form) with fused degree-decrement "
        "exchange; degeneracy rides as a scalar output"), default=True)

register(ProgramSpec(
    algo="betweenness", variant="default",
    make=lambda g, comm, **p: _bc.betweenness_program(g, comm, **p),
    inputs=("root",), defaults={"max_levels": 64},
    doc="Brandes single-source dependencies: path-counting forward BFS "
        "then a dependency-accumulation backward sweep (the first "
        "two-phase program; sum over batched sources for centrality)"),
    default=True)
