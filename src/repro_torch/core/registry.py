"""Algorithm registry: ``(algo, variant) -> SuperstepProgram`` factory
resolution.

Every engine entry point (``GraphEngine.program``, the launcher)
enumerates programs from here instead of hard-coding algorithm names,
so adding a workload is ONE registration plus an algorithm module.

Registered pairs: ``bfs/bsp``, ``bfs/fast``, ``pagerank/bsp`` and
``pagerank/fast``, with the defaults of the JAX package's registry.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core import bfs as _bfs
from repro_torch.core import pagerank as _pr
from repro_torch.core.graph import GraphShards
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram


@dataclass(frozen=True)
class ProgramSpec:
    """One algorithm x variant entry.

    ``make(g, comm, **params)`` builds the SuperstepProgram against a
    graph's shape metadata and an exchange context; ``params`` beyond
    ``defaults`` are rejected up front so typos fail fast.
    """

    algo: str
    variant: str
    make: Callable[..., SuperstepProgram]
    inputs: tuple[str, ...]              # per-query inputs ("root",) or ()
    defaults: dict = field(default_factory=dict)
    doc: str = ""
    # param overrides for batched builds, carried as data: this package
    # has no batched loop yet
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
              **params) -> SuperstepProgram:
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
