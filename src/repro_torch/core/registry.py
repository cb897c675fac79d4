"""Algorithm registry: ``(algo, variant) -> SuperstepProgram`` factory
resolution.

Every engine entry point (``GraphEngine.program``, the launcher)
enumerates programs from here instead of hard-coding algorithm names,
so adding a workload is ONE registration plus an algorithm module.

Registered pairs, in the JAX package's order and with its defaults:
``bfs/bsp``, ``bfs/fast``, ``pagerank/bsp``, ``pagerank/fast``,
``sssp``, ``cc``, ``triangles``, ``kcore``, ``pagerank/warm``,
``cc/incremental``, ``kcore/incremental``, ``betweenness``,
``bfs/async``, ``pagerank/async``, ``cc/async`` and ``sssp/async``
(single-variant algorithms use the ``"default"`` variant and may be
addressed by bare algo name).

Inputs come in KINDS: ``"scalar"`` per-query values (a root vertex,
batchable) and ``"vertex_i32"`` / ``"vertex_f32"`` whole vertex fields
(the seeds of the incremental variants, never batched).  Every spec
carries an ``exec_mode``: ``"bsp"`` programs run the barrier-per-round
loop, ``"async"`` programs the double-buffered ``run_program_async``
(``core/superstep.py``); :func:`mode_variant` resolves an algo by mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from repro_torch.core import betweenness as _bc
from repro_torch.core import bfs as _bfs
from repro_torch.core import cc as _cc
from repro_torch.core import incremental as _inc
from repro_torch.core import kcore as _kcore
from repro_torch.core import pagerank as _pr
from repro_torch.core import sssp as _sssp
from repro_torch.core import triangles as _tri
from repro_torch.core.graph import GraphShards
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    PhasedProgram, SuperstepProgram

INPUT_KINDS = ("scalar", "vertex_i32", "vertex_f32")
EXEC_MODES = ("bsp", "async")


@dataclass(frozen=True)
class IncrementalSpec:
    """Dynamic-graph metadata of a seeded program variant.

    ``of`` names the algorithm this variant refreshes; ``seed_output`` is
    the output of ``of``'s programs whose previous-epoch value seeds this
    one; ``mutations`` states the mutation kinds the WARM seed stays
    exact under ("insert", "delete" or "any").  It gates only the seed
    choice: every incremental program is exact from its cold seed
    (``incremental.cold_seed``).
    """

    of: str
    seed_output: str
    mutations: str


@dataclass(frozen=True)
class ProgramSpec:
    """One algorithm x variant entry.

    ``make(g, comm, **params)`` builds the program against a graph's
    shape metadata and an exchange context; ``params`` beyond
    ``defaults`` are rejected up front so typos fail fast.
    """

    algo: str
    variant: str
    make: Callable[..., SuperstepProgram | PhasedProgram
                   | AsyncSuperstepProgram]
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
    # one kind per entry of ``inputs``; all "scalar" when left empty
    input_kinds: tuple[str, ...] = ()
    # set on the seeded dynamic-graph variants
    incremental: IncrementalSpec | None = None
    # the loop the built program runs under: "bsp" or "async"
    exec_mode: str = "bsp"

    def __post_init__(self):
        if not self.input_kinds:
            object.__setattr__(self, "input_kinds",
                               ("scalar",) * len(self.inputs))
        if len(self.input_kinds) != len(self.inputs):
            raise ValueError(
                f"{self.algo}/{self.variant}: {len(self.inputs)} inputs "
                f"but {len(self.input_kinds)} input_kinds")
        bad = set(self.input_kinds) - set(INPUT_KINDS)
        if bad:
            raise ValueError(
                f"{self.algo}/{self.variant}: unknown input kinds "
                f"{sorted(bad)}; valid: {INPUT_KINDS}")
        if self.exec_mode not in EXEC_MODES:
            raise ValueError(
                f"{self.algo}/{self.variant}: exec_mode "
                f"{self.exec_mode!r} not in {EXEC_MODES}")

    @property
    def key(self) -> str:
        return (self.algo if self.variant == "default"
                else f"{self.algo}/{self.variant}")

    @property
    def label(self) -> str:
        """Filesystem/record-safe spelling: "bfs_fast"."""
        return program_label(self.algo, self.variant)

    def build(self, g: GraphShards, comm: StackedComm, **params) \
            -> SuperstepProgram | PhasedProgram | AsyncSuperstepProgram:
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


def variants(algo: str) -> list[str]:
    return [v for (a, v) in _REGISTRY if a == algo]


def async_pairs() -> list[tuple[str, str]]:
    """All registered pairs whose programs run the async loop."""
    return [k for k, spec in _REGISTRY.items() if spec.exec_mode == "async"]


def mode_variant(algo: str, exec_mode: str) -> str | None:
    """The variant bare-``algo`` resolution picks under ``exec_mode``:
    the algo's default variant for ``"bsp"``, its first registered async
    variant for ``"async"`` (``None`` when the algo has none, e.g.
    ``triangles``, whose rotation is barrier-shaped)."""
    if exec_mode not in EXEC_MODES:
        raise ValueError(f"exec_mode {exec_mode!r} not in {EXEC_MODES}")
    if exec_mode == "bsp":
        v = _DEFAULT_VARIANT.get(algo)
        return v if v is not None \
            and _REGISTRY[(algo, v)].exec_mode == "bsp" else None
    for (a, v), spec in _REGISTRY.items():
        if a == algo and spec.exec_mode == "async":
            return v
    return None


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
    algo="pagerank", variant="warm",
    make=lambda g, comm, **p: _pr.pagerank_fast_program(g, comm,
                                                        seeded=True, **p),
    inputs=("rank0",), input_kinds=("vertex_f32",),
    defaults={"iters": 300, "tol": 1e-6, "compress": False,
              "err_every": 1},
    incremental=IncrementalSpec(of="pagerank", seed_output="rank",
                                mutations="any"),
    doc="push-aggregate PageRank warm-restarted from a previous epoch's "
        "rank vector; same fixed point from any seed, so it is exact "
        "after ANY mutation batch — the seed only buys fewer rounds"))

register(ProgramSpec(
    algo="cc", variant="incremental",
    make=lambda g, comm, **p: _cc.cc_program(g, comm, seeded=True, **p),
    inputs=("labels0",), input_kinds=("vertex_i32",),
    defaults={"max_rounds": 128},
    incremental=IncrementalSpec(of="cc", seed_output="labels",
                                mutations="insert"),
    doc="min-label propagation warm-started from a previous epoch's "
        "labels: exact after insert-only batches (components only "
        "merge); identity seed = the cold start"))

register(ProgramSpec(
    algo="kcore", variant="incremental",
    make=lambda g, comm, **p: _inc.kcore_incremental_program(g, comm, **p),
    inputs=("core0",), input_kinds=("vertex_i32",),
    defaults={"max_rounds": 2048},
    incremental=IncrementalSpec(of="kcore", seed_output="core",
                                mutations="delete"),
    doc="local support-decrement peeling from a previous epoch's core "
        "numbers: exact from ANY pointwise upper bound, so old cores "
        "are valid after delete-only batches and the degree bound is "
        "the cold start"))

register(ProgramSpec(
    algo="betweenness", variant="default",
    make=lambda g, comm, **p: _bc.betweenness_program(g, comm, **p),
    inputs=("root",), defaults={"max_levels": 64},
    doc="Brandes single-source dependencies: path-counting forward BFS "
        "then a dependency-accumulation backward sweep (the first "
        "two-phase program; sum over batched sources for centrality)"),
    default=True)

# -- async (double-buffered) variants: stale-tolerant programs on
#    run_program_async, each held to the same oracle as its BSP sibling

register(ProgramSpec(
    algo="bfs", variant="async", exec_mode="async",
    make=lambda g, comm, **p: _bfs.bfs_async_program(g, comm, **p),
    inputs=("root",), defaults={"max_levels": 64, "local_iters": 1},
    doc="async BFS: monotone min-combine levels overlap the in-flight "
        "exchange, halt count piggybacked on the level payload (no "
        "separate psum), parents derived post-loop from exact levels"))

register(ProgramSpec(
    algo="pagerank", variant="async", exec_mode="async",
    make=lambda g, comm, **p: _pr.pagerank_async_program(g, comm, **p),
    inputs=(),
    defaults={"iters": 64, "tol": 1e-6, "staleness": 1},
    doc="bounded-staleness push PageRank: fresh own-slice term every "
        "round, remote term refreshed every `staleness` rounds by the "
        "double-buffered reduce-scatter with the residual piggybacked; "
        "remote age provably <= 2*staleness+1 (reported as max_age)"))

register(ProgramSpec(
    algo="cc", variant="async", exec_mode="async",
    make=lambda g, comm, **p: _cc.cc_async_program(g, comm, **p),
    inputs=(), defaults={"max_rounds": 64, "local_iters": 1},
    doc="async min-label propagation: both edge directions share one "
        "min-accumulator exchange per round; staleness-exact (labels "
        "only decrease under idempotent min-combine)"))

register(ProgramSpec(
    algo="sssp", variant="async", exec_mode="async",
    make=lambda g, comm, **p: _sssp.sssp_async_program(g, comm, **p),
    inputs=("root",),
    defaults={"max_rounds": 64, "local_iters": 1, "weight_scale": 1.0},
    doc="async Bellman-Ford: local closure relaxes own-partition "
        "improvements while the distance exchange is in flight; "
        "staleness-exact under min-combine"))
