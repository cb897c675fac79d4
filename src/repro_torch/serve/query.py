"""Typed queries for the graph server.

A query names a registered program by ``(algo, variant, params)`` plus
— for traversal programs with per-query inputs — a source vertex.  The
``(algo, variant, params)`` triple is the **coalescing key**: queries
with equal keys resolve to the same ``CompiledProgram`` family and can
ride one batched launch (``core/api.py`` caches per batch width, so a
bucket ladder over one key builds each rung's program once).

Three shapes of query flow through the server:

  * **source queries** (``bfs``, ``sssp``, ``betweenness``): carry a
    ``root``; the coalescer packs up to ``bucket`` of them into one
    ``batch=bucket`` launch and the demux slices lane ``i`` back out.
  * **refresh queries** (``pagerank``, ``cc``, ``kcore``,
    ``triangles``): no root; ONE launch serves every refresh query of
    the same key that is pending at dispatch time (they all want the
    same answer), recorded as ``bucket=0``.
  * **seeded queries** (``pagerank/warm``, ``cc/incremental``,
    ``kcore/incremental``): refresh queries whose program takes whole
    vertex-field inputs.  The server resolves the seed per launch — a
    stored previous-epoch output when the mutation history allows it,
    the program's cold seed otherwise — so seeded queries dispatch one
    launch each (``bucket=0``) and never batch.

Every admitted query is stamped with the server's snapshot ``epoch``;
the epoch rides through the batch into ``QueryResult.epoch``, naming
exactly which graph version answered.

**Resilience surface.**  A query may carry a ``deadline_s`` — an
admission-to-demux latency budget.  The server never blocks a batch on
it: a query whose budget expires in the queue is answered ``timed_out``
without launching, one whose launch lands late gets its answer withheld
and the same typed result.  :func:`validate_query` is the admission
gate: malformed inputs (out-of-range roots, non-finite float params
such as an sssp ``weight_scale``, NaN/Inf or out-of-range seed vectors)
are rejected BEFORE they can poison a coalesced launch.  Every
terminal disposition is a :class:`QueryResult` whose ``status`` is one
of ``"ok"`` / ``"timed_out"`` / ``"shed"`` / ``"failed"``; only
``"ok"`` results carry fields.
"""

from __future__ import annotations

import math

import numpy as np

from dataclasses import dataclass, field

from repro_torch.core import registry
from repro_torch.core.registry import program_label


@dataclass(frozen=True)
class QueryKey:
    """The coalescing identity of a query: program + bound params."""

    algo: str
    variant: str
    params: tuple = ()                  # sorted (name, value) pairs

    @property
    def label(self) -> str:
        return program_label(self.algo, self.variant)

    @property
    def spec(self):
        return registry.get_spec(self.algo, self.variant)

    @property
    def rooted(self) -> bool:
        """Takes SCALAR per-query inputs (a root) — batches on the ladder."""
        spec = self.spec
        return bool(spec.inputs) and \
            all(k == "scalar" for k in spec.input_kinds)

    @property
    def seeded(self) -> bool:
        """Takes vertex-field inputs the server resolves per launch."""
        return any(k != "scalar" for k in self.spec.input_kinds)


def make_key(algo: str, variant: str | None = None, **params) -> QueryKey:
    """Resolve through the registry (so ``"bfs/fast"`` shorthand and
    default variants work, and unknown programs fail at admission with
    the registered-key list, not at dispatch)."""
    spec = registry.get_spec(algo, variant)
    unknown = set(params) - set(spec.defaults)
    if unknown:
        raise TypeError(
            f"{spec.key}: unknown params {sorted(unknown)}; "
            f"accepted: {sorted(spec.defaults)}")
    return QueryKey(spec.algo, spec.variant, tuple(sorted(params.items())))


@dataclass
class Query:
    """One admitted query.  ``qid`` / ``t_submit`` are assigned by the
    server at admission; ``t_submit`` doubles as the latency clock start
    (trace replay passes the intended arrival time instead).  ``epoch``
    is stamped at admission too: batches only coalesce queries of one
    epoch, so a launch reads exactly one graph snapshot.

    ``seed`` (seeded queries only) optionally pins the vertex-field
    inputs — a tuple of (n_orig,) host arrays, one per program input;
    left ``None``, the server resolves warm-vs-cold itself.

    ``deadline_s`` is the admission-to-demux latency budget (None =
    unbounded); ``attempts`` counts failed launches this query has
    ridden (the server's retry/quarantine bookkeeping).
    """

    key: QueryKey
    root: int | None = None
    qid: int = -1
    t_submit: float = 0.0
    seed: tuple | None = None
    epoch: int = -1
    deadline_s: float | None = None
    attempts: int = 0

    @property
    def deadline_abs(self) -> float:
        """Absolute wall-clock deadline on the ``t_submit`` clock
        (+inf when unbounded) — the load-shedder's eviction key."""
        if self.deadline_s is None:
            return math.inf
        return self.t_submit + self.deadline_s

    def __post_init__(self):
        if self.key.rooted and self.root is None:
            raise ValueError(
                f"{self.key.label} takes inputs {self.key.spec.inputs}; "
                "a source query needs root=")
        if not self.key.rooted and self.root is not None:
            raise ValueError(
                f"{self.key.label} takes no per-query inputs; "
                f"root={self.root} would be silently ignored")
        if self.seed is not None:
            if not self.key.seeded:
                raise ValueError(
                    f"{self.key.label} takes no vertex-field inputs; "
                    "seed= would be silently ignored")
            if len(self.seed) != len(self.key.spec.inputs):
                raise ValueError(
                    f"{self.key.label} takes {len(self.key.spec.inputs)} "
                    f"seed fields {self.key.spec.inputs}; got "
                    f"{len(self.seed)}")


def query(algo: str, variant: str | None = None, *,
          root: int | None = None, seed: tuple | None = None,
          deadline_s: float | None = None, **params) -> Query:
    """Convenience constructor: ``query("bfs", root=7)``."""
    return Query(make_key(algo, variant, **params), root, seed=seed,
                 deadline_s=deadline_s)


def validate_query(q: Query, n_orig: int) -> None:
    """Admission-time input validation; raises ``ValueError`` on inputs
    that would poison a launch (or silently corrupt a shared batch):

      * a root outside ``[0, n_orig)``;
      * a non-finite float param (an sssp ``weight_scale=inf`` scales
        every edge weight non-finite — rejected here, not at round 40);
      * a non-positive ``deadline_s``;
      * seed vectors of the wrong length, with NaN/Inf entries (float
        kinds), or with out-of-range entries (int kinds: labels and
        core bounds both live in ``[0, n_orig)``).

    The structural checks (root presence, seed arity) already ran in
    ``Query.__post_init__``; this adds the graph-sized range checks the
    dataclass cannot know.
    """
    if q.root is not None and not 0 <= int(q.root) < n_orig:
        raise ValueError(
            f"{q.key.label}: root {q.root} outside [0, {n_orig})")
    for name, value in q.key.params:
        if isinstance(value, float) and not math.isfinite(value):
            raise ValueError(
                f"{q.key.label}: param {name}={value!r} is not finite")
    if q.deadline_s is not None and not (
            math.isfinite(q.deadline_s) and q.deadline_s > 0):
        raise ValueError(
            f"{q.key.label}: deadline_s={q.deadline_s!r} must be a "
            "positive finite number of seconds")
    if q.seed is None:
        return
    for arr, kind, name in zip(q.seed, q.key.spec.input_kinds,
                               q.key.spec.inputs):
        a = np.asarray(arr)
        if a.shape != (n_orig,):
            raise ValueError(
                f"{q.key.label}: seed {name!r} has shape {a.shape}; "
                f"expected ({n_orig},)")
        if kind == "vertex_f32":
            if not np.isfinite(a).all():
                raise ValueError(
                    f"{q.key.label}: seed {name!r} has non-finite "
                    "entries")
        elif not ((a >= 0) & (a < n_orig)).all():
            raise ValueError(
                f"{q.key.label}: seed {name!r} has entries outside "
                f"[0, {n_orig})")


STATUSES = ("ok", "timed_out", "shed", "failed")


@dataclass
class QueryResult:
    """Demultiplexed per-query answer.

    ``fields`` maps the program's ``output_names`` to gathered host
    arrays — ``(n_orig,)`` for vertex fields, scalars for scalars —
    exactly what a direct ``engine.program(...)`` call plus
    ``gather_vertex_field`` yields.  Refresh queries coalesced into one
    launch SHARE the fields dict; treat it as read-only.  ``epoch`` is
    the snapshot epoch the answering launch read.

    ``status`` is the typed disposition: ``"ok"`` carries the answer;
    ``"timed_out"`` missed its ``deadline_s`` budget (fields withheld,
    ``rounds == -1``); ``"shed"`` was evicted by the bounded admission
    queue; ``"failed"`` exhausted its launch retries and was
    quarantined.  ``error`` holds the final exception for ``"failed"``.
    """

    qid: int
    key: QueryKey
    root: int | None
    fields: dict
    rounds: int
    latency_s: float
    bucket: int                         # launch batch width; 0 = refresh
    epoch: int = 0
    status: str = "ok"
    error: Exception | None = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def __getitem__(self, name: str):
        if self.status != "ok":
            raise KeyError(
                f"qid={self.qid} ({self.key.label}) resolved "
                f"{self.status!r}; no fields")
        return self.fields[name]
