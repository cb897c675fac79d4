"""Public graph-engine API: registry-driven superstep programs over P
graph parts, stacked on one device or one a rank.

``GraphEngine`` binds a partitioned graph to a device and to the mesh
the caller names (``core/partitioned.py::GraphMesh``): by default the
one-process mesh, every part stacked here (``StackedComm``), whatever
process group is up; a launcher of P ranks passes
``mesh=launch.mesh.make_graph_mesh(P)``, and the engine then holds this
rank's part alone (``DistComm``: it keeps and uploads only that part's
rows, and vertex fields are ``(1, n_local)``).  The single entry point
is :meth:`GraphEngine.program`:

    eng = GraphEngine(g)                      # cuda, or raise
    prog = eng.program("bfs", "fast", max_levels=32)
    parents, rounds = prog(eng.device_graph(), root)

``program()`` resolves the (algo, variant) pair through
``core/registry.py``, binds the program to the engine's exchange
context, and interns the callable keyed on algorithm + params + batch +
graph shapes + (device, parts, held parts) + layout and local-ops mode:
repeated calls return the SAME object.  ``batch=B`` builds the multi-source
variant: the call takes B values per input (e.g. B roots) and vertex
outputs gain a batch dim, ``(P, B, n_local)``.  ``exec_mode="async"``
picks an algo's double-buffered variant (``program("bfs",
exec_mode="async")`` is ``program("bfs", "async")``).  Vertex-field
inputs (the incremental variants' seeds) are ``(P, n_local)`` tensors
from :meth:`GraphEngine.scatter_vertex_field`.  ``guard=True`` builds the
guarded loop (a trailing ``ok``), and ``faults=`` a fault schedule armed
at the exchanges for the build's calls (``core/faults.py``);
``core/recovery.py`` checkpoints and rolls back.  ``telemetry=True``
builds a measured run: a trailing per-round series, the wire shipped
and the wall time, parsed by :meth:`CompiledProgram.run_telemetry`
(``obs/telemetry.py``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import localops, registry
from repro_torch.core.graph import GraphShards
from repro_torch.core.partitioned import GraphMesh, StackedComm
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    PhasedProgram, SuperstepProgram, run_program, run_program_batched
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.spans import spanned


class CompiledProgram:
    """A cached, callable superstep program.

    ``__call__(garr, *inputs)`` runs the shared superstep loop and returns
    ``(*outputs, rounds)``; vertex outputs are ``(P, n_local)`` tensors.
    With ``batch=B`` each input is a length-B sequence, vertex outputs
    are ``(P, B, n_local)`` and ``rounds`` a length-B list.  The local-ops
    mode that was active when the program was built is the one its calls
    run under, as it is part of the cache key.  A ``guarded`` build
    returns ``(*outputs, rounds, ok)`` with ``ok`` 1 for a clean run and
    0 when a round failed its check (the loop stopped there); ``faults``
    is the schedule armed for each call, disarmed on every exit.

    A ``telemetry`` build appends the ``(max_rounds, 2 + K)`` float32
    series last, refills :attr:`wire` (a ``WireRecord``) with what the
    call shipped, and sets :attr:`last_wall_s`.  Such a call is
    measurement mode: on a card it synchronizes the device before it
    starts the clock and before it stops it, so the wall time is the
    device's (two drains a call, none a round).

    Every call is the layer site ``engine.call`` (``obs/spans.py``).
    """

    def __init__(self, spec: registry.ProgramSpec,
                 program: SuperstepProgram | PhasedProgram
                 | AsyncSuperstepProgram, mode: str,
                 static_iters: int = 0, batch: int | None = None,
                 guarded: bool = False,
                 faults: faults_mod.FaultSchedule | None = None,
                 telemetry: bool = False, comm: StackedComm | None = None):
        self.spec = spec
        self.program = program
        self.mode = mode
        self.static_iters = static_iters
        self.batch = batch
        self.guarded = guarded
        self.faults = faults
        self.telemetry = telemetry
        self.comm = comm
        self.wire = obs_telemetry.WireRecord() if telemetry else None
        self.last_wall_s = 0.0

    @spanned("call", "engine")
    def __call__(self, garr: dict, *inputs):
        if self.telemetry:
            return self._measured(garr, *inputs)
        with localops.using(self.mode), \
                faults_mod.active(self.faults, detect=self.guarded):
            if self.guarded:
                outs, rounds, ok = run_program(self.program, garr, *inputs,
                                               guard=True)
                return (*outs, rounds, int(ok))
            if self.batch is None:
                outs, rounds = run_program(self.program, garr, *inputs,
                                           static_iters=self.static_iters)
            else:
                for x in inputs:
                    if len(x) != self.batch:
                        raise ValueError(
                            f"{self.program.key} built for batch="
                            f"{self.batch}, got {len(x)} values")
                outs, rounds = run_program_batched(
                    self.program, garr, *inputs,
                    static_iters=self.static_iters)
        return (*outs, rounds)

    def _measured(self, garr: dict, *inputs):
        """A telemetry call: ``(*outputs, rounds[, ok], series)``."""
        comm = self.comm
        card = comm.device.type == "cuda"
        if card:
            torch.cuda.synchronize(comm.device)
        before = comm.tally()
        t0 = time.perf_counter()
        with localops.using(self.mode), \
                faults_mod.active(self.faults, detect=self.guarded):
            outs, rounds, *rest = run_program(
                self.program, garr, *inputs, guard=self.guarded,
                telemetry=True)
        if card:
            torch.cuda.synchronize(comm.device)
        self.last_wall_s = time.perf_counter() - t0
        self.wire.measure(obs_telemetry.tally_delta(before, comm.tally()),
                          rounds)
        ok = (int(rest[0]),) if self.guarded else ()
        return (*outs, rounds, *ok, rest[-1])

    def run_telemetry(self, series) -> obs_telemetry.RunTelemetry:
        """The trailing series of a telemetry call as a ``RunTelemetry``
        with this build's wire record and the last call's wall time."""
        if not self.telemetry:
            raise ValueError(f"{self.program.key} was not built with "
                             "telemetry=True")
        ps = obs_telemetry.PhaseSeries.from_array(series,
                                                  self.program.probe_names)
        return obs_telemetry.RunTelemetry(
            series=ps, wire=self.wire.snapshot(), wall_s=self.last_wall_s,
            loop_bytes=self.wire.loop_bytes)

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
    # the deployment: the one-process mesh GraphMesh(g.parts) when not
    # given (a launcher of ranks passes launch.mesh.make_graph_mesh)
    mesh: GraphMesh | None = None
    _cache: dict = field(default_factory=dict, repr=False, compare=False)

    def __post_init__(self):
        self.device = torch.device(self.device) if self.device is not None \
            else _default_device()
        if self.layout not in ("ell", "coo"):
            raise ValueError(f"layout {self.layout!r} not in ('ell', 'coo')")
        if self.mesh is None:
            self.mesh = GraphMesh(self.g.parts)
        if self.mesh.parts != self.g.parts:
            raise ValueError(f"a mesh of {self.mesh.parts} parts for a "
                             f"graph of {self.g.parts}")
        self.comm = self.mesh.comm(self.device)
        if self.distributed:
            self.g = self.g.take_part(self.comm.first_part)
        elif self.g.part_index is not None:
            raise ValueError(f"shards of part {self.g.part_index} alone "
                             "need the distributed mesh")

    @property
    def distributed(self) -> bool:
        """True when the parts are ranks (``DistComm``)."""
        return self.mesh.distributed

    def program(self, algo: str, variant: str | None = None, *,
                static_iters: int = 0, batch: int | None = None,
                exec_mode: str | None = None, guard: bool = False,
                faults=None, telemetry: bool = False,
                **params) -> CompiledProgram:
        """Resolve, build and cache an algorithm program.

        ``static_iters > 0`` replaces the early-exit loop with a fixed
        trip count.  ``batch=B`` builds the multi-source variant (only
        for programs with scalar per-query inputs), with the spec's
        ``batch_defaults`` under explicit params.  ``exec_mode`` selects
        the loop by mode: with a bare algo it re-resolves to the algo's
        variant of that mode (the same cache entry as naming it); with an
        explicit variant a mismatch raises.  ``guard=True`` builds the
        guarded loop: each round's invariant check and transport stamps,
        a stop at the first bad round, and a trailing ``ok`` (1 clean, 0
        detected) after ``rounds``.  ``faults=`` takes a
        :class:`~repro_torch.core.faults.FaultSchedule` (or its string
        form), armed at the exchanges during each call; detection needs
        ``guard`` too.  Neither combines with ``batch``, nor ``guard``
        with ``static_iters``.  ``telemetry=True`` builds a measured run
        (see :class:`CompiledProgram`); it combines with ``guard``, not
        with ``batch`` or ``static_iters``.  Params are normalized against
        the spec's defaults so an explicitly spelled default hits the
        same cache entry.
        """
        bare = variant is None and "/" not in algo
        spec = registry.get_spec(algo, variant)
        if exec_mode is not None and spec.exec_mode != exec_mode:
            if exec_mode not in registry.EXEC_MODES:
                raise ValueError(
                    f"exec_mode {exec_mode!r} not in {registry.EXEC_MODES}")
            if not bare:
                raise ValueError(
                    f"{spec.key} is a {spec.exec_mode} program; "
                    f"exec_mode={exec_mode!r} contradicts the explicit "
                    f"variant — drop one (mode-variants: "
                    f"{registry.mode_variant(spec.algo, exec_mode)!r})")
            alt = registry.mode_variant(spec.algo, exec_mode)
            if alt is None:
                raise ValueError(
                    f"{spec.algo} has no {exec_mode} variant; "
                    f"async-capable pairs: "
                    f"{['/'.join(p) for p in registry.async_pairs()]}")
            spec = registry.get_spec(spec.algo, alt)
        if batch is not None and not spec.inputs:
            raise ValueError(
                f"{spec.key} takes no per-query inputs; batch={batch} has "
                f"nothing to batch over")
        if batch is not None and any(k != "scalar" for k in spec.input_kinds):
            raise ValueError(
                f"{spec.key} takes whole vertex-field inputs "
                f"{spec.inputs}; only scalar per-query inputs batch")
        schedule = faults_mod.as_schedule(faults)
        if guard and static_iters:
            raise ValueError(
                "guard=True is incompatible with static_iters: the "
                "guarded loop must stop on the detected round")
        if (guard or schedule is not None) and batch is not None:
            raise ValueError(
                "guard/faults do not compose with batch: fault rounds "
                "and guard verdicts are per-run, not per-query")
        if telemetry and static_iters:
            raise ValueError(
                "telemetry requires the early-exit loop; a static_iters "
                "run has no data-dependent rounds to record")
        if telemetry and batch is not None:
            raise ValueError(
                "telemetry does not compose with batch: the series is "
                "per-run, not per-query")
        batch_over = spec.batch_defaults if batch is not None else {}
        params = {**spec.defaults, **batch_over, **params}
        g = self.g
        mode = localops.get_mode()
        key = (spec.algo, spec.variant, static_iters, batch, guard, schedule,
               telemetry, tuple(sorted(params.items())),
               (g.n, g.n_orig, g.parts, g.n_local, g.e_max),
               g.layout_signature(),
               (str(self.device), g.parts, self.comm.first_part,
                self.comm.local_parts),
               (self.layout, mode))
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        compiled = CompiledProgram(spec, spec.build(g, self.comm, **params),
                                   mode, static_iters, batch, guard,
                                   schedule, telemetry, self.comm)
        self._cache[key] = compiled
        return compiled

    # -- thin legacy wrappers -----------------------------------------------
    def bfs(self, mode: str = "fast", max_levels: int = 64,
            static_iters: int = 0) -> CompiledProgram:
        return self.program("bfs", mode, static_iters=static_iters,
                            max_levels=max_levels)

    def pagerank(self, mode: str = "fast", iters: int = 50,
                 tol: float = 1e-6, compress=True,
                 static_iters: int = 0) -> CompiledProgram:
        params = {"iters": iters, "tol": tol}
        if mode == "fast":
            params["compress"] = compress
        return self.program("pagerank", mode, static_iters=static_iters,
                            **params)

    def sssp(self, max_rounds: int = 64,
             static_iters: int = 0) -> CompiledProgram:
        return self.program("sssp", static_iters=static_iters,
                            max_rounds=max_rounds)

    def cc(self, max_rounds: int = 64,
           static_iters: int = 0) -> CompiledProgram:
        return self.program("cc", static_iters=static_iters,
                            max_rounds=max_rounds)

    # -- helpers -------------------------------------------------------------
    def device_graph(self) -> dict:
        return self.g.device_arrays(self.layout, self.device)

    def gather_vertex_field(self, arr: torch.Tensor) -> np.ndarray:
        """(L, n_local) held parts -> (n_orig,) numpy of every part (under
        ``DistComm`` an all-gather: every rank gets the whole field)."""
        arr = self.comm.gather_parts(arr)
        return arr.reshape(-1)[: self.g.n_orig].cpu().numpy()

    def gather_batched_vertex_field(self, arr: torch.Tensor) -> np.ndarray:
        """(L, B, n_local) batched -> (B, n_orig) numpy, gathered as
        :meth:`gather_vertex_field`."""
        arr = self.comm.gather_parts(arr)
        b = arr.transpose(0, 1).reshape(arr.shape[1], -1)
        return b[:, : self.g.n_orig].cpu().numpy()

    def scatter_vertex_field(self, arr, dtype=None) -> torch.Tensor:
        """(n_orig,) host values -> (L, n_local) vertex field of the held
        parts on the engine's device (the inverse of
        ``gather_vertex_field``).  The padded tail is zero-filled."""
        g = self.g
        a = np.asarray(arr)
        if a.ndim != 1 or a.shape[0] < g.n_orig:
            raise ValueError(
                f"vertex field must be 1-D with >= n_orig={g.n_orig} "
                f"entries, got shape {a.shape}")
        dt = np.dtype(dtype) if dtype is not None else a.dtype
        full = np.zeros((g.n,), dt)
        full[: g.n_orig] = a[: g.n_orig]
        first = self.comm.first_part
        held = full.reshape(g.parts, g.n_local)[
            first:first + self.comm.local_parts]
        return torch.from_numpy(np.ascontiguousarray(held)).to(self.device)
