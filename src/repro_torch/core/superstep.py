"""Superstep programs: the engine's declarative algorithm abstraction.

An algorithm is a :class:`SuperstepProgram` (``init / step / halt /
outputs`` callables over per-part graph tensors and the exchanges of a
``partitioned.StackedComm`` or ``DistComm``), and ONE shared function
(:func:`run_program`) supplies the loop every algorithm would otherwise
repeat:

  * an early-exit host loop when termination is data-dependent: step
    until ``halt`` or ``max_rounds``.  A round's device-to-host syncs
    are the step's ``psum_scalar`` calls (one in most programs, two in
    k-core), which leave their values on the host; ``halt`` and the
    programs' branch decisions read those host values and sync nothing
    more;
  * a fixed trip count when ``static_iters > 0`` (steps past
    convergence are no-ops by construction);
  * round accounting (the returned round count is loop state, not
    program state).

An :class:`AsyncSuperstepProgram` splits each round into ``local``
(compute on resident data) and ``fold`` (finish the exchange started a
round earlier, apply it, start the next), and runs under
:func:`run_program_async`, to which :func:`run_program` dispatches.  A
:class:`PhasedProgram` chains programs (each phase's outputs seed the
next phase's ``init``; :func:`run_phases`), and
:func:`run_program_batched` runs one program over B per-query inputs
against one graph residency (multi-source queries).

``guard=True`` runs the guarded loop: after each round the program's
invariant check (or a NaN/Inf screen) and the fault transport stamps
(``core/faults.py``) give the round a verdict, and the loop stops on
the first bad one.  It is :func:`init_carry`, one :func:`run_chunk`
and :func:`carry_outputs`; ``core/recovery.py`` runs the same three in
chunks of rounds with checkpoints between them.

``telemetry=True`` writes one row a round, ``[done, halt, *probes]``,
into a ``(max_rounds, 2 + K)`` float32 array on the host and returns it
last (``obs/telemetry.py``).  Every value of a row is a host number the
loop already holds, so a telemetry run makes the syncs and launches of
a plain one; the off path is the plain loop.

Every loop marks its init, each round and its outputs with the layer
spans ``engine.init``, ``engine.round`` and ``engine.outputs``
(``obs/spans.py``): one flag read each when nothing records.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.partitioned import StackedComm
from repro_torch.obs.spans import span


@dataclass(frozen=True)
class SuperstepProgram:
    """A distributed graph algorithm as data.

      prepare(g) -> g        optional: derive loop-invariant edge data
                             (e.g. SSSP weights) once, before ``init``
      init(g, *inputs) -> state
                             build the initial state from the per-query
                             inputs (e.g. a root vertex)
      step(g, state) -> state
                             ONE superstep: local compute + exchange;
                             folds its convergence scalar (frontier
                             count, residual error) into the state as a
                             host number
      halt(state) -> bool    True when converged (the loop also stops at
                             ``max_rounds``); ignored under static_iters
      outputs(state) -> tuple
                             final outputs, aligned with
                             ``output_names`` / ``output_is_vertex``
      guard(g, prev, state) -> verdict
                             optional per-round invariant check of the
                             state a step made from ``prev`` (monotone
                             non-increase, mass conservation,
                             non-negativity): a bool tensor of per-part
                             or global verdicts, possibly combined with
                             host bools; True = consistent.  ``None``
                             falls back to :func:`finite_state`.  Run
                             only by the guarded loops.
      probe(state) -> tuple  optional telemetry probes, aligned with
                             ``probe_names``: global host numbers the
                             step already reduced (frontier size,
                             residual), recorded each round in the
                             telemetry series.  Run only by telemetry
                             runs.

    ``comm`` is the exchange context the callables close over; the
    loop labels its wire accounting by phase.
    """

    name: str
    variant: str
    inputs: tuple[str, ...]           # per-query input names, e.g. ("root",)
    init: Callable[..., Any]
    step: Callable[[dict, Any], Any]
    halt: Callable[[Any], bool]
    outputs: Callable[[Any], tuple]
    output_names: tuple[str, ...]
    output_is_vertex: tuple[bool, ...]  # True: (P, n_local) vertex field
    comm: StackedComm
    max_rounds: int = 64
    prepare: Callable[[dict], dict] = field(default=lambda g: g)
    guard: Callable[[dict, Any, Any], Any] | None = None
    probe_names: tuple[str, ...] = ()
    probe: Callable[[Any], tuple] | None = None

    @property
    def key(self) -> str:
        return f"{self.name}/{self.variant}"


# Rounds slack of an async run against the BSP run of the same monotone
# program: fold() relaxes delivered updates before re-shipping, so a
# cross-part hop still costs one round, and the overhead is the pipeline
# fill plus the two-quiescent-rounds halt rule.
ASYNC_ROUNDS_SLACK_FACTOR = 1.5
ASYNC_ROUNDS_SLACK_CONST = 4


@dataclass(frozen=True)
class AsyncSuperstepProgram:
    """A stale-tolerant algorithm for the double-buffered driver.

      init(g, *inputs) -> (state, handle)
                             seed the state and start the first exchange
                             (``StackedComm.exchange_*_start``), so round
                             one has a handle to finish
      local(g, state) -> state
                             compute on resident data only, no exchange:
                             the work that would hide the exchange in
                             flight
      fold(g, state, handle) -> (state, handle)
                             finish the handle, apply the delivered
                             updates, start the next exchange
      halt(state) -> bool    reads only the global values a finish
                             delivered (host numbers)
      outputs(g, state) -> tuple
                             finalization after the loop; unlike the BSP
                             form it receives ``g`` and may exchange
      guard(g, prev, state)  as :class:`SuperstepProgram`'s, over a
                             round's ``local`` + ``fold``
      probe(state) -> tuple  as :class:`SuperstepProgram`'s, on the state
                             ``fold`` returns

    Round k's exchange is finished in round k + 1, after that round's
    ``local``; the loop carries the handle a ``start`` returns, whatever
    it is.  Under ``StackedComm`` (every part on one device) the handle
    is the received rows themselves and nothing is in flight: the split
    shapes the rounds, the halt rule and the wire, not the time.  Under
    ``DistComm`` (a part a rank) it is a pending collective: NCCL runs it
    on its own stream, ordered after the payload and before the finish
    on the compute stream, and gloo on its own thread, so ``local`` may
    run while it is in flight.  No overlap is measured yet.
    """

    name: str
    variant: str
    inputs: tuple[str, ...]
    init: Callable[..., Any]
    local: Callable[[dict, Any], Any]
    fold: Callable[[dict, Any, Any], Any]
    halt: Callable[[Any], bool]
    outputs: Callable[[dict, Any], tuple]
    output_names: tuple[str, ...]
    output_is_vertex: tuple[bool, ...]
    comm: StackedComm
    max_rounds: int = 64
    prepare: Callable[[dict], dict] = field(default=lambda g: g)
    guard: Callable[[dict, Any, Any], Any] | None = None
    probe_names: tuple[str, ...] = ()
    probe: Callable[[Any], tuple] | None = None

    @property
    def key(self) -> str:
        return f"{self.name}/{self.variant}"


# --------------------------------------------------------------------------
# Guards.  A guarded round's verdict is the program's invariant check (or
# the NaN/Inf screen) AND NOT the transport stamp of ``core/faults``.  The
# check's tensor verdicts reach the host in ONE read, the round's one
# extra sync; host numbers in the state are checked on the host.
# --------------------------------------------------------------------------


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    else:
        yield tree


def finite_state(state):
    """Default guard: every float tensor of the state is finite, and so
    is every float host number (an error or residual the loop keeps on
    the host)."""
    ok = True
    for leaf in _leaves(state):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point():
                ok = ok & torch.isfinite(leaf).all()
        elif isinstance(leaf, float):
            ok = ok & math.isfinite(leaf)
    return ok


def _round_ok(prog, g: dict, prev, state) -> bool:
    """The round's verdict, a host bool: invariant check AND no
    transport stamp."""
    check = prog.guard if prog.guard is not None \
        else (lambda g_, p_, s_: finite_state(s_))
    verdict = check(g, prev, state)
    if isinstance(verdict, torch.Tensor):
        # the guarded round's one sync, AND over every part
        verdict = prog.comm.all_parts(verdict)
    return bool(verdict) and not faults.stamp_violation()


# --------------------------------------------------------------------------
# Telemetry series (``obs/telemetry.py``): row r, written after round r,
# is ``[done, halted, *probes]`` on the round's resulting state; rows no
# round wrote stay zero, so the host trims on ``done``.
# --------------------------------------------------------------------------


def _series_init(prog) -> np.ndarray:
    return np.zeros((prog.max_rounds, 2 + len(prog.probe_names)),
                    np.float32)


def _series_write(prog, series: np.ndarray, r: int, state) -> None:
    row = (prog.halt(state),) + (tuple(prog.probe(state))
                                 if prog.probe is not None else ())
    if len(row) != 1 + len(prog.probe_names):
        raise ValueError(
            f"{prog.key}: probe() returned {len(row) - 1} values for "
            f"probe_names {prog.probe_names!r}")
    if any(isinstance(v, torch.Tensor) for v in row):
        raise TypeError(f"{prog.key}: halt() and probe() must return host "
                        "numbers (reading a tensor would sync each round)")
    series[r] = (1.0,) + tuple(map(float, row))


def _no_static_telemetry(static_iters: int, telemetry: bool) -> None:
    if telemetry and static_iters:
        raise ValueError("telemetry requires the early-exit loop "
                         "(static_iters=0)")


def run_program_async(prog: AsyncSuperstepProgram, g: dict, *inputs,
                      static_iters: int = 0, guard: bool = False,
                      telemetry: bool = False):
    """The double-buffered loop: the ``(outputs, rounds)`` contract of
    :func:`run_program`, each round ``local`` then ``fold`` with the
    in-flight handle carried from one round to the next.  ``static_iters
    > 0`` runs a fixed trip count.  ``guard=True`` appends ``ok`` and
    ``telemetry=True`` the series (always last): ``(outputs, rounds[,
    ok][, series])``; a round's row is written after its ``fold``.

    Fault rounds: the exchange ``init`` starts is round 0, the one body
    iteration r starts is round r + 1."""
    _no_static_telemetry(static_iters, telemetry)
    if guard:
        return _run_guarded(prog, g, *inputs, static_iters=static_iters,
                            telemetry=telemetry)
    g = prog.prepare(g)
    comm = prog.comm
    comm.phase = "init"
    faults.set_round(0)
    with span("init", "engine"):
        state, handle = prog.init(g, *inputs)
    comm.phase = "round"
    rounds = 0
    series = _series_init(prog) if telemetry else None
    if static_iters:
        for _ in range(static_iters):
            faults.set_round(rounds + 1)
            with span("round", "engine"):
                state, handle = prog.fold(g, prog.local(g, state), handle)
            rounds += 1
    else:
        while rounds < prog.max_rounds and not prog.halt(state):
            faults.set_round(rounds + 1)
            with span("round", "engine"):
                state, handle = prog.fold(g, prog.local(g, state), handle)
            if series is not None:
                _series_write(prog, series, rounds, state)
            rounds += 1
    faults.set_round(-1)
    comm.phase = "outputs"
    with span("outputs", "engine"):
        out = prog.outputs(g, state)
    comm.phase = "round"
    return (out, rounds) if series is None else (out, rounds, series)


@dataclass(frozen=True)
class PhasedProgram:
    """A multi-phase algorithm: :class:`SuperstepProgram` phases run back
    to back, each phase's ``outputs`` passed to the next phase's ``init``
    (after the per-query ``inputs`` of phase 0).  Brandes betweenness is
    the case: a path-counting forward BFS, then a backward sweep seeded
    with its (dist, sigma).  ``output_names`` / ``output_is_vertex``
    describe the last phase's outputs, which are the program's."""

    name: str
    variant: str
    inputs: tuple[str, ...]
    phases: tuple[SuperstepProgram, ...]
    output_names: tuple[str, ...]
    output_is_vertex: tuple[bool, ...]

    @property
    def key(self) -> str:
        return f"{self.name}/{self.variant}"

    @property
    def probe_names(self) -> tuple[str, ...]:
        """The phases share one series row layout, so every phase must
        declare the same probe names (phase 0's are the program's)."""
        names = self.phases[0].probe_names
        for ph in self.phases[1:]:
            if ph.probe_names != names:
                raise ValueError(
                    f"{self.key}: phases declare different probe_names "
                    f"({names!r} vs {ph.probe_names!r}); telemetry "
                    "needs one row layout")
        return names


def run_phases(prog: PhasedProgram, g: dict, *inputs,
               static_iters: int = 0, guard: bool = False,
               telemetry: bool = False):
    """Run the phases of ``prog`` in order, phase i + 1 initialized with
    phase i's outputs.  Returns the last phase's outputs and the total
    round count (``len(phases) * static_iters`` on the fixed-trip path),
    under ``guard=True`` the AND of the phases' verdicts, and under
    ``telemetry=True`` the phases' series concatenated (``max_rounds``
    rows a phase; the ``done`` column marks the written ones).  Each
    phase counts its own fault rounds."""
    if telemetry:
        prog.probe_names            # raises if the phases disagree
    chained, total, ok, series = inputs, 0, True, []
    for phase in prog.phases:
        res = run_program(phase, g, *chained, static_iters=static_iters,
                          guard=guard, telemetry=telemetry)
        chained, rounds = res[0], res[1]
        if guard:
            ok = ok and res[2]
        if telemetry:
            series.append(res[-1])
        total += rounds
    out = (chained, total, ok) if guard else (chained, total)
    return out + (np.concatenate(series),) if telemetry else out


def run_program(prog: SuperstepProgram, g: dict, *inputs,
                static_iters: int = 0, guard: bool = False,
                telemetry: bool = False):
    """The ONE shared superstep loop.

    Returns ``(outputs_tuple, rounds)`` where ``rounds`` is the number of
    supersteps executed (== ``static_iters`` on the fixed-trip path).  A
    :class:`PhasedProgram` dispatches to :func:`run_phases`, an
    :class:`AsyncSuperstepProgram` to :func:`run_program_async`.

    ``guard=True`` checks every round (init included) and stops on the
    first bad one; the return becomes ``(outputs_tuple, rounds, ok)``
    with ``ok`` a sticky host bool.  It does not combine with
    ``static_iters``.  Fault rounds: init and step 0 are round 0, step r
    is round r, outputs round -1.

    ``telemetry=True`` writes the round's series row after each step and
    appends the ``(max_rounds, 2 + K)`` float32 series as the LAST
    element; it combines with ``guard``, not with ``static_iters``.
    """
    _no_static_telemetry(static_iters, telemetry)
    if isinstance(prog, PhasedProgram):
        return run_phases(prog, g, *inputs, static_iters=static_iters,
                          guard=guard, telemetry=telemetry)
    if isinstance(prog, AsyncSuperstepProgram):
        return run_program_async(prog, g, *inputs,
                                 static_iters=static_iters, guard=guard,
                                 telemetry=telemetry)
    if guard:
        return _run_guarded(prog, g, *inputs, static_iters=static_iters,
                            telemetry=telemetry)
    g = prog.prepare(g)
    comm = prog.comm
    comm.phase = "init"
    faults.set_round(0)
    with span("init", "engine"):
        state = prog.init(g, *inputs)
    comm.phase = "round"
    rounds = 0
    series = _series_init(prog) if telemetry else None
    if static_iters:
        for _ in range(static_iters):
            faults.set_round(rounds)
            with span("round", "engine"):
                state = prog.step(g, state)
            rounds += 1
    else:
        while rounds < prog.max_rounds and not prog.halt(state):
            faults.set_round(rounds)
            with span("round", "engine"):
                state = prog.step(g, state)
            if series is not None:
                _series_write(prog, series, rounds, state)
            rounds += 1
    faults.set_round(-1)
    comm.phase = "outputs"
    with span("outputs", "engine"):
        out = prog.outputs(state)
    comm.phase = "round"
    return (out, rounds) if series is None else (out, rounds, series)


def run_program_batched(prog, g: dict, *batched_inputs,
                        static_iters: int = 0):
    """Multi-source loop: :func:`run_program` over B per-query inputs
    (each a length-B sequence, e.g. B roots) against one graph residency.

    Returns ``(outputs, rounds)``: vertex outputs stacked to
    ``(P, B, n_local)``, other outputs as length-B lists, and ``rounds``
    a length-B list.  The loop halts on host values, so the queries run
    one after another; a non-phased program's ``prepare`` runs once for
    all of them.  Each distinct input tuple runs once: a lane that
    repeats an earlier lane's inputs (the server pads a batch to its
    bucket with copies of the last root) takes that run's outputs, the
    bits a run of its own gives, since a run is deterministic.
    """
    if not isinstance(prog, PhasedProgram):
        g = prog.prepare(g)
        prog = dataclasses.replace(prog, prepare=lambda garr: garr)
    queries = list(zip(*batched_inputs))
    if not queries:
        raise ValueError(f"{prog.key}: batched inputs are empty")
    keys = [tuple(x.item() if isinstance(x, torch.Tensor) else x
                  for x in q) for q in queries]
    distinct = {}
    for key, q in zip(keys, queries):
        if key not in distinct:
            distinct[key] = run_program(prog, g, *q,
                                        static_iters=static_iters)
    runs = [distinct[key] for key in keys]
    outs = tuple(
        torch.stack([r[0][i] for r in runs], dim=1) if is_v
        else [r[0][i] for r in runs]
        for i, is_v in enumerate(prog.output_is_vertex))
    return outs, [r[1] for r in runs]


# --------------------------------------------------------------------------
# Chunked execution: the checkpointing substrate.
#
# The guarded loop runs a program as ONE chunk; ``core/recovery.py`` runs
# it as guarded CHUNKS of at most k rounds and snapshots the carry
# between chunks.  The carry is ``(state, handle, rounds, ok)``:
# ``handle`` is ``()`` for BSP programs and the in-flight exchange for
# async ones, ``rounds`` and ``ok`` host values; a telemetry carry adds
# the series as carry[4] (a host array: a snapshot must copy it, so that
# a rollback drops the rows of the discarded rounds).  Chunks run the
# rounds of one guarded loop, so a chunked run gives the bits of an
# uninterrupted one.  ``g`` is the graph ``prog.prepare`` returned: the
# caller prepares once for all chunks.
# --------------------------------------------------------------------------


def _run_guarded(prog, g: dict, *inputs, static_iters: int = 0,
                 telemetry: bool = False):
    """The guarded loop of a BSP or async program: ``(outputs, rounds,
    ok[, series])``, stopped at the first bad round."""
    if static_iters:
        raise ValueError("guard=True is incompatible with static_iters")
    g = prog.prepare(g)
    carry, _ = run_chunk(prog, g,
                         init_carry(prog, g, *inputs, telemetry=telemetry),
                         prog.max_rounds)
    return (carry_outputs(prog, g, carry),) + tuple(carry[2:])


def init_carry(prog, g: dict, *inputs, telemetry: bool = False):
    """The first carry: init + the round-0 verdict (an init's exchanges
    are fault round 0, so a tainted init reports ``ok`` False and the
    caller re-inits rather than checkpointing poison).  ``telemetry=True``
    appends the empty series as carry[4]."""
    comm = prog.comm
    comm.phase = "init"
    faults.set_round(0)
    with span("init", "engine"):
        if isinstance(prog, AsyncSuperstepProgram):
            state, handle = prog.init(g, *inputs)
        else:
            state, handle = prog.init(g, *inputs), ()
        comm.phase = "round"
        ok = _round_ok(prog, g, state, state)
    carry = state, handle, 0, ok
    return carry + (_series_init(prog),) if telemetry else carry


def run_chunk(prog, g: dict, carry, chunk: int):
    """Advance ``carry`` by up to ``chunk`` guarded rounds; stop early on
    halt, ``max_rounds`` or the first bad round.  Returns ``(carry,
    halted)``: the caller reads ``carry[3]`` (ok) to checkpoint or roll
    back, and ``halted`` and ``carry[2]`` (rounds) to go on or stop.  A
    telemetry carry (five elements) gets each round's series row."""
    is_async = isinstance(prog, AsyncSuperstepProgram)
    state, handle, r, ok, *series = carry
    i = 0
    while ok and not prog.halt(state) and i < chunk \
            and r < prog.max_rounds:
        faults.set_round(r + 1 if is_async else r)
        prev = state
        with span("round", "engine"):
            if is_async:
                state, handle = prog.fold(g, prog.local(g, state), handle)
            else:
                state = prog.step(g, state)
            ok = _round_ok(prog, g, prev, state)
        if series:
            _series_write(prog, series[0], r, state)
        r, i = r + 1, i + 1
    faults.set_round(-1)
    return (state, handle, r, ok, *series), bool(prog.halt(state))


def carry_outputs(prog, g: dict, carry) -> tuple:
    """The program's outputs from a halted carry."""
    comm = prog.comm
    faults.set_round(-1)
    comm.phase = "outputs"
    with span("outputs", "engine"):
        out = prog.outputs(g, carry[0]) \
            if isinstance(prog, AsyncSuperstepProgram) \
            else prog.outputs(carry[0])
    comm.phase = "round"
    return out
