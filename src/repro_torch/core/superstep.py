"""Superstep programs: the engine's declarative algorithm abstraction.

An algorithm is a :class:`SuperstepProgram` (``init / step / halt /
outputs`` callables over stacked per-part graph tensors and the
exchanges of a ``partitioned.StackedComm``), and ONE shared function
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
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from repro_torch.core.partitioned import StackedComm


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

    Round k's exchange is finished in round k + 1, after that round's
    ``local``.  With all parts stacked on one device the overlap is
    nominal: the split shapes the rounds, the halt rule and the wire, not
    the time.
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

    @property
    def key(self) -> str:
        return f"{self.name}/{self.variant}"


def run_program_async(prog: AsyncSuperstepProgram, g: dict, *inputs,
                      static_iters: int = 0):
    """The double-buffered loop: the ``(outputs, rounds)`` contract of
    :func:`run_program`, each round ``local`` then ``fold`` with the
    in-flight handle carried from one round to the next.  ``static_iters
    > 0`` runs a fixed trip count."""
    g = prog.prepare(g)
    comm = prog.comm
    comm.phase = "init"
    state, handle = prog.init(g, *inputs)
    comm.phase = "round"
    rounds = 0
    if static_iters:
        for _ in range(static_iters):
            state, handle = prog.fold(g, prog.local(g, state), handle)
        rounds = static_iters
    else:
        while rounds < prog.max_rounds and not prog.halt(state):
            state, handle = prog.fold(g, prog.local(g, state), handle)
            rounds += 1
    comm.phase = "outputs"
    out = prog.outputs(g, state)
    comm.phase = "round"
    return out, rounds


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


def run_phases(prog: PhasedProgram, g: dict, *inputs,
               static_iters: int = 0):
    """Run the phases of ``prog`` in order, phase i + 1 initialized with
    phase i's outputs.  Returns the last phase's outputs and the total
    round count (``len(phases) * static_iters`` on the fixed-trip
    path)."""
    chained, total = inputs, 0
    for phase in prog.phases:
        chained, rounds = run_program(phase, g, *chained,
                                      static_iters=static_iters)
        total += rounds
    return chained, total


def run_program(prog: SuperstepProgram, g: dict, *inputs,
                static_iters: int = 0):
    """The ONE shared superstep loop.

    Returns ``(outputs_tuple, rounds)`` where ``rounds`` is the number of
    supersteps executed (== ``static_iters`` on the fixed-trip path).  A
    :class:`PhasedProgram` dispatches to :func:`run_phases`, an
    :class:`AsyncSuperstepProgram` to :func:`run_program_async`.
    """
    if isinstance(prog, PhasedProgram):
        return run_phases(prog, g, *inputs, static_iters=static_iters)
    if isinstance(prog, AsyncSuperstepProgram):
        return run_program_async(prog, g, *inputs,
                                 static_iters=static_iters)
    g = prog.prepare(g)
    comm = prog.comm
    comm.phase = "init"
    state = prog.init(g, *inputs)
    comm.phase = "round"
    rounds = 0
    if static_iters:
        for _ in range(static_iters):
            state = prog.step(g, state)
        rounds = static_iters
    else:
        while rounds < prog.max_rounds and not prog.halt(state):
            state = prog.step(g, state)
            rounds += 1
    comm.phase = "outputs"
    out = prog.outputs(state)
    comm.phase = "round"
    return out, rounds


def run_program_batched(prog, g: dict, *batched_inputs,
                        static_iters: int = 0):
    """Multi-source loop: :func:`run_program` over B per-query inputs
    (each a length-B sequence, e.g. B roots) against one graph residency.

    Returns ``(outputs, rounds)``: vertex outputs stacked to
    ``(P, B, n_local)``, other outputs as length-B lists, and ``rounds``
    a length-B list.  The loop halts on host values, so the B queries
    run one after another; a non-phased program's ``prepare`` runs once
    for all of them.
    """
    if not isinstance(prog, PhasedProgram):
        g = prog.prepare(g)
        prog = dataclasses.replace(prog, prepare=lambda garr: garr)
    queries = list(zip(*batched_inputs))
    if not queries:
        raise ValueError(f"{prog.key}: batched inputs are empty")
    runs = [run_program(prog, g, *q, static_iters=static_iters)
            for q in queries]
    outs = tuple(
        torch.stack([r[0][i] for r in runs], dim=1) if is_v
        else [r[0][i] for r in runs]
        for i, is_v in enumerate(prog.output_is_vertex))
    return outs, [r[1] for r in runs]
