"""Superstep programs: the engine's declarative algorithm abstraction.

An algorithm is a :class:`SuperstepProgram` (``init / step / halt /
outputs`` callables over stacked per-part graph tensors and the
exchanges of a ``partitioned.StackedComm``), and ONE shared function
(:func:`run_program`) supplies the loop every algorithm would otherwise
repeat:

  * an early-exit host loop when termination is data-dependent: step
    until ``halt`` or ``max_rounds``.  A round's one device-to-host sync
    is the step's ``psum_scalar``, which leaves its value on the host;
    ``halt`` and the programs' branch decisions read that host value
    and sync nothing more;
  * a fixed trip count when ``static_iters > 0`` (steps past
    convergence are no-ops by construction);
  * round accounting (the returned round count is loop state, not
    program state).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.core.partitioned import StackedComm


@dataclass(frozen=True)
class SuperstepProgram:
    """A distributed graph algorithm as data.

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

    @property
    def key(self) -> str:
        return f"{self.name}/{self.variant}"


def run_program(prog: SuperstepProgram, g: dict, *inputs,
                static_iters: int = 0):
    """The ONE shared superstep loop.

    Returns ``(outputs_tuple, rounds)`` where ``rounds`` is the number of
    supersteps executed (== ``static_iters`` on the fixed-trip path).
    """
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
