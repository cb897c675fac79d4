"""Shared machinery for the monotone async programs.

bfs/async, cc/async and sssp/async are one algorithm shape: a value per
vertex (level / label / distance) that only ever DECREASES under an
idempotent, commutative MIN-combine.  A proposal applied late, twice or
out of order can neither push a value below its fixed point nor keep it
above one, so the async run reaches the same answer as the BSP program,
bit for bit.

:func:`monotone_async_program` builds the
:class:`~repro_torch.core.superstep.AsyncSuperstepProgram` from one
algorithm-specific ``relax`` callback.  Per round:

  ``local``  runs ``local_iters`` relaxation sweeps on resident data:
      own-part improvements apply at once (several hops inside a part in
      one round), proposals for every vertex accumulate into a carried
      ``(P, n)`` min-accumulator.
  ``fold``  finishes the handle, min-applies the delivered updates,
      relaxes once from them (so a cross-part hop still costs one round),
      then ships the accumulator through ``exchange_min_start`` with the
      round's change count piggybacked as the halt scalar.

The delivered global count reaches the host once a round (one sync, read
off the finished handle; no separate ``psum_scalar``).  The loop halts
when TWO consecutive delivered counts are zero: proposals shipped in a
zero-change round may still derive from the round before it, but two
quiescent rounds mean the last shipped accumulator was empty.
"""

from __future__ import annotations

import torch

from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import AsyncSuperstepProgram


def monotone_async_program(*, name: str, variant: str = "async",
                           inputs, init_vals, relax, outputs,
                           output_names, output_is_vertex,
                           n: int, n_local: int, inf, comm: StackedComm,
                           local_iters: int = 1, max_rounds: int = 64,
                           prepare=None) -> AsyncSuperstepProgram:
    """Build a monotone min-combine async program.

    ``init_vals(g, *inputs) -> (vals0, frontier0)`` seeds the
    ``(P, n_local)`` values and the changed-vertex mask;
    ``relax(g, vals, frontier) -> (P, n)`` proposes min-candidates for
    every vertex from the frontier sources (``inf`` elsewhere);
    ``outputs(g, vals) -> tuple`` finalizes (it may exchange).
    ``local_iters`` (>= 1) is the number of relaxation sweeps a round.
    """
    if local_iters < 1:
        raise ValueError(f"local_iters must be >= 1, got {local_iters}")

    def _sweep(g, vals, frontier, acc, cnt):
        """One relaxation sweep: propose from ``frontier``, min-apply the
        own block now, accumulate the rest for the next ship."""
        prop = relax(g, vals, frontier)
        acc = torch.minimum(acc, prop)
        new_vals = torch.minimum(vals, comm.own_slice(prop))
        changed = new_vals < vals
        return new_vals, changed, acc, \
            cnt + changed.sum(dim=1, dtype=torch.int32)

    def _empty(vals):
        return torch.full((comm.parts, n), inf, dtype=vals.dtype,
                          device=vals.device)

    def _zeros():
        return torch.zeros(comm.parts, dtype=torch.int32,
                           device=comm.device)

    def init(g, *ins):
        vals0, frontier0 = init_vals(g, *ins)
        acc0 = _empty(vals0)
        # seed exchange: an empty payload with a count of 1 per part (a
        # delivered total of P), so halt cannot fire before the first
        # real round's count arrives
        handle0 = comm.exchange_min_start(acc0, 1)
        return (vals0, frontier0, acc0, 1, 1, _zeros()), handle0

    def local(g, state):
        vals, frontier, acc, gprev, gprev2, cnt = state
        for _ in range(local_iters):
            vals, frontier, acc, cnt = _sweep(g, vals, frontier, acc, cnt)
        return vals, frontier, acc, gprev, gprev2, cnt

    def fold(g, state, handle):
        vals, frontier, acc, gprev, _, cnt = state
        mine, total = comm.exchange_min_finish(handle)
        v1 = torch.minimum(vals, mine)
        recv = v1 < vals
        # relax once from the delivered changes before shipping, so a
        # cross-part relay costs one round, not two
        v2, own_changed, acc, _ = _sweep(g, v1, recv, acc, _zeros())
        cnt = cnt + recv.sum(dim=1, dtype=torch.int32) \
            + own_changed.sum(dim=1, dtype=torch.int32)
        new_handle = comm.exchange_min_start(acc, cnt)
        # the round's one sync: the global count delivered by the handle
        state = (v2, frontier | own_changed, _empty(vals),
                 int(total[0].item()), gprev, _zeros())
        return state, new_handle

    return AsyncSuperstepProgram(
        name=name, variant=variant, inputs=tuple(inputs),
        init=init, local=local, fold=fold,
        halt=lambda state: state[3] <= 0 and state[4] <= 0,
        outputs=lambda g, state: outputs(g, state[0]),
        output_names=tuple(output_names),
        output_is_vertex=tuple(output_is_vertex), comm=comm,
        max_rounds=max_rounds,
        **({} if prepare is None else {"prepare": prepare}))
