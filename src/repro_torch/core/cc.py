"""Distributed connected components (min-label propagation).

Treats the graph as undirected by propagating labels along BOTH edge
directions; converges when no label changes.  Rounds past convergence
are no-ops (labels are already fixed points of the min-combine), so the
program is safe under ``static_iters``.  The labels are the minimum
vertex id of each weakly connected component.  ``cc/incremental`` seeds
the labels from an input field; ``cc/async`` runs the same min-combine
on the double-buffered exchange.
"""

from __future__ import annotations

import torch

from repro_torch.core import localops
from repro_torch.core.monotone import monotone_async_program
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    SuperstepProgram

INT_INF = 2 ** 30


def cc_program(shards, comm: StackedComm, max_rounds: int = 64,
               seeded: bool = False) -> SuperstepProgram:
    """Label propagation over both edge directions as a superstep
    program.

    With ``seeded=True`` it is the ``cc/incremental`` variant: init
    adopts a ``labels0`` vertex field instead of the identity labels.
    Min-propagation converges to the minimum of ``labels0`` over each
    component, so a previous epoch's labels stay exact after insert-only
    mutations, and the identity seed is the cold start bit for bit."""
    n, n_local, n_orig = shards.n, shards.n_local, shards.n_orig
    ell_dst = shards.ell("ell_dst")
    ell_src = shards.ell("ell_src")

    def init(g, *inputs):
        gid = comm.gid(n_local)
        if not seeded:
            return gid, 1
        (labels0,) = inputs
        # padded tail vertices are edgeless: they keep their identity
        # labels, inert fixed points
        return torch.where(gid < n_orig, labels0.to(torch.int32), gid), 1

    def step(g, state):
        labels, _ = state
        srcl = g["out_src_local"]
        valid = g["out_dst_global"] < n
        in_dstl = g["in_dst_local"]
        in_valid = g["in_src_global"] < n
        # push: propose my label to out-neighbors
        prop = localops.scatter_combine(
            g, ell_dst, torch.where(valid, torch.gather(labels, 1, srcl),
                                    INT_INF), "min", identity=INT_INF)
        new_labels = torch.minimum(labels, comm.exchange_min_int(prop))
        # pull: proposals keyed by in-edge source, shipped to its owner
        prop2 = localops.scatter_combine(
            g, ell_src, torch.where(in_valid,
                                    torch.gather(new_labels, 1, in_dstl),
                                    INT_INF), "min", identity=INT_INF)
        new_labels = torch.minimum(new_labels,
                                   comm.exchange_min_int(prop2))
        cnt = comm.psum_scalar((new_labels < labels).sum(
            dim=1, dtype=torch.int32))
        return new_labels, cnt

    return SuperstepProgram(
        name="cc", variant="incremental" if seeded else "default",
        inputs=("labels0",) if seeded else (),
        init=init, step=step,
        halt=lambda state: state[1] <= 0,
        outputs=lambda state: (state[0],),
        output_names=("labels",), output_is_vertex=(True,),
        comm=comm, max_rounds=max_rounds)


def cc_async_program(shards, comm: StackedComm, max_rounds: int = 64,
                     local_iters: int = 1) -> AsyncSuperstepProgram:
    """Async label propagation on the double-buffered exchange.

    Labels only decrease under an idempotent min-combine, so a stale or
    duplicated proposal never gives a wrong label: the async run reaches
    the BSP program's labels bit for bit.  Both edge directions propose
    into ONE (P, n) accumulator, so one exchange a round carries push,
    pull and the piggybacked halt count.
    """
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")
    ell_src = shards.ell("ell_src")

    def init_vals(g):
        # every vertex proposes its identity label in round one
        return comm.gid(n_local), torch.ones(
            (comm.parts, n_local), dtype=torch.bool, device=comm.device)

    def relax(g, labels, frontier):
        srcl = g["out_src_local"]
        in_dstl = g["in_dst_local"]
        push = localops.scatter_combine(
            g, ell_dst,
            torch.where(torch.gather(frontier, 1, srcl)
                        & (g["out_dst_global"] < n),
                        torch.gather(labels, 1, srcl), INT_INF),
            "min", identity=INT_INF)
        pull = localops.scatter_combine(
            g, ell_src,
            torch.where(torch.gather(frontier, 1, in_dstl)
                        & (g["in_src_global"] < n),
                        torch.gather(labels, 1, in_dstl), INT_INF),
            "min", identity=INT_INF)
        return torch.minimum(push, pull)

    return monotone_async_program(
        name="cc", inputs=(), init_vals=init_vals, relax=relax,
        outputs=lambda g, labels: (labels,), output_names=("labels",),
        output_is_vertex=(True,), n=n, n_local=n_local, inf=INT_INF,
        comm=comm, local_iters=local_iters, max_rounds=max_rounds)
