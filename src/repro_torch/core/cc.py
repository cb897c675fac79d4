"""Distributed connected components (min-label propagation).

Treats the graph as undirected by propagating labels along BOTH edge
directions; converges when no label changes.  Rounds past convergence
are no-ops (labels are already fixed points of the min-combine), so the
program is safe under ``static_iters``.  The labels are the minimum
vertex id of each weakly connected component.
"""

from __future__ import annotations

import torch

from repro_torch.core import localops
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram

INT_INF = 2 ** 30


def cc_program(shards, comm: StackedComm,
               max_rounds: int = 64) -> SuperstepProgram:
    """Label propagation over both edge directions as a superstep
    program."""
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")
    ell_src = shards.ell("ell_src")

    def init(g, *_):
        gid = torch.arange(n_local, dtype=torch.int32,
                           device=comm.device) + comm.lo(n_local)
        return gid, 1

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
        name="cc", variant="default", inputs=(),
        init=init, step=step,
        halt=lambda state: state[1] <= 0,
        outputs=lambda state: (state[0],),
        output_names=("labels",), output_is_vertex=(True,),
        comm=comm, max_rounds=max_rounds)
