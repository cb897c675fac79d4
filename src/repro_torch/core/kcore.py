"""Distributed k-core decomposition: iterative peeling with a
degree-threshold halt scalar.

Semantics: core numbers of the UNDIRECTED MULTIGRAPH underlying the edge
list (parallel edges each contribute a degree unit; self-loops are
dropped).

The peeling recurrence (threshold form): hold a current threshold ``k``;
every superstep removes ALL alive vertices with induced degree <= k and
assigns them ``core = k``.  Each killed endpoint posts one decrement per
incident edge into a length-n int32 accumulator and ONE ``exchange_sum``
delivers owner slices (exact integer sums).  When a superstep kills
nothing, the threshold advances.  Each round reads two host scalars:
the kill count (does ``k`` advance) and the alive count (the halt).
"""

from __future__ import annotations

import torch

from repro_torch.core import localops
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram


def _undirected_degree(g, comm: StackedComm, n: int, n_local: int):
    """out_degree + in_degree - 2 * self_loops (multigraph, loops
    dropped), (P, n_local) int32."""
    srcl, dst = g["out_src_local"], g["out_dst_global"]
    is_loop = (dst < n) & (dst == srcl + comm.lo(n_local))
    loops = torch.zeros((comm.parts, n_local), dtype=torch.int32,
                        device=comm.device)
    loops.scatter_add_(1, torch.where(is_loop, srcl, 0).long(),
                       is_loop.to(torch.int32))
    return g["out_degree"] + g["in_degree"] - 2 * loops


def kcore_program(shards, comm: StackedComm,
                  max_rounds: int = 512) -> SuperstepProgram:
    """Iterative peeling as a superstep program.

    Outputs: per-vertex core numbers (vertex field) and the degeneracy
    (max core number, a host int)."""
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")
    ell_src = shards.ell("ell_src")

    def prepare(g):
        g = dict(g)
        g["und_degree"] = _undirected_degree(g, comm, n, n_local)
        return g

    def init(g, *_):
        alive0 = torch.ones((comm.parts, n_local), dtype=torch.bool,
                            device=comm.device)
        core0 = torch.zeros((comm.parts, n_local), dtype=torch.int32,
                            device=comm.device)
        return alive0, core0, g["und_degree"], 0, 1

    def step(g, state):
        alive, core, deg, k, _ = state
        lo = comm.lo(n_local)
        kills = alive & (deg <= k)
        n_killed = comm.psum_scalar(kills.sum(dim=1, dtype=torch.int32))
        core = torch.where(kills, k, core)
        alive = alive & ~kills
        # each removed edge notifies its other endpoint (dead receivers
        # are harmless): both directions combine into one length-n sum
        srcl, dst = g["out_src_local"], g["out_dst_global"]
        dec_out = torch.gather(kills, 1, srcl) & (dst < n) \
            & (dst != srcl + lo)
        src, dstl = g["in_src_global"], g["in_dst_local"]
        dec_in = torch.gather(kills, 1, dstl) & (src < n) \
            & (src != dstl + lo)
        acc = localops.scatter_combine(g, ell_dst, dec_out.to(torch.int32),
                                       "add", identity=0)
        acc = acc + localops.scatter_combine(
            g, ell_src, dec_in.to(torch.int32), "add", identity=0)
        deg = deg - comm.exchange_sum(acc)
        # no kills at this threshold -> the (k+1)-core remains: advance k
        k = k if n_killed > 0 else k + 1
        n_alive = comm.psum_scalar(alive.sum(dim=1, dtype=torch.int32))
        return alive, core, deg, k, n_alive

    def outputs(state):
        core = state[1]
        return core, int(core.max())

    return SuperstepProgram(
        name="kcore", variant="default", inputs=(),
        prepare=prepare, init=init, step=step,
        halt=lambda state: state[4] <= 0,
        outputs=outputs,
        output_names=("core", "kmax"), output_is_vertex=(True, False),
        comm=comm, max_rounds=max_rounds)
