"""Distributed betweenness centrality (Brandes): the first MULTI-PHASE
superstep program.

Brandes decomposes per-source betweenness into (1) a forward BFS that
counts shortest paths (sigma) while recording distance levels, then (2)
a backward dependency-accumulation sweep over the shortest-path DAG.
Phase (2) needs phase (1)'s outputs as its initial state, which is what
:class:`~repro_torch.core.superstep.PhasedProgram` provides.

Semantics: single-source dependencies ``delta_s(v)`` on the DIRECTED
MULTIGRAPH underlying the edge list (parallel edges are parallel
shortest paths), unweighted, with ``delta_s(s) = 0``.  Summing over a
batch of sources gives sampled betweenness.

Forward: per level, frontier vertices push ``sigma`` along out-edges
into a length-n accumulator (``scatter_combine`` over ``ell_dst``); one
``exchange_sum`` delivers owner slices; unvisited receivers adopt the
level and the path-count sum.

Backward: each superstep recomputes the whole relaxation

    delta(v) = sigma(v) * sum_{v->w, dist(w)=dist(v)+1}
                          (1 + delta(w)) / sigma(w)

from the current delta (one all-gather of the coefficient vector, and a
``scatter_combine`` over ``ell_out``).  Values settle one level per
superstep; the phase halts when no entry changes.

Both combines add float32 values (identity 0.0): on CUDA tensors they
are the ``spmv_ell`` kernel, which adds a row's slots in the ``ell``
path's order, so the two give the same bits.
"""

from __future__ import annotations

import torch

from repro_torch.core import localops
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import PhasedProgram, SuperstepProgram

INT_INF = 2 ** 30


def bc_forward_program(shards, comm: StackedComm,
                       max_levels: int = 64) -> SuperstepProgram:
    """Phase 1: level-synchronous BFS counting shortest paths."""
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")

    def init(g, root):
        root = int(root)
        lo = comm.lo(n_local)
        ids = torch.arange(n_local, dtype=torch.int32, device=comm.device)
        at_root = (root >= lo) & (root < lo + n_local) & (ids == root - lo)
        dist0 = torch.where(at_root, 0, INT_INF).to(torch.int32)
        sigma0 = torch.where(at_root, 1.0, 0.0)
        return dist0, sigma0, at_root, 1, 1

    def step(g, state):
        dist, sigma, frontier, level, _ = state
        srcl = g["out_src_local"]
        active = torch.gather(frontier, 1, srcl) & (g["out_dst_global"] < n)
        acc = localops.scatter_combine(
            g, ell_dst, torch.where(active, torch.gather(sigma, 1, srcl),
                                    0.0), "add", identity=0.0)
        recv = comm.exchange_sum(acc)                 # (P, n_local) f32
        newly = (recv > 0) & (dist == INT_INF)
        dist = torch.where(newly, level, dist)
        sigma = sigma + torch.where(newly, recv, 0.0)
        cnt = comm.psum_scalar(newly.sum(dim=1, dtype=torch.int32))
        return dist, sigma, newly, level + 1, cnt

    def guard(g, prev, state):
        # levels adopt once (non-increasing from INT_INF), path counts
        # finite, non-negative and non-decreasing
        dist, sigma, _, level, cnt = state
        return (dist >= 0).all() & (dist <= prev[0]).all() \
            & torch.isfinite(sigma).all() & (sigma >= prev[1]).all() \
            & (level >= prev[3]) & (cnt >= 0)

    return SuperstepProgram(
        name="betweenness", variant="forward", inputs=("root",),
        init=init, step=step,
        halt=lambda state: state[4] <= 0,
        outputs=lambda state: (state[0], state[1]),
        output_names=("dist", "sigma"), output_is_vertex=(True, True),
        comm=comm, max_rounds=max_levels, guard=guard)


def bc_backward_program(shards, comm: StackedComm,
                        max_levels: int = 64) -> SuperstepProgram:
    """Phase 2: dependency accumulation over the shortest-path DAG;
    ``init`` takes the forward phase's (dist, sigma)."""
    n, n_local = shards.n, shards.n_local
    ell_out = shards.ell("ell_out")

    def init(g, dist, sigma):
        delta0 = torch.zeros((comm.local_parts, n_local), dtype=torch.float32,
                             device=comm.device)
        dist_g = comm.broadcast_global(dist)          # loop-invariant (n,)
        return delta0, dist, sigma, dist_g, 1

    def step(g, state):
        delta, dist, sigma, dist_g, _ = state
        coef = torch.where(sigma > 0, (1.0 + delta)
                           / torch.clamp(sigma, min=1.0), 0.0)
        coef_g = comm.broadcast_global(coef)          # (n,) pull replica
        srcl, dst = g["out_src_local"], g["out_dst_global"]
        valid = dst < n
        safe_dst = torch.where(valid, dst, 0)
        deeper = valid & (torch.gather(dist_g, 1, safe_dst)
                          == torch.gather(dist, 1, srcl) + 1)
        contrib = torch.where(deeper, torch.gather(coef_g, 1, safe_dst), 0.0)
        s = localops.scatter_combine(g, ell_out, contrib, "add",
                                     identity=0.0)
        new_delta = sigma * s
        changed = comm.psum_scalar((new_delta != delta).sum(
            dim=1, dtype=torch.int32))
        return new_delta, dist, sigma, dist_g, changed

    def outputs(state):
        delta, dist, sigma, _, _ = state
        bc = torch.where(dist == 0, 0.0, delta)       # delta_s(s) := 0
        return bc, sigma, dist

    def guard(g, prev, state):
        # dependencies are sums of non-negative terms: finite and
        # non-negative (a NaN coefficient broadcast lands in delta); the
        # forward fields stay bit-frozen
        delta, dist, sigma, _, changed = state
        return torch.isfinite(delta).all() & (delta >= 0).all() \
            & (dist == prev[1]).all() & (sigma == prev[2]).all() \
            & (changed >= 0)

    return SuperstepProgram(
        name="betweenness", variant="backward", inputs=(),
        init=init, step=step,
        halt=lambda state: state[4] <= 0,
        outputs=outputs,
        output_names=("bc", "sigma", "dist"),
        output_is_vertex=(True, True, True),
        comm=comm, max_rounds=max_levels, guard=guard)


def betweenness_program(shards, comm: StackedComm,
                        max_levels: int = 64) -> PhasedProgram:
    """Forward + backward Brandes as ONE phased program."""
    return PhasedProgram(
        name="betweenness", variant="default", inputs=("root",),
        phases=(bc_forward_program(shards, comm, max_levels),
                bc_backward_program(shards, comm, max_levels)),
        output_names=("bc", "sigma", "dist"),
        output_is_vertex=(True, True, True))
