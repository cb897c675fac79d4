"""Distributed PageRank: BSP baseline (BGL-style) and the HPX-adapted
optimized implementation.

Paper mapping (SS4.2) - the three phases per iteration:
  1. Contribution accumulation: contrib[i] = rank[i] / out_degree[i];
     local neighbors applied directly, remote ones shipped to the owner.
  2. Rank update: rank[i] = base + alpha * z.
  3. Error computation: sum |rank_new - rank_old| (convergence).

``pagerank/bsp``  -- pull over in-edges after ALL-GATHERING the full (n,)
    f32 contribution vector every iteration (the ghost-replication
    pattern of distributed BGL), plus a separate error all-reduce.
``pagerank/fast`` -- push-aggregate: each part segment-sums its local
    edges' contributions into a length-n accumulator and ONE
    reduce-scatter delivers owner slices (the paper's "remote
    contribution applied atomically at the owner", batched).  The
    exchange payload is bf16 with an error-feedback residual (2x less
    wire) while the error is large, and the error all-reduce runs every
    ``err_every`` iterations.

The local segment-sum is the SpMV hot spot; it routes through
``core/localops.py`` (``spmv_pull`` over ``ell_in`` for the pull
variant, ``scatter_combine`` over ``ell_dst`` for the push variant):
the CUDA spmv_ell kernel serves it on the card.

Scalars that the JAX package keeps as float32 device values (``tol``,
the error, the compression switch point) are compared here as float32
values on the host, so halt and switch decisions match it exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import localops
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram

ALPHA = 0.85


def _f32(x) -> float:
    """Round a host number to float32, as a float32 device scalar holds it."""
    return float(np.float32(x))


def _rank_update(base: float, z: torch.Tensor) -> torch.Tensor:
    """``base + ALPHA * z`` in float32 with ONE rounding, as the fused
    multiply-add XLA contracts it into: the float64 product of two
    float32 values is exact, and the float64 sum rounds once more only
    in the rare double-rounding case."""
    return (_f32(ALPHA) * z.double() + _f32(base)).float()


def _local_contrib(rank, out_degree):
    return torch.where(out_degree > 0, rank / out_degree.float(), 0.0)


def pagerank_bsp_program(shards, comm: StackedComm, iters: int = 50,
                         tol: float = 1e-6) -> SuperstepProgram:
    """BGL-style pull PageRank (ghost replication via all-gather)."""
    n_local, n_orig = shards.n_local, shards.n_orig
    ell_in = shards.ell("ell_in")
    base = (1.0 - ALPHA) / n_orig
    tol32 = _f32(tol)

    def init(g, *_):
        rank0 = torch.full((comm.parts, n_local), 1.0 / n_orig,
                           dtype=torch.float32, device=comm.device)
        return rank0, 1.0

    def step(g, state):
        rank, _ = state
        contrib = _local_contrib(rank, g["out_degree"])
        cg = comm.broadcast_global(contrib)         # all-gather (n,) f32
        z = localops.spmv_pull(g, ell_in, cg)       # local SpMV (pull)
        new_rank = _rank_update(base, z)
        err = comm.psum_scalar((new_rank - rank).abs().sum(dim=1))
        return new_rank, err

    return SuperstepProgram(
        name="pagerank", variant="bsp", inputs=(),
        init=init, step=step,
        halt=lambda state: state[1] <= tol32,
        outputs=lambda state: (state[0], state[1]),
        output_names=("rank", "err"), output_is_vertex=(True, False),
        comm=comm, max_rounds=iters)


def pagerank_fast_program(shards, comm: StackedComm, iters: int = 50,
                          tol: float = 1e-6, compress=True,
                          switch_factor: float = 1e3,
                          err_every: int = 5) -> SuperstepProgram:
    """Push-aggregate PageRank with a reduce-scatter exchange and
    ADAPTIVE bf16 error-feedback compression.

    While the iteration error is far from tol, the exchange ships bf16
    (2x less wire, the error-feedback residual keeps the average
    unbiased); once err <= max(switch_factor * tol, 3e-3) the loop ships
    fp32 so convergence reaches the exact fixed point.
    ``compress="always"`` ships bf16 every round, ``False`` never.

    The convergence check (a global barrier) runs every ``err_every``
    iterations instead of every iteration, at the cost of up to
    err_every-1 extra iterations.
    """
    n, n_local, n_orig = shards.n, shards.n_local, shards.n_orig
    ell_dst = shards.ell("ell_dst")
    base = (1.0 - ALPHA) / n_orig
    tol32 = _f32(tol)
    # switch no later than the bf16 noise floor (sum|delta| ~ 3e-3 for
    # rank mass 1), else a tight tol would never leave the compressed
    # regime
    switch_at = _f32(max(switch_factor * tol, 3e-3))

    def init(g, *_):
        rank0 = torch.full((comm.parts, n_local), 1.0 / n_orig,
                           dtype=torch.float32, device=comm.device)
        resid0 = torch.zeros((comm.parts, n), dtype=torch.float32,
                             device=comm.device)
        return rank0, resid0, 1.0, 0

    def step(g, state):
        rank, resid, err_prev, it = state
        srcl = g["out_src_local"]                   # (P, E) local
        valid = g["out_dst_global"] < n             # (P, E) sentinel n
        contrib = _local_contrib(rank, g["out_degree"])
        # local segment-sum into a length-n accumulator (SpMV push)
        acc = localops.scatter_combine(
            g, ell_dst, torch.where(valid, torch.gather(contrib, 1, srcl),
                                    0.0), "add", identity=0.0)
        if compress == "always" or (compress and err_prev > switch_at):
            # error-feedback quantization: ship bf16 (round to nearest
            # even), keep the residual
            full = acc + resid
            payload = full.to(torch.bfloat16)
            new_resid = full - payload.float()
            z = comm.exchange_sum(payload).float()
        else:
            z = comm.exchange_sum(acc + resid)
            new_resid = torch.zeros_like(resid)
        new_rank = _rank_update(base, z)
        if (it + 1) % err_every == 0:
            err = comm.psum_scalar((new_rank - rank).abs().sum(dim=1))
        else:
            err = err_prev
        return new_rank, new_resid, err, it + 1

    return SuperstepProgram(
        name="pagerank", variant="fast", inputs=(),
        init=init, step=step,
        halt=lambda state: state[2] <= tol32,
        outputs=lambda state: (state[0], state[2]),
        output_names=("rank", "err"), output_is_vertex=(True, False),
        comm=comm, max_rounds=iters)
