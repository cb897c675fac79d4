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
    ``err_every`` iterations.  ``pagerank/warm`` is the same program
    seeded from a rank field.
``pagerank/async`` -- bounded-staleness push: a fresh own-part term
    every round, the remote term refreshed every ``staleness`` rounds by
    the double-buffered reduce-scatter with the residual piggybacked.

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
from repro_torch.core.partitioned import StackedComm, part_sums
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    SuperstepProgram

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


def _rank_mass_ok(comm: StackedComm, rank: torch.Tensor, n: int,
                  n_orig: int, margin: float):
    """Mass-conservation invariant of the guards.

    Rank mass starts at ``n / n_orig`` (padded tail vertices carry 1 /
    n_orig in the cold variants) and only shrinks toward the fixed point
    >= 1 - alpha, so a round's global mass lies in ``((1 - alpha) * 0.9,
    n / n_orig * margin)``; ``margin`` absorbs transient overshoot (bf16
    error feedback, stale remote terms).  A dropped, duplicated or
    corrupted contribution block moves the mass out of the band, and NaN
    fails the non-negativity check.  A bool tensor: the mass term is
    global, the sign term per part."""
    mass = comm.sum_parts(part_sums(rank))
    cap = (1.0 + (n - n_orig) / n_orig) * margin
    return (rank >= 0).all() & (mass > (1.0 - ALPHA) * 0.9) & (mass < cap)


def _uniform(comm: StackedComm, n_local: int, n_orig: int) -> torch.Tensor:
    """The cold (L, n_local) float32 rank, 1 / n_orig everywhere."""
    return torch.full((comm.local_parts, n_local), 1.0 / n_orig,
                      dtype=torch.float32, device=comm.device)


def pagerank_bsp_program(shards, comm: StackedComm, iters: int = 50,
                         tol: float = 1e-6) -> SuperstepProgram:
    """BGL-style pull PageRank (ghost replication via all-gather)."""
    n, n_local, n_orig = shards.n, shards.n_local, shards.n_orig
    ell_in = shards.ell("ell_in")
    base = (1.0 - ALPHA) / n_orig
    tol32 = _f32(tol)

    def init(g, *_):
        return _uniform(comm, n_local, n_orig), 1.0

    def step(g, state):
        rank, _ = state
        contrib = _local_contrib(rank, g["out_degree"])
        cg = comm.broadcast_global(contrib)         # all-gather (n,) f32
        z = localops.spmv_pull(g, ell_in, cg)       # local SpMV (pull)
        new_rank = _rank_update(base, z)
        err = comm.psum_scalar(part_sums((new_rank - rank).abs()))
        return new_rank, err

    def guard(g, prev, state):
        rank, err = state
        return _rank_mass_ok(comm, rank, n, n_orig, 1.02) & (err >= 0)

    return SuperstepProgram(
        name="pagerank", variant="bsp", inputs=(),
        init=init, step=step,
        halt=lambda state: state[1] <= tol32,
        outputs=lambda state: (state[0], state[1]),
        output_names=("rank", "err"), output_is_vertex=(True, False),
        comm=comm, max_rounds=iters, guard=guard,
        probe_names=("err",), probe=lambda state: (state[1],))


def pagerank_fast_program(shards, comm: StackedComm, iters: int = 50,
                          tol: float = 1e-6, compress=True,
                          switch_factor: float = 1e3,
                          err_every: int = 5,
                          seeded: bool = False) -> SuperstepProgram:
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

    With ``seeded=True`` it is the ``pagerank/warm`` variant: init adopts
    a ``rank0`` vertex field (a previous epoch's ranks).  Power iteration
    contracts to ONE fixed point, so any seed is exact at convergence; a
    near-fixed-point seed reaches tol in fewer rounds.
    """
    n, n_local, n_orig = shards.n, shards.n_local, shards.n_orig
    ell_dst = shards.ell("ell_dst")
    base = (1.0 - ALPHA) / n_orig
    tol32 = _f32(tol)
    # switch no later than the bf16 noise floor (sum|delta| ~ 3e-3 for
    # rank mass 1), else a tight tol would never leave the compressed
    # regime
    switch_at = _f32(max(switch_factor * tol, 3e-3))

    def init(g, *inputs):
        if seeded:
            (rank_in,) = inputs
            # padded tail vertices are edgeless and never gathered: zero
            # them so the seed's value there is irrelevant
            rank0 = torch.where(comm.gid(n_local) < n_orig, rank_in.float(),
                                0.0)
        else:
            rank0 = _uniform(comm, n_local, n_orig)
        resid0 = torch.zeros((comm.local_parts, n), dtype=torch.float32,
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
            err = comm.psum_scalar(part_sums((new_rank - rank).abs()))
        else:
            err = err_prev
        return new_rank, new_resid, err, it + 1

    def guard(g, prev, state):
        rank, resid, err, it = state
        return _rank_mass_ok(comm, rank, n, n_orig, 1.02) \
            & torch.isfinite(resid).all() & (err >= 0) & (it >= 0)

    return SuperstepProgram(
        name="pagerank", variant="warm" if seeded else "fast",
        inputs=("rank0",) if seeded else (),
        init=init, step=step,
        halt=lambda state: state[2] <= tol32,
        outputs=lambda state: (state[0], state[2]),
        output_names=("rank", "err"), output_is_vertex=(True, False),
        comm=comm, max_rounds=iters, guard=guard,
        probe_names=("err",), probe=lambda state: (state[2],))


def pagerank_async_program(shards, comm: StackedComm, iters: int = 64,
                           tol: float = 1e-6,
                           staleness: int = 1) -> AsyncSuperstepProgram:
    """Bounded-staleness push PageRank on the double-buffered exchange.

    Each round computes ``rank = base + alpha * (own + remote)``: the
    own-part term is fresh every round, the remote term is the snapshot
    the reduce-scatter delivered, refreshed only every ``staleness``
    rounds.  Between refreshes no exchange runs.  At a refresh the
    exchange in flight since the previous one is finished and the next
    started, with each part's residual ``sum |delta rank|`` piggybacked,
    so convergence needs no separate all-reduce: one host sync a refresh.

    The remote term used in any round derives from ranks at most
    ``2 * staleness + 1`` rounds old; the program tracks the realized
    maximum and returns it as ``max_age``.  Power iteration is an alpha-
    contraction with one fixed point, so the stale iteration converges to
    the BSP answer.
    """
    n, n_local, n_orig = shards.n, shards.n_local, shards.n_orig
    ell_dst = shards.ell("ell_dst")
    base = (1.0 - ALPHA) / n_orig
    tol32 = _f32(tol)
    if staleness < 1:
        raise ValueError(f"staleness must be >= 1, got {staleness}")

    def _contrib_acc(g, rank):
        """(own (L, n_local), ship (L, n)): the push accumulator's own
        block, and the accumulator with that block zeroed for shipping
        (the exchange delivers purely remote contributions)."""
        srcl = g["out_src_local"]
        valid = g["out_dst_global"] < n
        contrib = _local_contrib(rank, g["out_degree"])
        acc = localops.scatter_combine(
            g, ell_dst, torch.where(valid, torch.gather(contrib, 1, srcl),
                                    0.0), "add", identity=0.0)
        own = comm.own_slice(acc)
        comm.zero_own(acc)
        return own, acc

    def init(g):
        rank0 = _uniform(comm, n_local, n_orig)
        _, ship0 = _contrib_acc(g, rank0)
        # the residual column ships 1.0 per part, so halt cannot fire
        # before a real residual arrives
        handle0 = comm.exchange_sum_start(ship0, 1.0)
        zeros = torch.zeros((comm.local_parts, n_local), dtype=torch.float32,
                            device=comm.device)
        return (rank0, zeros, ship0, 1.0, 1.0, 0, 1, 1, 1), handle0

    def local(g, state):
        rank, remote, _, _, err_g, it, age_cur, age_infl, max_age = state
        own, ship = _contrib_acc(g, rank)
        new_rank = _rank_update(base, own + remote)
        err_local = part_sums((new_rank - rank).abs())
        return (new_rank, remote, ship, err_local, err_g, it, age_cur,
                age_infl, max(max_age, age_cur))

    def fold(g, state, handle):
        (rank, remote, ship, err_local, err_g, it,
         age_cur, age_infl, max_age) = state
        if it % staleness == 0:
            remote, err_glob = comm.exchange_sum_finish(handle)
            handle = comm.exchange_sum_start(ship, err_local)
            # the round's one sync: the delivered global residual
            err_g = err_glob[0].item()
            # the delivered snapshot was shipped age_infl rounds ago, +1
            # for this round; the fresh payload is one round old
            age_cur, age_infl = age_infl + 1, 1
        else:
            age_cur, age_infl = age_cur + 1, age_infl + 1
        return (rank, remote, ship, err_local, err_g, it + 1, age_cur,
                age_infl, max_age), handle

    def guard(g, prev, state):
        # looser mass margin: the remote term lags the own term by up to
        # 2 * staleness + 1 rounds, so transient overshoot is larger
        rank, remote, ship = state[0], state[1], state[2]
        return _rank_mass_ok(comm, rank, n, n_orig, 1.05) \
            & torch.isfinite(remote).all() & (remote >= 0).all() \
            & torch.isfinite(ship).all() & (ship >= 0).all() \
            & (state[3] >= 0) & (state[4] >= 0) \
            & (state[6] >= 0) & (state[7] >= 0) & (state[8] >= 0)

    return AsyncSuperstepProgram(
        name="pagerank", variant="async", inputs=(),
        init=init, local=local, fold=fold,
        halt=lambda state: state[4] <= tol32,
        outputs=lambda g, state: (state[0], state[4], state[8]),
        output_names=("rank", "err", "max_age"),
        output_is_vertex=(True, False, False), comm=comm,
        max_rounds=iters, guard=guard,
        probe_names=("err",), probe=lambda state: (state[4],))
