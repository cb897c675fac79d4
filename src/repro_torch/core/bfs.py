"""Distributed BFS: BSP baseline (PBGL-style) and the HPX-adapted
direction-optimizing implementation.

Paper mapping (SS4.1):
  * Listing 1.2 spawns an async task per remote discovery and relies on
    ``set_parent``'s compare_exchange for atomicity.  The bulk adaptation
    aggregates all remote discoveries of a superstep into ONE exchange,
    and replaces CAS with an idempotent MIN-combine (smallest-id parent
    wins deterministically).
  * ``bfs/bsp``  -- level-synchronous push; every level exchanges a full
    (n,) int32 parent-proposal vector (MIN combine) + a separate
    frontier-count all-reduce: the rigid-barrier BGL analogue.
  * ``bfs/fast`` -- direction-optimizing (push/pull chosen per level by
    frontier occupancy = the paper's runtime adaptivity), BIT-PACKED
    frontier exchange (n/32 words: 32x less wire than the baseline), and
    parents derived owner-side from in-edges (no parent traffic).
  * ``bfs/async`` -- levels by monotone min-combine on the
    double-buffered exchange (``core/monotone.py``), the halt count
    riding the level payload; parents derived once after convergence.

The per-level local edge work routes through ``core/localops.py``: the
push-combine is ``scatter_combine`` over ``ell_dst`` and owner-side
parent derivation is ``frontier_pull`` over ``ell_in`` (the CUDA
bfs_pull kernel on the card).  Every tensor carries the leading parts
dim of ``partitioned.StackedComm``.
"""

from __future__ import annotations

import torch

from repro_torch.core import localops
from repro_torch.core.monotone import monotone_async_program
from repro_torch.core.partitioned import StackedComm, pack_bits, \
    unpack_bits
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    SuperstepProgram

INT_INF = 2 ** 30


def _derive_parents(g, ell_in, gf_packed, unvisited):
    """Owner-side parent derivation by pulling over local in-edges.

    For every local unvisited vertex, find the min-id in-neighbor that is
    in the current global frontier. Returns (new_mask, parent_prop).
    """
    prop = localops.frontier_pull(g, ell_in, gf_packed, unvisited)
    new_mask = (prop < INT_INF) & unvisited
    return new_mask, prop


def _bsp_level(comm, g, ell_dst, n, n_local, parents, frontier):
    """One BSP level: full (n,) parent-proposal exchange via MIN."""
    srcl = g["out_src_local"]
    dst = g["out_dst_global"]
    active = torch.gather(frontier, 1, srcl) & (dst < n)
    src_g = srcl + comm.lo(n_local)
    prop = localops.scatter_combine(
        g, ell_dst, torch.where(active, src_g, INT_INF), "min",
        identity=INT_INF)
    # exchange: every part contributes proposals for every vertex
    mine = comm.exchange_min_int(prop)             # (P, n_local)
    unvisited = parents == INT_INF
    new_mask = (mine < INT_INF) & unvisited
    parents = torch.where(new_mask, mine, parents)
    # separate global barrier: frontier population count
    count = comm.psum_scalar(new_mask.sum(dim=1, dtype=torch.int32))
    return parents, new_mask, count


def _fast_level(comm, g, ell_in, parents, gf_packed):
    """One direction-optimizing (pull) level with bit-packed exchange."""
    unvisited = parents == INT_INF
    new_mask, prop = _derive_parents(g, ell_in, gf_packed, unvisited)
    parents = torch.where(new_mask, prop, parents)
    # pack local next frontier; all-gather the global bitmap (n/32 words)
    gf_next = comm.broadcast_global(pack_bits(new_mask))
    count = comm.psum_scalar(new_mask.sum(dim=1, dtype=torch.int32))
    return parents, gf_next, count


def _fast_level_push(comm, g, ell_in, ell_dst, n, parents,
                     frontier_local, gf_packed):
    """Push variant: OR-combine candidate bits from active out-edges,
    then ship ONLY the packed candidate bitmap through the packed
    ``exchange_or``."""
    srcl = g["out_src_local"]
    dst = g["out_dst_global"]
    active = torch.gather(frontier_local, 1, srcl) & (dst < n)
    cand = localops.scatter_combine(g, ell_dst, active, "or",
                                    identity=False)        # (P, n) bool
    # activation bits for my slice; derive parents by pulling in-edges
    unvisited = parents == INT_INF
    activated = comm.exchange_or(cand) & unvisited
    # parent = min in-frontier in-neighbor of activated vertices
    _, prop = _derive_parents(g, ell_in, gf_packed, activated)
    new_mask = activated & (prop < INT_INF)
    parents = torch.where(new_mask, prop, parents)
    gf_next = comm.broadcast_global(pack_bits(new_mask))
    count = comm.psum_scalar(new_mask.sum(dim=1, dtype=torch.int32))
    return parents, new_mask, gf_next, count


def _seed_state(comm, root, n_local):
    """(parents0, frontier0) with only the owner's root slot set."""
    root = int(root)
    lo = comm.lo(n_local)
    owned = (root >= lo) & (root < lo + n_local)
    ids = torch.arange(n_local, dtype=torch.int32, device=comm.device)
    at_root = owned & (ids[None, :] == root - lo)
    parents0 = torch.where(at_root, root, INT_INF).to(torch.int32)
    return parents0, at_root


def bfs_bsp_program(shards, comm: StackedComm,
                    max_levels: int = 64) -> SuperstepProgram:
    """Level-synchronous BSP BFS (the rigid-barrier BGL analogue).

    Levels past convergence are natural no-ops (an empty frontier
    proposes nothing), so the program is safe under ``static_iters``.
    """
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")

    def init(g, root):
        parents0, frontier0 = _seed_state(comm, root, n_local)
        return parents0, frontier0, 1

    def step(g, state):
        parents, frontier, _ = state
        return _bsp_level(comm, g, ell_dst, n, n_local, parents, frontier)

    return SuperstepProgram(
        name="bfs", variant="bsp", inputs=("root",),
        init=init, step=step,
        halt=lambda state: state[2] <= 0,
        outputs=lambda state: (state[0],),
        output_names=("parents",), output_is_vertex=(True,),
        comm=comm, max_rounds=max_levels)


def bfs_fast_program(shards, comm: StackedComm, max_levels: int = 64,
                     pull_threshold: float = 0.02,
                     direction: str = "adaptive") -> SuperstepProgram:
    """Direction-optimizing BFS with bit-packed frontier exchange.

    ``direction`` pins the per-level push/pull choice: ``"adaptive"``
    (the paper's runtime adaptivity: push while the previous level's
    frontier count, already on the host from its barrier, is under
    ``pull_threshold * n``), ``"pull"``, or ``"push"``.  All three give
    identical parents (both branches derive parents with the same min-id
    ``frontier_pull``); they differ only in work and wire per level.
    """
    n, n_local = shards.n, shards.n_local
    ell_in = shards.ell("ell_in")
    ell_dst = shards.ell("ell_dst")
    thresh = max(1, int(n * pull_threshold))
    if direction not in ("adaptive", "pull", "push"):
        raise ValueError(f"direction must be adaptive|pull|push, "
                         f"got {direction!r}")

    def init(g, root):
        parents0, frontier0 = _seed_state(comm, root, n_local)
        gf0 = comm.broadcast_global(pack_bits(frontier0))
        return parents0, frontier0, gf0, 1

    def push(g, parents, frontier, gf):
        return _fast_level_push(comm, g, ell_in, ell_dst, n, parents,
                                frontier, gf)

    def pull(g, parents, gf):
        p, g2, c = _fast_level(comm, g, ell_in, parents, gf)
        # recover the local frontier from my slice of the packed bitmap
        f = unpack_bits(comm.own_slice(g2), n_local)
        return p, f, g2, c

    def step(g, state):
        parents, frontier, gf, count = state
        if direction == "push" or (direction == "adaptive"
                                   and count < thresh):
            return push(g, parents, frontier, gf)
        return pull(g, parents, gf)

    return SuperstepProgram(
        name="bfs", variant="fast", inputs=("root",),
        init=init, step=step,
        halt=lambda state: state[3] <= 0,
        outputs=lambda state: (state[0],),
        output_names=("parents",), output_is_vertex=(True,),
        comm=comm, max_rounds=max_levels)


def bfs_async_program(shards, comm: StackedComm, max_levels: int = 64,
                      local_iters: int = 1) -> AsyncSuperstepProgram:
    """Async BFS on the double-buffered exchange.

    Per-level parent proposals do not survive staleness (a stale frontier
    can propose a parent one level too deep), so the async variant
    computes LEVELS by monotone min-combine (unit-weight SSSP), with the
    halt count piggybacked on the level exchange, and then derives the
    parents in one ``pull_min_eq`` over in-edges: the min-id in-neighbor
    one level up, the BSP variants' rule, from exact levels.
    """
    n, n_local = shards.n, shards.n_local
    ell_in = shards.ell("ell_in")
    ell_dst = shards.ell("ell_dst")

    def init_vals(g, root):
        _, at_root = _seed_state(comm, root, n_local)
        return torch.where(at_root, 0, INT_INF).to(torch.int32), at_root

    def relax(g, level, frontier):
        srcl = g["out_src_local"]
        active = torch.gather(frontier, 1, srcl) & (g["out_dst_global"] < n)
        return localops.scatter_combine(
            g, ell_dst,
            torch.where(active, torch.gather(level, 1, srcl) + 1, INT_INF),
            "min", identity=INT_INF)

    def outputs(g, level):
        # parent of v = min-id in-neighbor exactly one level up; the root
        # (level 0) is its own parent, unreached rows stay INT_INF (their
        # target INT_INF - 1 matches no real level)
        prop = localops.pull_min_eq(g, ell_in, comm.broadcast_global(level),
                                    level - 1)
        return (torch.where(level == 0, comm.gid(n_local), prop),)

    return monotone_async_program(
        name="bfs", inputs=("root",), init_vals=init_vals, relax=relax,
        outputs=outputs, output_names=("parents",),
        output_is_vertex=(True,), n=n, n_local=n_local, inf=INT_INF,
        comm=comm, local_iters=local_iters, max_rounds=max_levels)
