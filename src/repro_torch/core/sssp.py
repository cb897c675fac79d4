"""Distributed SSSP (Bellman-Ford with frontier pruning).

Edge weights are synthesized deterministically from endpoint ids
(uniform in [1, 2)); rounds relax only edges whose source distance
changed in the previous round (frontier pruning), with a MIN-combine
exchange.  The ``prepare`` hook derives the loop-invariant weight array
once, before the loop; rounds past convergence are no-ops (an empty
change set relaxes nothing), so the program is safe under
``static_iters``.

The weights and every distance equal the JAX package's bit for bit: the
hash keeps only its low 16 bits, ``1 + h / 2**16`` is exact in float32,
``dist[src] + w`` is one float32 rounding of the same operands, and the
MIN-combine does not depend on order.
"""

from __future__ import annotations

import torch

from repro_torch.core import localops
from repro_torch.core.monotone import monotone_async_program
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import AsyncSuperstepProgram, \
    SuperstepProgram

F32_INF = 1e30   # exactly representable as float32's 1e30


def edge_weight(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-random float32 weight in [1, 2).

    The uint32 hash ``src * 2654435761 ^ dst * 40503`` (wrapping) in
    int64 arithmetic: ids are below 2**31, so the products fit, and only
    the low 16 bits, which the wrap does not touch, are used."""
    h = (src.long() * 2654435761) ^ (dst.long() * 40503)
    return 1.0 + (h & 0xFFFF).float() / float(1 << 16)


def _weights(comm: StackedComm, n_local: int, weight_scale: float):
    """The ``prepare`` hook: the graph dict plus ``out_weight``, the
    loop-invariant (P, E) float32 edge weights."""
    def prepare(g):
        g = dict(g)
        g["out_weight"] = edge_weight(
            g["out_src_local"] + comm.lo(n_local), g["out_dst_global"]) \
            * torch.tensor(weight_scale, dtype=torch.float32,
                           device=comm.device)
        return g
    return prepare


def _seed(comm: StackedComm, root, n_local: int):
    """(dist0, at_root): 0 at the root's slot on its owner, F32_INF
    elsewhere."""
    root = int(root)
    lo = comm.lo(n_local)
    ids = torch.arange(n_local, dtype=torch.int32, device=comm.device)
    at_root = (root >= lo) & (root < lo + n_local) & (ids == root - lo)
    return torch.where(at_root, 0.0, F32_INF), at_root


def _relax_prop(g, ell_dst, n: int, dist, active_src):
    """MIN-combine of ``dist[src] + w`` over the out-edges whose source
    is in ``active_src``, keyed by destination: (P, n)."""
    srcl = g["out_src_local"]
    active = torch.gather(active_src, 1, srcl) & (g["out_dst_global"] < n)
    return localops.scatter_combine(
        g, ell_dst, torch.where(active, torch.gather(dist, 1, srcl)
                                + g["out_weight"], F32_INF),
        "min", identity=F32_INF)


def sssp_program(shards, comm: StackedComm, max_rounds: int = 64,
                 weight_scale: float = 1.0) -> SuperstepProgram:
    """Frontier-pruned Bellman-Ford as a superstep program.

    ``weight_scale`` uniformly scales the synthesized edge weights (1.0
    reproduces the oracle's weights bit for bit); it must be finite and
    positive."""
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")

    def init(g, root):
        dist0, at_root = _seed(comm, root, n_local)
        return dist0, at_root, 1

    def step(g, state):
        dist, changed, _ = state
        # edge relaxation = MIN-combine of candidates keyed by dst
        mine = comm.exchange_min_int(_relax_prop(g, ell_dst, n, dist,
                                                 changed))
        new_dist = torch.minimum(dist, mine)
        new_changed = new_dist < dist
        cnt = comm.psum_scalar(new_changed.sum(dim=1, dtype=torch.int32))
        return new_dist, new_changed, cnt

    return SuperstepProgram(
        name="sssp", variant="default", inputs=("root",),
        prepare=_weights(comm, n_local, weight_scale), init=init,
        step=step,
        halt=lambda state: state[2] <= 0,
        outputs=lambda state: (state[0],),
        output_names=("dist",), output_is_vertex=(True,),
        comm=comm, max_rounds=max_rounds)


def sssp_async_program(shards, comm: StackedComm, max_rounds: int = 64,
                       local_iters: int = 1,
                       weight_scale: float = 1.0) -> AsyncSuperstepProgram:
    """Async Bellman-Ford on the double-buffered exchange.

    Distance relaxation is a monotone min-combine, so staleness is exact:
    a late or duplicated ``dist[u] + w`` is still an upper bound, and the
    async run reaches the BSP program's distances bit for bit.  The halt
    count rides the distance exchange (an integer, exact in the float32
    payload); the quiescence rule lives in ``core/monotone.py``.
    """
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")
    return monotone_async_program(
        name="sssp", inputs=("root",),
        init_vals=lambda g, root: _seed(comm, root, n_local),
        relax=lambda g, dist, frontier: _relax_prop(g, ell_dst, n, dist,
                                                    frontier),
        outputs=lambda g, dist: (dist,), output_names=("dist",),
        output_is_vertex=(True,), n=n, n_local=n_local, inf=F32_INF,
        comm=comm, local_iters=local_iters, max_rounds=max_rounds,
        prepare=_weights(comm, n_local, weight_scale))
