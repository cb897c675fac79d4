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
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram

F32_INF = 1e30   # exactly representable as float32's 1e30


def edge_weight(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-random float32 weight in [1, 2).

    The uint32 hash ``src * 2654435761 ^ dst * 40503`` (wrapping) in
    int64 arithmetic: ids are below 2**31, so the products fit, and only
    the low 16 bits, which the wrap does not touch, are used."""
    h = (src.long() * 2654435761) ^ (dst.long() * 40503)
    return 1.0 + (h & 0xFFFF).float() / float(1 << 16)


def sssp_program(shards, comm: StackedComm, max_rounds: int = 64,
                 weight_scale: float = 1.0) -> SuperstepProgram:
    """Frontier-pruned Bellman-Ford as a superstep program.

    ``weight_scale`` uniformly scales the synthesized edge weights (1.0
    reproduces the oracle's weights bit for bit); it must be finite and
    positive."""
    n, n_local = shards.n, shards.n_local
    ell_dst = shards.ell("ell_dst")

    def prepare(g):
        g = dict(g)
        g["out_weight"] = edge_weight(
            g["out_src_local"] + comm.lo(n_local), g["out_dst_global"]) \
            * torch.tensor(weight_scale, dtype=torch.float32)
        return g

    def init(g, root):
        root = int(root)
        lo = comm.lo(n_local)
        ids = torch.arange(n_local, dtype=torch.int32, device=comm.device)
        at_root = (root >= lo) & (root < lo + n_local) & (ids == root - lo)
        dist0 = torch.where(at_root, 0.0, F32_INF)
        return dist0, at_root, 1

    def step(g, state):
        dist, changed, _ = state
        srcl = g["out_src_local"]
        active = torch.gather(changed, 1, srcl) & (g["out_dst_global"] < n)
        # edge relaxation = MIN-combine of candidates keyed by dst
        prop = localops.scatter_combine(
            g, ell_dst, torch.where(active, torch.gather(dist, 1, srcl)
                                    + g["out_weight"], F32_INF),
            "min", identity=F32_INF)
        mine = comm.exchange_min_int(prop)
        new_dist = torch.minimum(dist, mine)
        new_changed = new_dist < dist
        cnt = comm.psum_scalar(new_changed.sum(dim=1, dtype=torch.int32))
        return new_dist, new_changed, cnt

    return SuperstepProgram(
        name="sssp", variant="default", inputs=("root",),
        prepare=prepare, init=init, step=step,
        halt=lambda state: state[2] <= 0,
        outputs=lambda state: (state[0],),
        output_names=("dist",), output_is_vertex=(True,),
        comm=comm, max_rounds=max_rounds)
