"""Incremental recompute programs and their cold seeds.

The registered incremental variants (pagerank/warm, cc/incremental,
kcore/incremental) share one property: each is EXACT from its cold seed
(:func:`cold_seed`), and a warm seed from a previous snapshot epoch is
only adopted when the mutations since then keep it exact
(``registry.IncrementalSpec.mutations``).  Correctness never depends on
the seed, only the round count does.

``kcore/incremental`` lives here: local support-decrement peeling.  A
vertex's SUPPORT under an assignment ``c`` is the number of incident
non-loop edges (multigraph, both directions) whose other endpoint ``u``
has ``c[u] >= c[v]``.  Each superstep decrements every vertex whose
support is below its value:

    cnt[v] = #{incident edges (u, v) : c[u] >= c[v]}
    c[v]  <- c[v] - 1   where cnt[v] < c[v]

From ANY pointwise upper bound on the core numbers this converges to
exactly the core numbers: ``c >= core`` is preserved (a vertex at its
core number k has k neighbors in the k-core, each with ``c >= k``), and
a fixed point is feasible, hence ``<= core``.  Valid upper bounds: the
undirected degree (the cold start, plain peeling) and, after delete-only
mutations, the previous epoch's core numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import localops
from repro_torch.core.graph import GraphShards
from repro_torch.core.partitioned import StackedComm
from repro_torch.core.superstep import SuperstepProgram

# numpy dtype of each vertex-field input kind (registry.INPUT_KINDS)
KIND_DTYPES = {"vertex_i32": np.int32, "vertex_f32": np.float32}


def kcore_incremental_program(shards, comm: StackedComm,
                              max_rounds: int = 2048) -> SuperstepProgram:
    """Support-decrement k-core peeling from a seed upper bound.

    Input ``core0``: a per-vertex upper bound on the core numbers
    (vertex_i32).  Outputs match ``kcore/default`` (``core``, ``kmax``).
    """
    n, n_local, n_orig = shards.n, shards.n_local, shards.n_orig
    ell_dst = shards.ell("ell_dst")
    ell_src = shards.ell("ell_src")

    def init(g, core0):
        # padded tail vertices are edgeless (core 0); real seeds clamp at
        # zero so any non-negative field is a usable bound
        return torch.where(comm.gid(n_local) < n_orig,
                           core0.to(torch.int32).clamp_min(0), 0), 1

    def _support(cg, local, other, other_valid):
        """1 per valid non-loop edge whose other endpoint's value is at
        least this endpoint's (``local``, ``other``: (P, E) global ids)."""
        far = torch.gather(cg, 1, torch.where(other_valid, other, 0))
        return (other_valid & (other != local)
                & (torch.gather(cg, 1, local) >= far)).to(torch.int32)

    def step(g, state):
        c, _ = state
        lo = comm.lo(n_local)
        cg = comm.broadcast_global(c)                 # all-gather (n,) i32
        # support contributions, one per incident non-loop edge, posted
        # toward the endpoint being supported; both combines land in one
        # length-n sum and ONE exchange delivers the owners' counts
        dst, src = g["out_dst_global"], g["in_src_global"]
        sup_dst = _support(cg, g["out_src_local"] + lo, dst, dst < n)
        sup_src = _support(cg, g["in_dst_local"] + lo, src, src < n)
        acc = localops.scatter_combine(g, ell_dst, sup_dst, "add",
                                       identity=0)
        acc = acc + localops.scatter_combine(g, ell_src, sup_src, "add",
                                             identity=0)
        cnt = comm.exchange_sum(acc)
        new_c = torch.where(cnt < c, c - 1, c)
        changed = comm.psum_scalar((new_c < c).sum(dim=1,
                                                   dtype=torch.int32))
        return new_c, changed

    def outputs(state):
        c = state[0]
        return c, comm.max_scalar(c.amax(dim=1))

    def guard(g, prev, state):
        # support-decrement peeling: the assignment is non-negative and
        # non-increasing (decrements only); change count non-negative
        c, changed = state
        return (c >= 0).all() & (c <= prev[0]).all() & (changed >= 0)

    return SuperstepProgram(
        name="kcore", variant="incremental", inputs=("core0",),
        init=init, step=step,
        halt=lambda state: state[1] <= 0,
        outputs=outputs,
        output_names=("core", "kmax"), output_is_vertex=(True, False),
        comm=comm, max_rounds=max_rounds, guard=guard)


# ---------------------------------------------------------------------------
# cold seeds: exact-from-scratch starting vectors, computed on the host
# from the shard arrays.
# ---------------------------------------------------------------------------

def host_und_degree(g: GraphShards) -> np.ndarray:
    """(n,) undirected multigraph degree from the host shard arrays
    (self-loops dropped): the cold upper bound for k-core peeling.  One
    part's shards fill that part's block; the others stay 0, and no
    engine holding that part reads them."""
    first = 0 if g.part_index is None else g.part_index
    held = g.out_degree.shape[0]
    deg = np.zeros(g.n, np.int64)
    deg[first * g.n_local:(first + held) * g.n_local] = (
        g.out_degree.astype(np.int64)
        + g.in_degree.astype(np.int64)).reshape(-1)
    lo = (np.arange(first, first + held, dtype=np.int64)
          * g.n_local)[:, None]
    srcg = g.out_src_local.astype(np.int64) + lo
    is_loop = (g.out_dst_global < g.n) & (g.out_dst_global == srcg)
    loops = np.zeros(g.n, np.int64)
    np.add.at(loops, srcg[is_loop], 1)
    return deg - 2 * loops


def cold_seed(spec, g: GraphShards) -> tuple[np.ndarray, ...]:
    """Exact-from-scratch seed arrays ((n_orig,), kind dtypes) for an
    incremental program's vertex inputs: identity labels for cc, the
    degree bound for k-core, uniform mass for PageRank."""
    inc = spec.incremental
    if inc is None:
        raise ValueError(f"{spec.algo}/{spec.variant} is not incremental")
    if inc.seed_output == "labels":
        return (np.arange(g.n_orig, dtype=np.int32),)
    if inc.seed_output == "core":
        return (host_und_degree(g)[:g.n_orig].astype(np.int32),)
    if inc.seed_output == "rank":
        return (np.full(g.n_orig, 1.0 / g.n_orig, np.float32),)
    raise ValueError(f"no cold seed rule for output {inc.seed_output!r}")
