"""Distributed triangle counting via a rotated bit-packed neighbor-set
exchange.

Semantics: triangles of the SIMPLE UNDIRECTED graph underlying the edge
list (parallel edges deduplicated, self-loops dropped).

Each part holds its vertices' neighbor SETS as bit-packed rows ((n/32,)
int32 words, the ``bfs/fast`` frontier's wire format).  Each superstep
shifts the packed adjacency block one part along the ring
(``StackedComm.shift``, the JAX package's ``ppermute``), so after P
rounds every part has met every other part's rows: P supersteps, each
moving n * n_local / 8 bytes a part.  The intersection is a masked dense
matrix product: unpack both blocks to 0/1 and take one
``(n_local, n) x (n, n_local)`` product per round.

Counting: with A the symmetric 0/1 adjacency,
``2 * tri(u) = sum_v A[u, v] * (A @ A)[u, v]`` and the global count is
``sum_u tri(u) / 3``.  The products and sums run in float64, so the
counts are exact integers whatever torch's TF32 setting is.  The bitmap
is O(n^2 / P) memory: the registry's ``n_budget`` keeps the launcher
from running it on larger graphs.
"""

from __future__ import annotations

import torch

from repro_torch.core.partitioned import StackedComm, pack_bits, \
    unpack_bits
from repro_torch.core.superstep import SuperstepProgram


def _pack_rows(dense: torch.Tensor) -> torch.Tensor:
    """(..., m, n) 0/1 -> (..., m, n/32) int32 bit rows."""
    return pack_bits(dense.to(torch.bool))


def _unpack_rows(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(..., m, n/32) int32 -> (..., m, n) float64 0/1 rows."""
    return unpack_bits(bits, n).to(torch.float64)


def _sym_adjacency_bits(g, comm: StackedComm, n: int, n_local: int):
    """Bit-packed symmetric dedup'd adjacency rows of each part's local
    vertices, (P, n_local, n/32): row u holds {v : u->v or v->u},
    self-loops excluded (parallel edges set the same bit)."""
    lo = comm.lo(n_local)
    dense = torch.zeros((comm.local_parts, n_local * (n + 1)), dtype=torch.uint8,
                        device=comm.device)       # slop column n: sentinel
    srcl, dst = g["out_src_local"], g["out_dst_global"]
    keep = (dst < n) & (dst != srcl + lo)
    src, dstl = g["in_src_global"], g["in_dst_local"]
    keep_in = (src < n) & (src != dstl + lo)
    for row, col, ok in ((srcl, dst, keep), (dstl, src, keep_in)):
        slot = row.long() * (n + 1) + torch.where(ok, col, n).long()
        dense.scatter_(1, slot, 1)
    dense = dense.reshape(comm.local_parts, n_local, n + 1)[:, :, :n]
    return _pack_rows(dense)


def triangles_program(n: int, n_local: int,
                      comm: StackedComm) -> SuperstepProgram:
    """Rotation triangle counting as a superstep program.

    Outputs: per-vertex triangle counts (vertex field) and the global
    triangle total (a host int).  Runs exactly P supersteps."""
    parts = n // n_local

    def prepare(g):
        g = dict(g)
        g["adj_bits"] = _sym_adjacency_bits(g, comm, n, n_local)
        return g

    def init(g, *_):
        tri2 = torch.zeros((comm.local_parts, n_local), dtype=torch.float64,
                           device=comm.device)
        return g["adj_bits"], tri2, 0

    def step(g, state):
        block, tri2, r = state
        if r < parts:                          # no-op past P rounds
            a = _unpack_rows(g["adj_bits"], n)     # (L, n_local, n) mine
            b = _unpack_rows(block, n)             # block q's rows
            common = torch.bmm(a, b.transpose(1, 2))  # |N(u) ^ N(v)|
            # round r: part me holds block q = (me - r) mod P, so each
            # part's gate columns start at its own q * n_local
            row, me = comm.own_index()
            q = (me - r) % parts
            gate = a.reshape(comm.local_parts, n_local, parts,
                             n_local)[row, :, q]
            tri2 = tri2 + (gate * common).sum(dim=2)
        return comm.shift(block, words=True), tri2, r + 1

    def outputs(state):
        tri2 = state[1]
        tri = (tri2 / 2.0).to(torch.int32)
        total = int(comm.psum_scalar(tri2.sum(dim=1)) / 6.0 + 0.5)
        return tri, total

    def guard(g, prev, state):
        # per-vertex double counts add non-negative intersections: finite
        # and non-decreasing.  The rotated block is bitmap data, which
        # only the transport stamps check
        tri2 = state[1]
        return torch.isfinite(tri2).all() & (tri2 >= prev[1]).all()

    return SuperstepProgram(
        name="triangles", variant="default", inputs=(),
        prepare=prepare, init=init, step=step,
        halt=lambda state: state[2] >= parts,
        outputs=outputs,
        output_names=("triangles", "total"), output_is_vertex=(True, False),
        comm=comm, max_rounds=parts, guard=guard)
