"""Local-ops dispatch: the superstep work bundle of every program.

``core/partitioned.py`` owns the exchanges; this module owns the local
edge work between them.  Every program hot loop routes through one of
three primitives, each over stacked ``(P, ...)`` tensors:

  ``spmv_pull(g, ell, x)``
      y[v] = sum over in-neighbors u of v of x[u]  (PageRank pull).
  ``frontier_pull(g, ell, bits, unvisited)``
      min-id in-neighbor of v present in the packed frontier bitmap, or
      INT_INF (owner-side BFS parent derivation).
  ``scatter_combine(g, ell, vals, op, identity=...)``
      combine per-edge values into a per-row accumulator with
      op in {add, min, max, or} - the generalized push combine.
  ``pull_min_eq(g, ell, xg, target)``
      min-id in-neighbor u of v with ``xg[u] == target[v]``, or INT_INF
      (bfs/async's parents from converged levels; ref and ell only).

Each primitive has THREE implementations:

  * ``ref``     the COO scatter over the padded (P, E) edge lists - the
                debugging baseline and the ``layout="coo"`` path.
  * ``ell``     dense per-bucket gather + row reduction over the
                blocked-ELL layout (``core/graph.py``), results returned
                to row order through the inverse-permutation GATHER.
  * ``kernel``  the CUDA kernels in ``repro_torch/kernels/{spmv,frontier}``,
                one launch per call over every ELL bucket and all P parts
                (f32 additive combines route through the SpMV kernel,
                frontier tests through the BFS pull kernel; min/max/or
                combines have no kernel and stay on the ell path).  The
                kernels never read a sentinel slot, so this route passes
                x, the bitmap and the edge values without a pad slot, and
                it gives the ell path's bits (both add a row's slots left
                to right).

Each primitive is a layer site, ``localops.<name>`` (``obs/spans.py``),
around every route.

Mode resolution: the ``REPRO_LOCALOPS`` env var (or :func:`set_mode`)
picks ``auto`` (default: the kernels for CUDA tensors, ``ell`` for CPU
tensors), ``ref``, ``ell`` or ``kernel``.  ``kernel`` on a CPU tensor
raises: there is no fallback.  When the graph dict carries no ELL arrays
(``layout="coo"``), every call takes ``ref`` regardless of mode.
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch

from repro_torch.core.graph import EllMeta
from repro_torch.kernels._ell import bucket_views
# row sums slot by slot, left to right: the order the JAX package's CPU
# row reduction adds in (the same bits), and the SpMV kernel's
from repro_torch.kernels.spmv.ref import sum_slots as _sum_slots
from repro_torch.obs.spans import spanned

INT_INF = 2 ** 30

MODES = ("auto", "ref", "ell", "kernel")
_MODE_OVERRIDE: str | None = None

# ref-path metadata: which COO key array feeds each ELL structure, and
# whether that key can carry the sentinel (needs a +1 drop row)
_COO_KEY = {
    "ell_out": ("out_src_local", False),
    "ell_dst": ("out_dst_global", True),
    "ell_src": ("in_src_global", True),
}


def set_mode(mode: str | None) -> None:
    """Process-wide override of the REPRO_LOCALOPS env var (None clears)."""
    global _MODE_OVERRIDE
    if mode is not None and mode not in MODES:
        raise ValueError(f"localops mode {mode!r} not in {MODES}")
    _MODE_OVERRIDE = mode


@contextmanager
def using(mode: str | None):
    """Run a block under ``set_mode(mode)``, restoring the previous
    override after it."""
    prev = _MODE_OVERRIDE
    set_mode(mode)
    try:
        yield
    finally:
        set_mode(prev)


def get_mode() -> str:
    """The active dispatch mode: override > $REPRO_LOCALOPS > auto."""
    mode = _MODE_OVERRIDE or os.environ.get("REPRO_LOCALOPS", "auto")
    if mode not in MODES:
        raise ValueError(
            f"REPRO_LOCALOPS={mode!r} invalid; expected one of {MODES}")
    return mode


def resolve(mode: str | None = None, device="cpu") -> str:
    """Concrete implementation a call on ``device`` takes:
    ref | ell | kernel."""
    mode = mode or get_mode()
    if mode not in MODES:
        raise ValueError(f"localops mode {mode!r} not in {MODES}")
    is_cuda = torch.device(device).type == "cuda"
    if mode == "kernel" and not is_cuda:
        raise RuntimeError(
            "localops mode 'kernel' needs CUDA tensors; the kernels have "
            f"no CPU version (got device {device})")
    if mode == "auto":
        return "kernel" if is_cuda else "ell"
    return mode


def _has_ell(g: dict, ell: EllMeta) -> bool:
    return f"{ell.name}_idx" in g


def _gather_rows(x: torch.Tensor, blk: torch.Tensor) -> torch.Tensor:
    """x (P, m), blk (P, rows, k) int32 -> x[p, blk[p]] (P, rows, k)."""
    p, rows, k = blk.shape
    return torch.gather(x, 1, blk.reshape(p, rows * k)).reshape(p, rows, k)


def _to_rows(y: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    """(P, n_rows) results in ELL row order, back to row order."""
    return torch.gather(y, 1, inv)


def _scatter_add(out: torch.Tensor, key: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """out[p, key[p, e]] += vals[p, e], edge by edge in order."""
    parts, m = out.shape
    flat_key = (key.long() + torch.arange(parts, device=key.device)[:, None]
                * m).reshape(-1)
    return out.reshape(-1).index_add_(0, flat_key, vals.reshape(-1)) \
        .reshape(parts, m)


def _with_pad(x: torch.Tensor, value) -> torch.Tensor:
    """(P, m) -> (P, m + 1) with ``value`` in the sentinel slot m."""
    pad = torch.full((x.shape[0], 1), value, dtype=x.dtype, device=x.device)
    return torch.cat([x, pad], dim=1)


# ---------------------------------------------------------------------------
# spmv_pull
# ---------------------------------------------------------------------------

@spanned("spmv_pull", "localops")
def spmv_pull(g: dict, ell: EllMeta, x: torch.Tensor, *,
              mode: str | None = None) -> torch.Tensor:
    """y[p, row] = sum of x[p, neighbor] over the row's ELL slots, f32.

    ``x`` is (P, n); ``ell`` must be a neighbor-id structure
    (``ell_in``): slots hold GLOBAL vertex ids, the sentinel contributes
    0.  The ref path is the COO gather + scatter-add over the in-shard.
    """
    x = x.float()
    impl = resolve(mode, x.device)
    if impl == "ref" or not _has_ell(g, ell):
        src = g["in_src_global"]
        dstl = g["in_dst_local"]
        valid = src < ell.sentinel
        gathered = torch.where(
            valid, torch.gather(x, 1, torch.where(valid, src, 0)), 0.0)
        out = torch.zeros((x.shape[0], ell.n_rows), dtype=torch.float32,
                          device=x.device)
        return _scatter_add(out, dstl, gathered)

    idx = g[f"{ell.name}_idx"]
    if impl == "kernel":
        from repro_torch.kernels.spmv.kernel import spmv_ell_buckets
        return _to_rows(spmv_ell_buckets(idx, None, x, ell.buckets,
                                         skip=ell.sentinel),
                        g[f"{ell.name}_inv"])
    xk = _with_pad(x, 0.0)                     # sentinel slot reads 0
    outs = []
    for _, rows, k, blk in bucket_views(idx, ell.buckets):
        if k == 0:
            outs.append(torch.zeros((x.shape[0], rows), dtype=torch.float32,
                                    device=x.device))
        else:
            outs.append(_sum_slots(torch.where(blk != ell.sentinel,
                                               _gather_rows(xk, blk), 0.0)))
    return _to_rows(torch.cat(outs, dim=1), g[f"{ell.name}_inv"])


# ---------------------------------------------------------------------------
# frontier_pull
# ---------------------------------------------------------------------------

@spanned("frontier_pull", "localops")
def frontier_pull(g: dict, ell: EllMeta, bits: torch.Tensor,
                  unvisited: torch.Tensor, *,
                  mode: str | None = None) -> torch.Tensor:
    """Min-id in-neighbor of each row present in the packed frontier.

    ``bits`` is the (P, n/32) int32 global frontier bitmap of each part;
    ``unvisited`` a (P, n_rows) bool mask.  Returns (P, n_rows) int32,
    INT_INF where the row is visited or has no in-frontier neighbor.
    ``ell`` must be the neighbor-id structure (``ell_in``).
    """
    impl = resolve(mode, bits.device)
    n = ell.sentinel
    if impl == "ref" or not _has_ell(g, ell):
        src = g["in_src_global"]
        dstl = g["in_dst_local"]
        valid = src < n
        srcv = torch.where(valid, src, 0)
        word = torch.gather(bits, 1, srcv >> 5)
        hit = (((word >> (srcv & 31)) & 1) == 1) & valid \
            & torch.gather(unvisited, 1, dstl)
        out = torch.full((bits.shape[0], ell.n_rows), INT_INF,
                         dtype=torch.int32, device=bits.device)
        return out.scatter_reduce_(
            1, torch.where(hit, dstl, ell.n_rows - 1).long(),
            torch.where(hit, src, INT_INF), "amin")

    idx = g[f"{ell.name}_idx"]
    unv_ell = torch.gather(unvisited, 1, g[f"{ell.name}_perm"])
    if impl == "kernel":
        # the kernel reads one-byte flags and treats sentinel n as a miss
        from repro_torch.kernels.frontier.kernel import bfs_pull_buckets
        return _to_rows(bfs_pull_buckets(idx, bits, unv_ell, ell.buckets,
                                         skip=n),
                        g[f"{ell.name}_inv"])
    # sentinel n indexes one word past the bitmap: append a zero guard
    bits_g = _with_pad(bits, 0)
    outs = []
    for r0, rows, k, blk in bucket_views(idx, ell.buckets):
        if k == 0:
            outs.append(torch.full((bits.shape[0], rows), INT_INF,
                                   dtype=torch.int32, device=bits.device))
            continue
        word = _gather_rows(bits_g, blk >> 5)
        hit = ((word >> (blk & 31)) & 1) == 1
        cand = torch.where(hit, blk, INT_INF).amin(dim=2)
        outs.append(torch.where(unv_ell[:, r0:r0 + rows], cand, INT_INF))
    return _to_rows(torch.cat(outs, dim=1), g[f"{ell.name}_inv"])


# ---------------------------------------------------------------------------
# pull_min_eq
# ---------------------------------------------------------------------------

@spanned("pull_min_eq", "localops")
def pull_min_eq(g: dict, ell: EllMeta, xg: torch.Tensor,
                target: torch.Tensor, *,
                mode: str | None = None) -> torch.Tensor:
    """Min-id in-neighbor ``u`` of each row ``v`` with ``xg[u] ==
    target[v]``, or INT_INF when none matches.

    The level-keyed form of :func:`frontier_pull`: each row names the
    value it wants (``target``, e.g. ``level[v] - 1``), and slots whose
    global field ``xg`` (P, n) equals it qualify; bfs/async derives every
    level's parents in one pull.  ``ell`` must be the neighbor-id
    structure (``ell_in``).  No kernel applies, so modes ``kernel`` and
    ``auto`` take the ell path, as in the JAX package.
    """
    mode = mode or get_mode()
    if mode not in MODES:
        raise ValueError(f"localops mode {mode!r} not in {MODES}")
    n = ell.sentinel
    if mode == "ref" or not _has_ell(g, ell):
        src = g["in_src_global"]
        dstl = g["in_dst_local"]
        valid = src < n
        hit = valid & (torch.gather(xg, 1, torch.where(valid, src, 0))
                       == torch.gather(target, 1, dstl))
        out = torch.full((xg.shape[0], ell.n_rows), INT_INF,
                         dtype=torch.int32, device=xg.device)
        return out.scatter_reduce_(
            1, torch.where(hit, dstl, ell.n_rows - 1).long(),
            torch.where(hit, src, INT_INF), "amin")

    idx = g[f"{ell.name}_idx"]
    tgt_ell = torch.gather(target, 1, g[f"{ell.name}_perm"])
    # sentinel n indexes one slot past xg: append a guard no real target
    # equals (INT_INF; targets are levels < n, or INT_INF - 1 for
    # unreached rows)
    xg_g = _with_pad(xg, INT_INF)
    outs = []
    for r0, rows, k, blk in bucket_views(idx, ell.buckets):
        if k == 0:
            outs.append(torch.full((xg.shape[0], rows), INT_INF,
                                   dtype=torch.int32, device=xg.device))
            continue
        hit = _gather_rows(xg_g, blk) == tgt_ell[:, r0:r0 + rows, None]
        outs.append(torch.where(hit, blk, INT_INF).amin(dim=2))
    return _to_rows(torch.cat(outs, dim=1), g[f"{ell.name}_inv"])


# ---------------------------------------------------------------------------
# scatter_combine
# ---------------------------------------------------------------------------

_REDUCERS = {
    "add": _sum_slots,
    "min": lambda a: a.amin(dim=2),
    "max": lambda a: a.amax(dim=2),
    "or": lambda a: a.any(dim=2),
}

_SCATTER = {"min": "amin", "max": "amax"}


@spanned("scatter_combine", "localops")
def scatter_combine(g: dict, ell: EllMeta, vals: torch.Tensor, op: str, *,
                    identity, mode: str | None = None) -> torch.Tensor:
    """Combine per-edge ``vals`` (P, E) into a (P, n_rows) accumulator
    with ``op``.

    ``ell`` must be an edge-POSITION structure (``ell_out`` / ``ell_dst``
    / ``ell_src``): slots index into the part's (E,) edge arrays, so
    ``vals`` must be aligned with that edge order and already carry
    ``identity`` at inactive/padding edges.  Rows no edge touches come
    back as ``identity``.
    """
    if op not in _REDUCERS:
        raise ValueError(f"scatter_combine op {op!r} not in "
                         f"{tuple(_REDUCERS)}")
    impl = resolve(mode, vals.device)
    parts = vals.shape[0]
    if impl == "ref" or not _has_ell(g, ell):
        key_name, may_drop = _COO_KEY[ell.name]
        key = g[key_name]
        size = ell.n_rows + (1 if may_drop else 0)
        if op == "or":  # bool OR as the uint8 scatter-max idiom
            acc = torch.zeros((parts, size), dtype=torch.uint8,
                              device=vals.device)
            acc.scatter_reduce_(1, key.long(), vals.to(torch.uint8), "amax")
            return acc[:, :ell.n_rows] > 0
        acc = torch.full((parts, size), identity, dtype=vals.dtype,
                         device=vals.device)
        if op == "add":
            acc = _scatter_add(acc, key, vals)
        else:
            acc.scatter_reduce_(1, key.long(), vals, _SCATTER[op])
        return acc[:, :ell.n_rows]

    idx = g[f"{ell.name}_idx"]
    if op == "add" and vals.dtype == torch.float32 and impl == "kernel":
        # a skipped sentinel slot adds +0.0, as the ell path's pad does
        # when it carries identity 0.0; empty rows come back as 0.0
        if identity != 0.0:
            raise ValueError(f"scatter_combine(add) on the kernel route "
                             f"needs identity 0.0, got {identity!r}")
        from repro_torch.kernels.spmv.kernel import spmv_ell_buckets
        return _to_rows(spmv_ell_buckets(idx, None, vals, ell.buckets,
                                         skip=ell.sentinel),
                        g[f"{ell.name}_inv"])
    # sentinel E indexes the pad slot, which carries the identity
    vpad = _with_pad(vals, identity)
    outs = []
    for _, rows, k, blk in bucket_views(idx, ell.buckets):
        if k == 0:
            outs.append(torch.full((parts, rows), identity,
                                   dtype=vals.dtype, device=vals.device))
        else:
            outs.append(_REDUCERS[op](_gather_rows(vpad, blk)))
    return _to_rows(torch.cat(outs, dim=1), g[f"{ell.name}_inv"])
