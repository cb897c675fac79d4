"""Distributed graph representation: 1-D vertex-partitioned edge shards.

Vertex v is owned by partition ``v // n_local`` (block distribution),
and every per-vertex quantity (parents, ranks, frontiers) is a
``(P, n_local)`` tensor: all P parts stacked along a leading dim on one
device.

Edges are stored twice, both with uniform ``(P, E)`` shapes:
  * out-shard: edges grouped by OWNER OF THE SOURCE (for push traversal):
      out_src_local (P, E) in [0, n_local), out_dst_global (P, E)
  * in-shard: edges grouped by OWNER OF THE DESTINATION (for pull):
      in_src_global (P, E), in_dst_local (P, E)

Padding uses sentinel vertex n in the global-id columns; the local-id
columns pad with 0 (``_group_edges``), and every consumer masks padding
by the global column.  Every partition is padded to the max
per-partition edge count.

Blocked-ELL edge layout (the local work-bundle layout)
------------------------------------------------------
Rows are sorted by degree (per partition) and grouped into blocks of
:data:`ELL_BLOCK` rows; each block stores a FIXED number of slots (the
block's max degree, rounded up to :data:`ELL_LANE`), so a block is a
dense ``(rows, K)`` tile.  Consecutive blocks with equal K merge into
*buckets* (``EllMeta.buckets``), so a superstep is a handful of dense
gather+reduce launches.  Unused slots carry ``EllMeta.sentinel``; a
permutation pair (``<name>_perm``: ELL row -> original row,
``<name>_inv``: original row -> ELL row) maps results back to vertex
order with a GATHER, never a scatter.

Four instances are built (``GraphShards.ell_meta``):

  ``ell_in``   rows = local vertices, slots = global in-neighbor ids
               (pull: PageRank SpMV, BFS frontier test); sentinel n.
  ``ell_out``  rows = local vertices, slots = out-edge POSITIONS into
               the (E,) out-shard arrays (per-source combine); sentinel E.
  ``ell_dst``  rows = ALL n global vertices, slots = out-edge positions
               grouped by destination (push-combine into a length-n
               accumulator without scatters); sentinel E.
  ``ell_src``  rows = ALL n global vertices, slots = in-edge positions
               grouped by source (reverse-direction combine); sentinel E.

The host half of this module is numpy and builds arrays byte-identical
to the JAX package's ``repro.core.graph`` (the tests hold them equal).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

ELL_BLOCK = 128   # rows per ELL block (n and n_local are multiples of 128)
ELL_LANE = 8      # block widths round up to this many slots

_COO_KEYS = ("out_src_local", "out_dst_global", "in_src_global",
             "in_dst_local", "out_degree", "in_degree")


@dataclass(frozen=True)
class EllMeta:
    """Static (host-side) description of one blocked-ELL structure.

    ``buckets`` is a tuple of ``(rows, width)`` runs in ELL row order
    (rows are multiples of :data:`ELL_BLOCK`, widths non-increasing,
    possibly ending in a ``(rows, 0)`` run for edgeless rows); ``slots``
    is the flat slot count ``sum(rows * width)``.  ``device_suffixes``
    names which per-partition arrays ship to the device
    (``f"{name}_{suffix}"`` keys in the graph dict).
    """

    name: str
    n_rows: int
    buckets: tuple[tuple[int, int], ...]
    slots: int
    sentinel: int
    device_suffixes: tuple[str, ...] = ("idx", "inv")


def _stable_argsort(keys: np.ndarray) -> np.ndarray:
    """``np.argsort(keys, kind="stable")`` through torch's multithreaded
    CPU sort: the same unique order, several times faster on the tens of
    millions of edges of a paper-scale graph."""
    return torch.sort(torch.from_numpy(np.ascontiguousarray(keys)),
                      stable=True).indices.numpy()


def _round_lane(w: np.ndarray) -> np.ndarray:
    """Round widths up to ELL_LANE multiples (0 stays 0)."""
    return ((w + ELL_LANE - 1) // ELL_LANE) * ELL_LANE


def _run_length(widths: np.ndarray) -> tuple[tuple[int, int], ...]:
    """Merge consecutive equal-width blocks into (rows, width) buckets."""
    buckets = []
    for w in widths:
        if buckets and buckets[-1][1] == int(w):
            buckets[-1][0] += ELL_BLOCK
        else:
            buckets.append([ELL_BLOCK, int(w)])
    return tuple((r, w) for r, w in buckets)


def _ell_row_base(buckets) -> tuple[np.ndarray, np.ndarray]:
    """Per-ELL-row (slot offset, width) arrays from the bucket runs."""
    n_rows = sum(r for r, _ in buckets)
    base = np.zeros(n_rows, np.int64)
    width = np.zeros(n_rows, np.int64)
    off = 0
    r0 = 0
    for rows, k in buckets:
        base[r0:r0 + rows] = off + np.arange(rows) * k
        width[r0:r0 + rows] = k
        off += rows * k
        r0 += rows
    return base, width


def ell_row_layout(buckets) -> tuple[np.ndarray, np.ndarray]:
    """Per-row (slot base, width) decomposition of the bucket runs: a
    row holds ``width[q] - occupancy`` more entries before its bucket
    overflows."""
    return _ell_row_base(buckets)


def ell_slot_rows(buckets) -> np.ndarray:
    """(slots,) ELL row of every flat slot position."""
    rows = []
    r0 = 0
    for r, k in buckets:
        if k:
            rows.append(r0 + np.repeat(np.arange(r, dtype=np.int64), k))
        r0 += r
    if not rows:
        return np.zeros(0, np.int64)
    return np.concatenate(rows)


def ell_occupancy(meta: EllMeta, idx: np.ndarray) -> np.ndarray:
    """(P, n_rows) occupied-slot counts of a (P, slots) idx array.

    ``build_ell`` packs each row's entries contiguously from its slot
    base, so the count doubles as the next free slot offset."""
    parts = idx.shape[0]
    occ = np.zeros((parts, meta.n_rows), np.int64)
    if meta.slots == 0:
        return occ
    s2r = ell_slot_rows(meta.buckets)
    for p in range(parts):
        filled = idx[p, :meta.slots] != meta.sentinel
        occ[p] = np.bincount(s2r[filled], minlength=meta.n_rows)
    return occ


def make_scatter_patch():
    """The slot patcher of the dynamic-mutation path for ``(P, S)``
    graph tensors.

    ``patch(arr, slots, vals)`` returns a copy of ``arr`` with
    ``vals[i]`` written at flat position ``slots[i]`` (``p * S + s``),
    on ``arr``'s device; ``slots`` and ``vals`` are host arrays and only
    they cross to the device.  The update is functional on purpose:
    launches already in flight keep reading the pre-mutation tensor
    (the snapshot-epoch isolation of the server) and a rolled-back batch
    restores the old tensor by reference.  Only real slots are written:
    an out-of-range index raises here, on the host, where JAX's
    ``mode="drop"`` would have dropped it."""

    def patch(arr, slots, vals):
        slots = np.asarray(slots, np.int64)
        if slots.size and (slots.min() < 0 or slots.max() >= arr.numel()):
            raise IndexError(f"patch slot out of range for {tuple(arr.shape)}")
        flat = arr.reshape(-1).clone()
        flat[torch.from_numpy(slots).to(arr.device)] = torch.as_tensor(
            np.asarray(vals), dtype=arr.dtype).to(arr.device)
        return flat.view(arr.shape)

    return patch


def build_ell(name: str, row_ids: np.ndarray, values: np.ndarray,
              n_rows: int, sentinel: int,
              device_suffixes=("idx", "inv")) -> tuple[EllMeta, dict]:
    """Build one blocked-ELL structure from (P, E) host arrays.

    ``row_ids[p, e]`` is the row of entry e in partition p (or -1 for
    padding/invalid entries, which are skipped); ``values[p, e]`` is
    what the slot stores (a neighbor id or an edge position).  Returns
    ``(meta, arrays)`` with ``arrays`` holding ``{name}_idx`` (P, slots)
    int32, ``{name}_inv`` / ``{name}_perm`` (P, n_rows) int32.  Rows are
    degree-sorted per partition; bucket widths are maxed across
    partitions so one launch per bucket covers all of them.
    """
    if n_rows % ELL_BLOCK:
        raise ValueError(f"{name}: n_rows={n_rows} is not a multiple of "
                         f"{ELL_BLOCK}")
    parts = row_ids.shape[0]
    n_blocks = n_rows // ELL_BLOCK

    counts = np.zeros((parts, n_rows), np.int64)
    perms = np.zeros((parts, n_rows), np.int64)
    for p in range(parts):
        valid = row_ids[p] >= 0
        counts[p] = np.bincount(row_ids[p][valid].astype(np.int64),
                                minlength=n_rows)
        perms[p] = _stable_argsort(-counts[p])

    # uniform block widths: max over partitions, rounded to lanes.
    widths_pp = np.take_along_axis(counts, perms, axis=1) \
        .reshape(parts, n_blocks, ELL_BLOCK).max(axis=2)
    widths = _round_lane(widths_pp.max(axis=0))
    buckets = _run_length(widths)
    row_base, row_width = _ell_row_base(buckets)
    slots = int(sum(r * k for r, k in buckets))

    idx = np.full((parts, max(slots, 1)), sentinel, np.int64)
    inv = np.zeros((parts, n_rows), np.int64)
    for p in range(parts):
        inv[p, perms[p]] = np.arange(n_rows)
        valid = row_ids[p] >= 0
        rows_v = row_ids[p][valid].astype(np.int64)
        vals_v = values[p][valid].astype(np.int64)
        order = _stable_argsort(rows_v)
        rows_s, vals_s = rows_v[order], vals_v[order]
        first = np.concatenate([[0], np.cumsum(counts[p])[:-1]])
        rank = np.arange(rows_s.size) - first[rows_s]
        q = inv[p, rows_s]                       # ELL row of each entry
        if not (rank < row_width[q]).all():
            raise AssertionError(f"{name}: entry beyond its row width")
        idx[p, row_base[q] + rank] = vals_s

    meta = EllMeta(name=name, n_rows=n_rows, buckets=buckets, slots=slots,
                   sentinel=sentinel,
                   device_suffixes=tuple(device_suffixes))
    arrays = {
        f"{name}_idx": idx[:, :max(slots, 1)].astype(np.int32),
        f"{name}_inv": inv.astype(np.int32),
    }
    if "perm" in device_suffixes:
        # only materialized when it ships (frontier_pull's row gather)
        arrays[f"{name}_perm"] = perms.astype(np.int32)
    return meta, arrays


def ell_entries(meta: EllMeta, idx_row: np.ndarray,
                inv_row: np.ndarray) -> list[tuple[int, int]]:
    """Decode ONE partition's ELL back into (row, value) pairs (host-side
    test helper: the blocked layout must round-trip the edge multiset)."""
    perm = np.empty(meta.n_rows, np.int64)
    perm[inv_row] = np.arange(meta.n_rows)
    pairs = []
    off = 0
    r0 = 0
    for rows, k in meta.buckets:
        if k:
            blk = idx_row[off:off + rows * k].reshape(rows, k)
            ell_rows, slots_k = np.nonzero(blk != meta.sentinel)
            for er, sk in zip(ell_rows, slots_k):
                pairs.append((int(perm[r0 + er]), int(blk[er, sk])))
        off += rows * k
        r0 += rows
    return pairs


@dataclass
class GraphShards:
    n: int                      # padded global vertex count (multiple of P)
    n_orig: int                 # original vertex count
    parts: int
    n_local: int
    e_max: int                  # per-partition padded edge count
    # numpy (host) arrays with leading partition dim:
    out_src_local: np.ndarray   # (P, E) int32, 0 for padding
    out_dst_global: np.ndarray  # (P, E) int32, sentinel n for padding
    in_src_global: np.ndarray   # (P, E) int32, sentinel n for padding
    in_dst_local: np.ndarray    # (P, E) int32, 0 for padding
    out_degree: np.ndarray      # (P, n_local) int32
    in_degree: np.ndarray       # (P, n_local) int32
    # blocked-ELL view (see module docstring); built by partition_graph
    ell_meta: dict = field(default_factory=dict)     # name -> EllMeta
    ell_arrays: dict = field(default_factory=dict)   # key -> np.ndarray
    # None: the arrays hold every part; p: only part p's rows, (1, ...)
    part_index: int | None = None

    def take_part(self, p: int) -> "GraphShards":
        """Part ``p`` alone: every array's row ``p`` as a ``(1, ...)``
        array (COO shards, degrees, the ELL views), with the shared
        shapes and ``ell_meta``, so the kernels see the same bucket
        layout and launch the same grid over one part.  One part's
        shards give themselves for their own ``p``."""
        if not 0 <= p < self.parts:
            raise ValueError(f"part {p} not in [0, {self.parts})")
        if self.part_index is not None:
            if p != self.part_index:
                raise ValueError(f"shards of part {self.part_index} hold "
                                 f"no part {p}")
            return self
        def cut(a):
            return np.ascontiguousarray(a[p:p + 1])

        return GraphShards(
            n=self.n, n_orig=self.n_orig, parts=self.parts,
            n_local=self.n_local, e_max=self.e_max,
            **{k: cut(getattr(self, k)) for k in _COO_KEYS},
            ell_meta=dict(self.ell_meta),
            ell_arrays={k: cut(v) for k, v in self.ell_arrays.items()},
            part_index=p)

    @classmethod
    def from_arrays(cls, d: dict) -> "GraphShards":
        """Shards from a plain dict of the fields above: numpy arrays,
        ints, and ``ell_meta`` entries as field dicts (the form
        ``dataclasses.asdict`` gives for the JAX package's shards), so
        both packages can run on identical arrays."""
        metas = {}
        for name, m in d.get("ell_meta", {}).items():
            m = dict(m)
            m["buckets"] = tuple(tuple(int(v) for v in b)
                                 for b in m["buckets"])
            m["device_suffixes"] = tuple(m.get("device_suffixes",
                                               ("idx", "inv")))
            metas[name] = EllMeta(**m)
        return cls(
            n=int(d["n"]), n_orig=int(d["n_orig"]), parts=int(d["parts"]),
            n_local=int(d["n_local"]), e_max=int(d["e_max"]),
            **{k: np.asarray(d[k]) for k in _COO_KEYS},
            ell_meta=metas,
            ell_arrays={k: np.asarray(v)
                        for k, v in d.get("ell_arrays", {}).items()},
            part_index=d.get("part_index"))

    def ell(self, name: str) -> EllMeta:
        """Meta handle for program factories.  When the blocked-ELL
        layout was not built (``build_ell_layout=False``), returns a
        zero-slot placeholder carrying the row count and sentinel the
        REF path needs."""
        meta = self.ell_meta.get(name)
        if meta is not None:
            return meta
        n_rows = self.n_local if name in ("ell_in", "ell_out") else self.n
        sentinel = self.n if name == "ell_in" else self.e_max
        return EllMeta(name=name, n_rows=n_rows, buckets=((n_rows, 0),),
                       slots=0, sentinel=sentinel, device_suffixes=())

    def _ell_device_keys(self):
        for meta in self.ell_meta.values():
            for suf in meta.device_suffixes:
                yield f"{meta.name}_{suf}", meta, suf

    def layout_signature(self) -> tuple:
        """Hashable fingerprint of the blocked-ELL bucket structure (part
        of the engine's program-cache key)."""
        return tuple(sorted(
            (m.name, m.n_rows, m.buckets, m.slots, m.sentinel)
            for m in self.ell_meta.values()))

    def abstract_arrays(self, layout: str = "ell") -> dict:
        """The tensors :meth:`device_arrays` would ship, as
        ``device="meta"`` tensors of the same shapes and dtypes (the
        dry-run plans on them; nothing is allocated)."""
        if layout not in ("ell", "coo"):
            raise ValueError(f"layout {layout!r} not in ('ell', 'coo')")
        P, E, NL = self.parts, self.e_max, self.n_local

        def meta(*shape):
            return torch.empty(shape, dtype=torch.int32, device="meta")

        arrs = {"out_src_local": meta(P, E), "out_dst_global": meta(P, E),
                "in_src_global": meta(P, E), "in_dst_local": meta(P, E),
                "out_degree": meta(P, NL), "in_degree": meta(P, NL)}
        if layout == "ell":
            for key, m, suf in self._ell_device_keys():
                arrs[key] = meta(P, max(m.slots, 1)) if suf == "idx" \
                    else meta(P, m.n_rows)
        return arrs

    def device_arrays(self, layout: str = "ell", device="cuda") -> dict:
        """``(L, ...)`` int32 tensors of the parts these shards hold on
        ``device``.  ``layout="coo"`` omits the ELL arrays: local ops
        then take the COO scatter reference path."""
        if layout not in ("ell", "coo"):
            raise ValueError(f"layout {layout!r} not in ('ell', 'coo')")
        keys = list(_COO_KEYS)
        if layout == "ell":
            keys += [key for key, _, _ in self._ell_device_keys()]
        src = {**{k: getattr(self, k) for k in _COO_KEYS}, **self.ell_arrays}
        return {k: torch.from_numpy(np.ascontiguousarray(src[k], np.int32))
                .to(device) for k in keys}


def _group_edges(key: np.ndarray, other: np.ndarray, parts: int,
                 n_local: int, e_max: int, n_sentinel: int, key_local: bool):
    """Group (key, other) pairs by key-owner partition into padded (P, E).

    With ``key_local`` the key column becomes a local id and its padding
    becomes local id 0 (not the sentinel)."""
    owner = key // n_local
    order = _stable_argsort(owner)
    key_s, other_s, owner_s = key[order], other[order], owner[order]
    counts = np.bincount(owner_s, minlength=parts)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    k_out = np.full((parts, e_max), n_sentinel, dtype=np.int64)
    o_out = np.full((parts, e_max), n_sentinel, dtype=np.int64)
    for p in range(parts):
        c = counts[p]
        k_out[p, :c] = key_s[starts[p]:starts[p] + c]
        o_out[p, :c] = other_s[starts[p]:starts[p] + c]
    if key_local:
        k_out = np.where(k_out == n_sentinel, 0,
                         k_out - np.arange(parts)[:, None] * n_local)
    return k_out, o_out, counts


def _build_graph_ells(g: GraphShards) -> None:
    """Attach the four blocked-ELL structures to freshly built shards."""
    n, n_local, e_max = g.n, g.n_local, g.e_max
    pos = np.broadcast_to(np.arange(e_max, dtype=np.int64),
                          (g.parts, e_max))
    out_valid = g.out_dst_global < n
    in_valid = g.in_src_global < n

    specs = [
        # (name, row_ids, values, n_rows, sentinel, suffixes)
        ("ell_in",
         np.where(in_valid, g.in_dst_local, -1), g.in_src_global,
         n_local, n, ("idx", "inv", "perm")),
        ("ell_out",
         np.where(out_valid, g.out_src_local, -1), pos,
         n_local, e_max, ("idx", "inv")),
        ("ell_dst",
         np.where(out_valid, g.out_dst_global, -1), pos,
         n, e_max, ("idx", "inv")),
        ("ell_src",
         np.where(in_valid, g.in_src_global, -1), pos,
         n, e_max, ("idx", "inv")),
    ]
    # the four builds are independent numpy work that mostly runs with
    # the interpreter lock released: one thread each
    with ThreadPoolExecutor(len(specs)) as pool:
        built = list(pool.map(
            lambda s: build_ell(*s[:5], device_suffixes=s[5]), specs))
    for (name, *_), (meta, arrays) in zip(specs, built):
        g.ell_meta[name] = meta
        g.ell_arrays.update(arrays)


def partition_graph(edges: np.ndarray, n_orig: int, parts: int,
                    build_ell_layout: bool = True) -> GraphShards:
    """Build GraphShards from an (E, 2) edge list.

    n is padded so n_local is a multiple of 128 (bit-packing needs 32).
    Padded vertices have no edges.  The blocked-ELL view is built
    alongside the COO shards unless ``build_ell_layout=False`` (then
    every program takes the COO scatter reference path).
    """
    block = parts * 128
    n = ((n_orig + block - 1) // block) * block
    n_local = n // parts
    src, dst = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)

    out_deg = np.bincount(src, minlength=n).astype(np.int32)
    in_deg = np.bincount(dst, minlength=n).astype(np.int32)

    src_owner = src // n_local
    dst_owner = dst // n_local
    e_max_out = int(np.bincount(src_owner, minlength=parts).max())
    e_max_in = int(np.bincount(dst_owner, minlength=parts).max())
    e_max = max(e_max_out, e_max_in, 1)
    e_max = ((e_max + 127) // 128) * 128

    out_src_local, out_dst_global, _ = _group_edges(
        src, dst, parts, n_local, e_max, n, key_local=True)
    in_dst_local, in_src_global, _ = _group_edges(
        dst, src, parts, n_local, e_max, n, key_local=True)

    g = GraphShards(
        n=n, n_orig=n_orig, parts=parts, n_local=n_local, e_max=e_max,
        out_src_local=out_src_local.astype(np.int32),
        out_dst_global=out_dst_global.astype(np.int32),
        in_src_global=in_src_global.astype(np.int32),
        in_dst_local=in_dst_local.astype(np.int32),
        out_degree=out_deg.reshape(parts, n_local),
        in_degree=in_deg.reshape(parts, n_local),
    )
    if build_ell_layout:
        _build_graph_ells(g)
    return g


def _abstract_ell(name: str, n_rows: int, k: int, nz_rows: int,
                  sentinel: int, suffixes=("idx", "inv")) -> EllMeta:
    """Shape-only EllMeta modelling a degree-bucketed layout: ``nz_rows``
    rows of width ``k`` plus an edgeless tail (the dominant shape of a
    near-uniform degree distribution after bucketing)."""
    nz = min(n_rows, ((nz_rows + ELL_BLOCK - 1) // ELL_BLOCK) * ELL_BLOCK)
    k = int(_round_lane(np.asarray(max(k, 1))))
    buckets = [(nz, k)]
    if n_rows > nz:
        buckets.append((n_rows - nz, 0))
    return EllMeta(name=name, n_rows=n_rows, buckets=tuple(buckets),
                   slots=nz * k, sentinel=sentinel,
                   device_suffixes=tuple(suffixes))


def abstract_graph(n_orig: int, avg_degree: int, parts: int) -> GraphShards:
    """Shape-only GraphShards for the dry-run (no edges materialized).

    e_max models the expected max partition load of an ER graph (about
    uniform, +12% headroom), rounded to 128.  The ELL metas model the
    bucketed layout of the same graph: local rows carry about 1.5x the
    mean degree after block-max padding; the global-row structures
    (ell_dst/ell_src) have about min(E/P, n) populated rows of
    near-minimal width.  The fields and metas are the JAX package's;
    :meth:`GraphShards.abstract_arrays` gives the tensors.
    """
    block = parts * 128
    n = ((n_orig + block - 1) // block) * block
    n_local = n // parts
    e_total = n_orig * avg_degree
    e_max = int(e_total / parts * 1.12)
    e_max = ((e_max + 127) // 128) * 128
    z = np.zeros((1,), np.int32)  # placeholders; only shapes are used
    g = GraphShards(
        n=n, n_orig=n_orig, parts=parts, n_local=n_local, e_max=e_max,
        out_src_local=z, out_dst_global=z, in_src_global=z, in_dst_local=z,
        out_degree=z, in_degree=z)
    k_local = int(avg_degree * 1.5)
    k_global = max(ELL_LANE, int(avg_degree / parts * 2))
    nz_global = min(n, e_max)
    for meta in (
        _abstract_ell("ell_in", n_local, k_local, n_local, n,
                      suffixes=("idx", "inv", "perm")),
        _abstract_ell("ell_out", n_local, k_local, n_local, e_max),
        _abstract_ell("ell_dst", n, k_global, nz_global, e_max),
        _abstract_ell("ell_src", n, k_global, nz_global, e_max),
    ):
        g.ell_meta[meta.name] = meta
    return g
