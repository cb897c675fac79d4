"""In-place mutation of the resident device graph: batched edge
insert/delete as slot patches against the blocked-ELL + COO shards.

The free capacity was always there: ``build_ell`` rounds row widths to
lane multiples and maxes bucket widths across partitions, and
``partition_graph`` pads the COO shards to an ``e_max`` multiple of 128
— all of that slack is addressable as FREE SLOTS.  ``DynamicGraph``
tracks it on the host (per-row ELL occupancy, per-partition COO free
stacks and an exact (u, v) -> positions index) and turns a mutation
batch into one patch per touched array:

  * planning runs against host mirrors of every shard array, recording
    the set of touched (partition, slot) coordinates per array — the
    final value of each touched slot is then read back OFF THE MIRROR,
    so duplicate writes within a batch collapse to one deterministic
    value;
  * one functional patch per touched array
    (``core.graph.make_scatter_patch``) writes exactly those slots —
    only the patch lists cross host->device, never the shards;
  * the patch is copy-on-write, so launches already in flight keep
    reading the pre-mutation tensors: the snapshot isolation the
    server's epochs advertise, and what a failed batch rolls back to.

The position index.  An edge instance (u, v) lives at one out-COO
position of u's partition and one in-COO position of v's; the planner
pops positions newest-first and must pick the JAX package's slots
exactly (slot placement sets every float sum order downstream).  The
JAX package keeps a dict of every edge's position list, built at once
(minutes and tens of GB at urand22).  Here a key's list is read off the
graph the first time a mutation touches it — the positions of u's
``ell_out`` row whose destination is v (``ell_src`` row u of v's
partition for the in-side), ascending, which is the build order — and
kept in a small dict from then on.  A key never touched still sits at
its build positions, so the two agree for every key.

A batch whose net growth exceeds any row's free width (or a partition's
COO slack) cannot patch; ``apply`` detects this in a capacity dry-run
BEFORE mutating anything and falls back to a full re-partition +
re-upload (``MutationStats.rebuild=True``) — correct, just not cheap.

One part a rank.  Over ``DistComm`` the engine holds its own part
alone, and so does its planner: each rank keeps the free stacks,
occupancy and position lists of its part and plans and patches only
its part's cells (the out cells of ``u`` where ``u``'s part is the
rank's, the in cells of ``v`` likewise), so each rank's mirrors equal
the stacked planner's row of its part.  What one rank alone sees is
agreed over the control plane before anything mutates: the capacity
dry-run's outcome (fits, rebuild, or the ``KeyError`` of an absent
delete, the one of the earliest such delete) and whether every rank's
apply succeeded (if one failed, every rank replays its journal).  A
rebuild gathers every rank's live edges in part order and
re-partitions the whole graph, and each rank takes its part; the
samplers gather the per-part tallies and edges they read, so they
return the stacked planner's batch for the same generator.

Invariants preserved (the ones the kernels rely on):
  * each ELL row's entries stay CONTIGUOUS from its slot base — inserts
    fill at ``base + occ``, deletes move the row's last entry into the
    hole and sentinel the tail;
  * COO padding convention: vacated positions get the global-id
    sentinel ``n`` and local-id 0, exactly like ``partition_graph``;
  * degrees track live edges (pagerank contributions, kcore bounds).
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass

import numpy as np

from repro_torch.core.graph import ell_occupancy, ell_row_layout, \
    make_scatter_patch, partition_graph

_ELL_NAMES = ("ell_in", "ell_out", "ell_dst", "ell_src")


class EllOverflow(RuntimeError):
    """A mutation batch does not fit the free-slot pools."""


@dataclass
class MutationBatch:
    """One batched edge mutation: (k, 2) ``[u, v]`` int arrays (global
    original vertex ids).  Deletes apply before inserts, so freed slots
    are reusable within the batch; a delete must name an edge instance
    present BEFORE the batch (multigraph: one instance per request)."""

    inserts: np.ndarray | None = None
    deletes: np.ndarray | None = None


@dataclass
class MutationStats:
    """What one ``apply`` did: patch-path telemetry or the rebuild flag."""

    epoch: int
    n_insert: int
    n_delete: int
    slots_patched: int                   # touched device slots, all arrays
    arrays_patched: int                  # device arrays that got a patch
    rebuild: bool                        # True = re-partition fallback
    apply_s: float


def _as_pairs(edges) -> np.ndarray:
    if edges is None:
        return np.zeros((0, 2), np.int64)
    a = np.asarray(edges, np.int64)
    if a.ndim != 2 or a.shape[1] != 2:
        raise ValueError(f"mutation edges must be (k, 2) [u, v]: {a.shape}")
    return a


def drop_first_instances(edges: np.ndarray, deletes: np.ndarray,
                         n: int) -> np.ndarray:
    """``edges`` without, for each distinct (u, v) that ``deletes`` names
    c times, its first c instances in ``edges`` order (ids below ``n``)
    — the rebuild path's delete, vectorised."""
    if not len(deletes):
        return edges
    key = edges[:, 0] * n + edges[:, 1]
    dk, dc = np.unique(deletes[:, 0] * n + deletes[:, 1], return_counts=True)
    cand = np.flatnonzero(np.isin(key, dk))
    order = np.argsort(key[cand], kind="stable")
    sk = key[cand][order]
    rank = np.arange(len(sk)) - np.searchsorted(sk, sk, side="left")
    keep = np.ones(len(edges), bool)
    keep[cand[order[rank < dc[np.searchsorted(dk, sk)]]]] = False
    return edges[keep]


class DynamicGraph:
    """Host-side mutation planner + device patcher over one engine.

    Construction reads the free-slot state off the engine's host shard
    mirrors (occupancy counts and free stacks: seconds at urand22).
    ``apply`` mutates the mirrors and the resident device tensors in
    lockstep; ``self.garr`` always names the newest epoch's device
    graph.
    """

    def __init__(self, engine, garr=None, *, planner_state=None):
        self.engine = engine
        # the parts this process holds: all of them stacked, one a rank
        self._first = engine.comm.first_part
        self._held = engine.comm.local_parts
        self.garr = dict(garr) if garr is not None else engine.device_graph()
        self.epoch = 0
        self._patch_fn = make_scatter_patch()
        # failure-atomicity journal: while an ``apply`` is in flight,
        # every state change (mirror slot, occupancy cell, free-stack /
        # position-index op) logs its inverse; an exception mid-batch
        # replays the journal in reverse so the planner state and the
        # mirrors roll back to the pre-batch graph exactly
        self._undo: list | None = None
        if planner_state is not None:
            self._restore_planner(planner_state)
        else:
            self._rebuild_index()

    def _holds(self, p: int) -> bool:
        return self._first <= p < self._first + self._held

    def _log_undo(self, fn) -> None:
        if self._undo is not None:
            self._undo.append(fn)

    # -- index construction ------------------------------------------------

    def _layout(self):
        g = self.engine.g
        if not g.ell_meta:
            raise ValueError(
                "dynamic mutation needs the blocked-ELL layout "
                "(partition_graph(..., build_ell_layout=True))")
        self._row_layout = {name: ell_row_layout(g.ell_meta[name].buckets)
                            for name in _ELL_NAMES}

    def _rebuild_index(self):
        self._layout()
        g = self.engine.g
        self._occ = {name: ell_occupancy(g.ell_meta[name],
                                         g.ell_arrays[f"{name}_idx"])
                     for name in _ELL_NAMES}
        # COO free-position stacks (validity sentinel: global-id column
        # == n marks padding); position lists of the keys mutations
        # touched, the rest read off the graph (module docstring)
        self._free_out = [
            np.flatnonzero(g.out_dst_global[lp] >= g.n)[::-1].tolist()
            for lp in range(self._held)]
        self._free_in = [
            np.flatnonzero(g.in_src_global[lp] >= g.n)[::-1].tolist()
            for lp in range(self._held)]
        self._pos_out = [{} for _ in range(self._held)]
        self._pos_in = [{} for _ in range(self._held)]

    def _graph_positions(self, side: str, p: int, u: int, v: int) -> list:
        """Live positions of edge (u, v) in partition p's out-COO
        (``side="out"``, p owns u) or in-COO (p owns v), ascending."""
        g = self.engine.g
        lo, lp = p * g.n_local, p - self._first
        if side == "out":
            name, row, col, want = "ell_out", u - lo, g.out_dst_global, v
        else:
            name, row, col, want = "ell_src", u, g.in_dst_local, v - lo
        q = self._ell_row(name, lp, row)
        base = int(self._row_layout[name][0][q])
        es = g.ell_arrays[f"{name}_idx"][lp,
                                         base:base + self._occ[name][lp, q]]
        return sorted(es[col[lp, es] == want].tolist())

    def positions(self, side: str, p: int, u: int, v: int) -> list:
        """The position list of edge (u, v) (``side`` as in
        ``_graph_positions``), in the order the planner pops it from:
        the last entry goes first.  ``p`` is a part this process
        holds."""
        lp = p - self._first
        d = self._pos_out[lp] if side == "out" else self._pos_in[lp]
        got = d.get((u, v))
        return list(got) if got is not None \
            else self._graph_positions(side, p, u, v)

    def _pos_list(self, side: str, p: int, u: int, v: int) -> list:
        """The mutable position list of (u, v), taken into the index
        of touched keys on first use (journaled, so a rolled-back batch
        leaves the index as it found it)."""
        lp = p - self._first
        d = self._pos_out[lp] if side == "out" else self._pos_in[lp]
        key = (u, v)
        lst = d.get(key)
        if lst is None:
            lst = d[key] = self._graph_positions(side, p, u, v)
            self._log_undo(lambda: d.pop(key))
        return lst

    # -- planner-state snapshot / restore ----------------------------------

    def planner_state(self) -> dict:
        """The EXACT free-slot planner state, in plain picklable types.

        Order matters: free stacks pop from the end and position lists
        pop newest-first, so slot placement — and therefore float
        reduction order in every downstream kernel — is a function of
        this state.  ``pos_out``/``pos_in`` hold the keys mutations
        touched; every other key's list is re-read off the snapshot's
        graph mirrors on restore.  The lists are the held parts', in
        part order (one part's on a rank).  A restored planner replays mutations
        into the same slots the original run used, which is what makes
        recovered answers bit-identical."""
        return {
            "occ": {name: occ.copy() for name, occ in self._occ.items()},
            "free_out": [list(x) for x in self._free_out],
            "free_in": [list(x) for x in self._free_in],
            "pos_out": [[(u, v, list(es)) for (u, v), es in d.items()]
                        for d in self._pos_out],
            "pos_in": [[(u, v, list(es)) for (u, v), es in d.items()]
                       for d in self._pos_in],
            "epoch": int(self.epoch),
        }

    def _restore_planner(self, state: dict) -> None:
        self._layout()
        self._occ = {name: np.array(occ)
                     for name, occ in state["occ"].items()}
        self._free_out = [list(x) for x in state["free_out"]]
        self._free_in = [list(x) for x in state["free_in"]]
        self._pos_out = [{(u, v): list(es) for u, v, es in part}
                         for part in state["pos_out"]]
        self._pos_in = [{(u, v): list(es) for u, v, es in part}
                        for part in state["pos_in"]]
        self.epoch = int(state.get("epoch", 0))

    # -- capacity ----------------------------------------------------------

    def _ell_row(self, name: str, lp: int, orig_row: int) -> int:
        """The ELL row of ``orig_row`` in held part ``lp`` (an index into
        the parts this process holds)."""
        inv = self.engine.g.ell_arrays[f"{name}_inv"]
        return int(inv[lp, orig_row])

    def _own_row(self, name: str, p: int, orig_row: int):
        """``_ell_row`` of global part ``p``, None for a part held
        elsewhere."""
        return self._ell_row(name, p - self._first, orig_row) \
            if self._holds(p) else None

    @staticmethod
    def _cells(u: int, v: int, n_local: int, row):
        """The four (name, partition, ELL row) cells edge (u, v) lives
        in, ``row(name, p, orig_row)`` naming each row."""
        pu, pv = u // n_local, v // n_local
        ul, vl = u - pu * n_local, v - pv * n_local
        return ((("ell_in", pv, row("ell_in", pv, vl)),
                 ("ell_out", pu, row("ell_out", pu, ul)),
                 ("ell_dst", pu, row("ell_dst", pu, v)),
                 ("ell_src", pv, row("ell_src", pv, u))),
                pu, pv)

    def _check_capacity(self, ins: np.ndarray, dels: np.ndarray) -> None:
        """Dry-run the whole batch against the free pools; raises
        EllOverflow (or KeyError for an absent delete) BEFORE any mirror
        mutates, so a failed batch leaves the graph untouched.  Each
        process checks the cells of the parts it holds; the outcome is
        agreed: the earliest absent delete in the batch, else an
        overflow of any part's pools."""
        n_local = self.engine.g.n_local
        # deletes must all name live edge instances
        absent = None
        cd = Counter((int(u), int(v)) for u, v in dels)
        for i, ((u, v), c) in enumerate(cd.items()):
            if not self._holds(u // n_local):
                continue
            have = len(self.positions("out", u // n_local, u, v))
            if c > have:
                absent = (i, f"delete of edge ({u}, {v}) x{c}: only "
                             f"{have} instance(s) present")
                break
        said = self.engine.comm.gather_objects(
            (absent, None if absent else self._overflow(ins, dels)))
        absents = [a for a, _ in said if a is not None]
        if absents:
            raise KeyError(min(absents)[1])
        for _, overflow in said:
            if overflow is not None:
                raise EllOverflow(overflow)

    def _overflow(self, ins: np.ndarray, dels: np.ndarray):
        """Net per-cell growth of the held parts vs. free width / free
        COO positions: the first overflow's message, or None."""
        n_local, first = self.engine.g.n_local, self._first
        net_rows: Counter = Counter()
        net_out: Counter = Counter()
        net_in: Counter = Counter()
        for arr, sign in ((ins, +1), (dels, -1)):
            for u, v in arr:
                cells, pu, pv = self._cells(int(u), int(v), n_local,
                                            self._own_row)
                for cell in cells:
                    if cell[2] is not None:
                        net_rows[cell] += sign
                if self._holds(pu):
                    net_out[pu] += sign
                if self._holds(pv):
                    net_in[pv] += sign
        for p, d in net_out.items():
            if d > len(self._free_out[p - first]):
                return (f"partition {p}: out-COO needs {d} free positions, "
                        f"has {len(self._free_out[p - first])}")
        for p, d in net_in.items():
            if d > len(self._free_in[p - first]):
                return (f"partition {p}: in-COO needs {d} free positions, "
                        f"has {len(self._free_in[p - first])}")
        for (name, p, q), d in net_rows.items():
            if d <= 0:
                continue
            width = self._row_layout[name][1][q]
            occ = self._occ[name][p - first, q]
            if occ + d > width:
                return (f"{name} partition {p} row {q}: occupancy "
                        f"{occ}+{d} exceeds bucket width {width}")
        return None

    # -- host-mirror mutation ---------------------------------------------

    def _host_array(self, key: str) -> np.ndarray:
        g = self.engine.g
        return g.ell_arrays[key] if key.endswith("_idx") \
            else getattr(g, key)

    def _touch(self, touched, key: str, p: int, s: int) -> None:
        """Record a mirror write; call BEFORE overwriting slot (p, s)
        so the first touch journals the pre-batch value."""
        seen = touched.setdefault(key, set())
        if (p, s) not in seen and self._undo is not None:
            arr, old = self._host_array(key), self._host_array(key)[p, s]
            self._log_undo(lambda: arr.__setitem__((p, s), old))
        seen.add((p, s))

    def _set_occ(self, name, p, q, delta):
        occ = self._occ[name]
        old = int(occ[p, q])
        self._log_undo(lambda: occ.__setitem__((p, q), old))
        occ[p, q] = old + delta

    def _ell_fill(self, name, p, orig_row, value, touched):
        g = self.engine.g
        q = self._ell_row(name, p, orig_row)
        base, width = self._row_layout[name]
        occ = self._occ[name]
        if occ[p, q] >= width[q]:        # unreachable post-check; belt
            raise EllOverflow(f"{name} row {q} overflow mid-apply")
        s = int(base[q] + occ[p, q])
        self._touch(touched, f"{name}_idx", p, s)
        g.ell_arrays[f"{name}_idx"][p, s] = value
        self._set_occ(name, p, q, +1)

    def _ell_vacate(self, name, p, orig_row, value, touched):
        g = self.engine.g
        meta = g.ell_meta[name]
        q = self._ell_row(name, p, orig_row)
        base, _ = self._row_layout[name]
        occ = self._occ[name]
        o = int(occ[p, q])
        idx = g.ell_arrays[f"{name}_idx"]
        row = idx[p, base[q]:base[q] + o]
        hits = np.flatnonzero(row == value)
        if hits.size == 0:
            raise KeyError(f"{name} row {q}: value {value} not present")
        s = int(base[q] + hits[-1])
        last = int(base[q] + o - 1)
        if s != last:                     # keep the row contiguous
            self._touch(touched, f"{name}_idx", p, s)
            idx[p, s] = idx[p, last]
        self._touch(touched, f"{name}_idx", p, last)
        idx[p, last] = meta.sentinel
        self._set_occ(name, p, q, -1)

    def _coo_set(self, key, p, e, value, touched):
        self._touch(touched, key, p, e)
        getattr(self.engine.g, key)[p, e] = value

    def _bump_degree(self, key, p, vl, delta, touched):
        self._touch(touched, key, p, vl)
        getattr(self.engine.g, key)[p, vl] += delta

    # The mutation helpers above and below index the held parts: ``p``
    # there is a local index (``global part - first held part``).

    def _insert_one(self, u, v, touched):
        n_local = self.engine.g.n_local
        pu, pv = u // n_local, v // n_local
        ul, vl = u - pu * n_local, v - pv * n_local
        lu, lv = pu - self._first, pv - self._first
        out, into = self._holds(pu), self._holds(pv)
        # read the key's lists before this edge changes the rows they
        # are read from
        if out:
            pos_out = self._pos_list("out", pu, u, v)
        if into:
            pos_in = self._pos_list("in", pv, u, v)
        if out:
            e_out = self._free_out[lu].pop()
            self._log_undo(lambda: self._free_out[lu].append(e_out))
            self._coo_set("out_src_local", lu, e_out, ul, touched)
            self._coo_set("out_dst_global", lu, e_out, v, touched)
            pos_out.append(e_out)
            self._log_undo(pos_out.pop)
            self._bump_degree("out_degree", lu, ul, +1, touched)
            self._ell_fill("ell_out", lu, ul, e_out, touched)  # position
            self._ell_fill("ell_dst", lu, v, e_out, touched)
        if into:
            e_in = self._free_in[lv].pop()
            self._log_undo(lambda: self._free_in[lv].append(e_in))
            self._coo_set("in_src_global", lv, e_in, u, touched)
            self._coo_set("in_dst_local", lv, e_in, vl, touched)
            pos_in.append(e_in)
            self._log_undo(pos_in.pop)
            self._bump_degree("in_degree", lv, vl, +1, touched)
            self._ell_fill("ell_in", lv, vl, u, touched)    # neighbor id
            self._ell_fill("ell_src", lv, u, e_in, touched)

    def _delete_one(self, u, v, touched):
        g = self.engine.g
        n_local, n = g.n_local, g.n
        pu, pv = u // n_local, v // n_local
        ul, vl = u - pu * n_local, v - pv * n_local
        lu, lv = pu - self._first, pv - self._first
        out, into = self._holds(pu), self._holds(pv)
        if out:
            pos_out = self._pos_list("out", pu, u, v)
        if into:
            pos_in = self._pos_list("in", pv, u, v)
        if out:
            e_out = pos_out.pop()
            self._log_undo(lambda: pos_out.append(e_out))
            self._ell_vacate("ell_out", lu, ul, e_out, touched)
            self._ell_vacate("ell_dst", lu, v, e_out, touched)
            self._coo_set("out_src_local", lu, e_out, 0, touched)
            self._coo_set("out_dst_global", lu, e_out, n, touched)
            self._bump_degree("out_degree", lu, ul, -1, touched)
            self._free_out[lu].append(e_out)
            self._log_undo(lambda: self._free_out[lu].pop())
        if into:
            e_in = pos_in.pop()
            self._log_undo(lambda: pos_in.append(e_in))
            self._ell_vacate("ell_in", lv, vl, u, touched)
            self._ell_vacate("ell_src", lv, u, e_in, touched)
            self._coo_set("in_src_global", lv, e_in, n, touched)
            self._coo_set("in_dst_local", lv, e_in, 0, touched)
            self._bump_degree("in_degree", lv, vl, -1, touched)
            self._free_in[lv].append(e_in)
            self._log_undo(lambda: self._free_in[lv].pop())

    # -- device patching ---------------------------------------------------

    def _apply_patches(self, touched) -> tuple[int, list]:
        """One patch per touched array that ships: its touched slots,
        as flat ``p * S + s`` positions in ascending order, with their
        final values read off the mirror.  Returns the slots patched and
        the arrays' keys."""
        n_slots, keys = 0, []
        for key, coords in sorted(touched.items()):
            if key not in self.garr:
                # layout="coo" engines never shipped the ELL arrays;
                # the host mirrors still track them for a later rebuild
                continue
            host = self._host_array(key)
            ps = np.array(sorted(coords), np.int64).reshape(-1, 2)
            self.garr[key] = self._patch_fn(
                self.garr[key], ps[:, 0] * host.shape[1] + ps[:, 1],
                host[ps[:, 0], ps[:, 1]])
            n_slots += len(ps)
            keys.append(key)
        return n_slots, keys

    # -- public API --------------------------------------------------------

    def plan(self, inserts=None, deletes=None
             ) -> tuple[np.ndarray, np.ndarray, bool]:
        """Validate one batch against the current graph WITHOUT mutating
        anything: returns ``(ins, dels, rebuild)`` where ``rebuild``
        says the batch overflows the free pools and ``apply`` would
        take the re-partition path.  Raises exactly what ``apply``
        would raise for an invalid batch (out-of-range endpoints,
        deletes of absent edges) — which is what lets the durability
        layer reject a batch BEFORE logging it.  Over ranks every rank
        returns, or raises, the same."""
        ins, dels = _as_pairs(inserts), _as_pairs(deletes)
        g = self.engine.g
        for arr, what in ((ins, "insert"), (dels, "delete")):
            if len(arr) and not ((arr >= 0) & (arr < g.n_orig)).all():
                raise ValueError(
                    f"{what} endpoints must be in [0, {g.n_orig})")
        try:
            self._check_capacity(ins, dels)
        except EllOverflow:
            return ins, dels, True
        return ins, dels, False

    def apply(self, inserts=None, deletes=None, *,
              force_rebuild: bool = False) -> MutationStats:
        """Apply one mutation batch; returns patch-path stats, or
        ``rebuild=True`` when the batch overflowed the free pools and
        the graph was re-partitioned instead.  Either way ``self.garr``
        is the new epoch's device graph and ``self.epoch`` advanced.
        ``force_rebuild=True`` takes the re-partition path even when
        the batch would fit — WAL replay uses it so a logged rebuild
        record deterministically re-takes the path the original
        execution took.  Over ranks a batch that fails on one rank is
        rolled back on every rank, and the stats count every rank's
        patches."""
        t0 = time.perf_counter()
        ins, dels, overflow = self.plan(inserts, deletes)
        if overflow or force_rebuild:
            return self._rebuild(ins, dels, t0)
        touched: dict[str, set] = {}
        garr_prev = dict(self.garr)        # refs only: patches are CoW
        self._undo = []
        try:
            err, n_slots, keys = None, 0, []
            try:
                for u, v in dels:         # deletes first: free the slots
                    self._delete_one(int(u), int(v), touched)
                for u, v in ins:
                    self._insert_one(int(u), int(v), touched)
                n_slots, keys = self._apply_patches(touched)
            except Exception as e:
                err = e
            said = self.engine.comm.gather_objects(
                (err is None, n_slots, keys))
            if err is not None:
                raise err
            if not all(ok for ok, _, _ in said):
                raise RuntimeError("mutation batch failed on another "
                                   "rank; rolled back on every rank")
        except BaseException:
            # failure atomicity: an exception mid-batch (planning OR
            # device patching, here or on another rank) replays the
            # journal in reverse — free stacks, position index,
            # occupancy, mirrors and the resident device graph all
            # return to the pre-batch epoch
            for undo in reversed(self._undo):
                undo()
            self.garr = garr_prev
            raise
        finally:
            self._undo = None
        self.epoch += 1
        return MutationStats(
            epoch=self.epoch, n_insert=len(ins), n_delete=len(dels),
            slots_patched=sum(n for _, n, _ in said),
            arrays_patched=len(set().union(*(k for _, _, k in said))),
            rebuild=False, apply_s=time.perf_counter() - t0)

    def _rebuild(self, ins, dels, t0) -> MutationStats:
        eng = self.engine
        g = eng.g
        cur = drop_first_instances(self.current_edges(), dels, g.n_orig)
        if len(ins):
            cur = np.concatenate([cur, ins])
        whole = partition_graph(cur, g.n_orig, g.parts)
        eng.g = whole.take_part(self._first) if eng.distributed else whole
        self.garr = eng.device_graph()
        self._rebuild_index()
        self.epoch += 1
        return MutationStats(
            epoch=self.epoch, n_insert=len(ins), n_delete=len(dels),
            slots_patched=0, arrays_patched=0, rebuild=True,
            apply_s=time.perf_counter() - t0)

    def current_edges(self) -> np.ndarray:
        """(E_live, 2) int64 edge list read off the out-shard mirrors
        (partition by partition, positions ascending) — what a rebuild
        re-partitions and what an oracle referees post-mutation answers
        against.  Over ranks every rank's part is gathered, in part
        order."""
        g = self.engine.g
        out = []
        for lp in range(self._held):
            ee = np.flatnonzero(g.out_dst_global[lp] < g.n)
            u = g.out_src_local[lp, ee].astype(np.int64) \
                + (self._first + lp) * g.n_local
            v = g.out_dst_global[lp, ee].astype(np.int64)
            out.append(np.stack([u, v], axis=1))
        mine = np.concatenate(out) if out else np.zeros((0, 2), np.int64)
        parts = self.engine.comm.gather_objects(mine)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    # -- capacity-aware sampling (tests / benches) -------------------------

    def _tallies(self):
        """Every part's ``(occupancy, free out-COO count, free in-COO
        count, ELL inverse maps)``, with a leading part dim, gathered
        from the ranks that hold them."""
        g = self.engine.g
        said = self.engine.comm.gather_objects((
            self._occ, [len(x) for x in self._free_out],
            [len(x) for x in self._free_in],
            {name: g.ell_arrays[f"{name}_inv"] for name in _ELL_NAMES}))
        occ = {name: np.concatenate([s[0][name] for s in said])
               for name in _ELL_NAMES}
        inv = {name: np.concatenate([s[3][name] for s in said])
               for name in _ELL_NAMES}
        return (occ, [c for s in said for c in s[1]],
                [c for s in said for c in s[2]], inv)

    def sample_insertable(self, k: int, rng) -> np.ndarray:
        """Sample k (u, v) pairs guaranteed to fit the free pools AS ONE
        BATCH — the deterministic way to exercise the patch path (random
        pairs may overflow a hot row, which is the rebuild path's job)."""
        g = self.engine.g
        occ, free_out, free_in, inv = self._tallies()

        def row(name, p, orig_row):
            return int(inv[name][p, orig_row])

        taken: Counter = Counter()         # cells this sample has filled
        out: list[tuple[int, int]] = []
        tries = 0
        while len(out) < k:
            tries += 1
            if tries > 200 * k + 1000:
                raise EllOverflow(
                    f"could not sample {k} insertable edges: free pools "
                    "exhausted")
            u = int(rng.integers(0, g.n_orig))
            v = int(rng.integers(0, g.n_orig))
            cells, pu, pv = self._cells(u, v, g.n_local, row)
            if free_out[pu] < 1 or free_in[pv] < 1:
                continue
            if any(occ[name][p, q] + taken[(name, p, q)]
                   >= self._row_layout[name][1][q]
                   for name, p, q in cells):
                continue
            free_out[pu] -= 1
            free_in[pv] -= 1
            taken.update(cells)
            out.append((u, v))
        return np.asarray(out, np.int64)

    def sample_deletable(self, k: int, rng) -> np.ndarray:
        """Sample k DISTINCT live edge instances (multigraph-safe: the
        multiset of sampled pairs never exceeds live multiplicity)."""
        cur = self.current_edges()
        if len(cur) < k:
            raise ValueError(f"only {len(cur)} live edges; cannot "
                             f"sample {k} deletions")
        pick = rng.choice(len(cur), size=k, replace=False)
        return cur[pick]
