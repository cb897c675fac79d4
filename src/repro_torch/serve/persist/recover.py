"""Restart recovery: newest digest-valid snapshot + WAL-suffix replay.

The loop, newest snapshot first:

  1. load + CRC-validate the snapshot (a flipped bit or torn write
     raises :class:`SnapshotCorrupt` -> try the next older one);
  2. rebuild the engine from the pickled mirrors, cross-check
     ``layout_signature()``, and restore the dynamic planner's EXACT
     free-slot state so replayed mutations land in the original slots;
  3. replay the WAL suffix through ``DynamicGraph.apply``: records with
     ``batch_id <= snapshot.batch_id`` are already folded in and SKIP
     (idempotence), rebuild records re-take the rebuild path
     (``force_rebuild=True``), and the scan stops at the first torn or
     corrupt record — the prefix-durability contract;
  4. verify: recompute the edge-multiset digest of the recovered
     ``current_edges()`` against the last replayed record's digest (or
     the snapshot's, when nothing replayed).  A mismatch condemns this
     snapshot and the loop falls back.

Only :class:`RecoveryFailed` escapes — carrying every per-snapshot
failure so a dead store is diagnosable from the exception alone.

The recovered engine lives on the card unless the caller names another
device (``device="cpu"``).

Over ranks (``mesh=make_graph_mesh(P)`` inside a group of P ranks,
every rank calling) the loop runs over the manifests instead, newest
first: each rank checks its own file against the manifest's digest and
the ranks agree; each loads its part, and every rank replays the WAL
that rank 0 keeps (rank 0 truncates a torn tail before the others read
it).  A directory written by ranks refuses a stacked recovery, and one
written stacked refuses a rank recovery, each with ``ValueError``.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.core.api import GraphEngine
from repro_torch.core.partitioned import gather_objects
from repro_torch.serve.dynamic.mutation import DynamicGraph
from repro_torch.serve.persist.snapshot import SnapshotCorrupt, \
    file_digest, find_manifests, find_snapshots, load_manifest, \
    load_snapshot, unpack_snapshot
from repro_torch.serve.persist.wal import WriteAheadLog, edge_digest, \
    read_records, wal_path


class RecoveryFailed(RuntimeError):
    """No snapshot in the directory survives validation + replay."""


@dataclass
class RecoveryReport:
    """What one successful recovery did (surfaced on the server as
    ``recovery_report`` and in the bench's ``recovery`` row)."""

    snapshot_epoch: int          # epoch of the snapshot recovery used
    epoch: int                   # epoch recovered to (snapshot + replay)
    batch_id: int                # last batch folded into the state
    replayed: int                # WAL records applied
    skipped: int                 # WAL records idempotently skipped
    rebuilds: int                # replayed records that re-partitioned
    wal_records: int             # valid records in the log
    snapshots_tried: int         # snapshots examined (1 = newest worked)


@dataclass
class RecoveredState:
    """Everything ``GraphServer.recover`` needs to resume serving."""

    engine: GraphEngine
    dynamic: DynamicGraph
    epoch: int
    seeds: dict
    mutation_log: list
    wal: WriteAheadLog | None            # rank 0's alone over ranks
    digest: int
    count: int
    batch_id: int
    persist_cfg: dict
    report: RecoveryReport


def recover_state(dir_: str, *, device=None, mesh=None) -> RecoveredState:
    """Recover the serving state from a durability directory onto
    ``device`` (default: the card, or raise without one); raises
    :class:`RecoveryFailed` when no snapshot validates end to end.
    ``mesh`` over ranks recovers a directory the ranks wrote, this
    rank's part (module docstring)."""
    snaps = find_snapshots(dir_)
    manifests = find_manifests(dir_)
    if mesh is not None and mesh.distributed:
        if snaps and not manifests:
            raise ValueError(
                f"{dir_!r} holds one process's snapshots (a stacked "
                "server's), not ranks' manifests; recover it without a "
                "distributed mesh")
        return _recover_ranks(dir_, device, mesh, manifests)
    if manifests:
        world = load_manifest(manifests[0][1])["world"]
        raise ValueError(
            f"{dir_!r} was written by {world} ranks (rank snapshots under "
            f"manifests); recover it on {world} ranks with "
            f"mesh=make_graph_mesh({world})")
    if not snaps:
        raise RecoveryFailed(f"{dir_!r}: no snapshots to recover from")
    wal = WriteAheadLog(wal_path(dir_))   # truncates any torn tail
    errors = []
    for tried, (snap_epoch, path) in enumerate(snaps, start=1):
        try:
            epoch, state = load_snapshot(path)
            if epoch != snap_epoch:
                raise SnapshotCorrupt(
                    f"header epoch {epoch} != filename epoch {snap_epoch}")
            return _recover_from(state, wal, wal.records, device, tried)
        except (SnapshotCorrupt, RecoveryFailed) as e:
            errors.append(f"  {path}: {e}")
    wal.close()
    raise RecoveryFailed(
        f"{dir_!r}: no digest-valid snapshot (tried {len(snaps)}):\n"
        + "\n".join(errors))


def _load_rank_part(dir_: str, man: dict, epoch: int, rank: int) -> dict:
    """This rank's state under a manifest, checked against its digest,
    its epoch, its part and the layout signature."""
    entry = man["files"][rank]
    try:
        with open(os.path.join(str(dir_), entry["name"]), "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotCorrupt(f"unreadable: {e}") from e
    if file_digest(data) != entry["sha256"]:
        raise SnapshotCorrupt(f"{entry['name']}: digest differs from the "
                              "manifest's")
    got, state = unpack_snapshot(data)
    if (got, state.get("part")) != (epoch, rank):
        raise SnapshotCorrupt(f"{entry['name']}: epoch {got} part "
                              f"{state.get('part')}, not {epoch} {rank}")
    if state["graph"].layout_signature() != state["layout_signature"]:
        raise SnapshotCorrupt(
            "pickled mirrors disagree with the recorded layout signature")
    return state


def _recover_ranks(dir_: str, device, mesh, manifests) -> RecoveredState:
    import torch.distributed as dist
    rank = dist.get_rank()
    if not manifests:
        raise RecoveryFailed(f"{dir_!r}: no manifests to recover from")
    # rank 0 keeps the log (and truncates a torn tail) before the
    # others read it
    wal = WriteAheadLog(wal_path(dir_)) if rank == 0 else None
    gather_objects(None)
    records = wal.records if wal is not None \
        else read_records(wal_path(dir_))
    errors = []
    for tried, (epoch, path) in enumerate(manifests, start=1):
        man = load_manifest(path)
        if man["world"] != mesh.parts:
            raise ValueError(
                f"{path}: written by {man['world']} ranks, recovered on "
                f"{mesh.parts}")
        state, err = None, None
        try:
            state = _load_rank_part(dir_, man, epoch, rank)
        except SnapshotCorrupt as e:
            err = f"rank {rank}: {e}"
        said = gather_objects(err)
        if any(said):
            errors.append(f"  {path}: " + "; ".join(e for e in said if e))
            continue
        try:
            return _recover_from(state, wal, records, device, tried, mesh)
        except RecoveryFailed as e:   # raised on every rank alike
            errors.append(f"  {path}: {e}")
    if wal is not None:
        wal.close()
    raise RecoveryFailed(
        f"{dir_!r}: no manifest whose rank files all validate (tried "
        f"{len(manifests)}):\n" + "\n".join(errors))


def _recover_from(state: dict, wal: WriteAheadLog | None, records: list,
                  device, tried: int, mesh=None) -> RecoveredState:
    g = state["graph"]
    if g.layout_signature() != state["layout_signature"]:
        raise RecoveryFailed(
            "pickled mirrors disagree with the recorded layout signature")
    engine = GraphEngine(g, device=device, layout=state["layout"],
                         mesh=mesh)
    dyn = DynamicGraph(engine, planner_state=state["planner"])
    dyn.epoch = int(state["epoch"])

    digest, count = int(state["digest"]), int(state["count"])
    batch_id = int(state["batch_id"])
    mutation_log = [dict(m) for m in state["mutation_log"]]
    replayed = skipped = rebuilds = 0
    for rec in records:
        if rec.batch_id <= batch_id:
            skipped += 1                    # already folded into the snapshot
            continue
        if rec.batch_id != batch_id + 1:
            raise RecoveryFailed(
                f"WAL gap: record {rec.batch_id} after batch {batch_id}")
        stats = dyn.apply(rec.inserts, rec.deletes,
                          force_rebuild=rec.rebuild)
        if dyn.epoch != rec.epoch:
            raise RecoveryFailed(
                f"replay of batch {rec.batch_id} landed on epoch "
                f"{dyn.epoch}, record says {rec.epoch}")
        mutation_log.append({
            "epoch": stats.epoch, "n_insert": stats.n_insert,
            "n_delete": stats.n_delete, "rebuild": stats.rebuild})
        rebuilds += int(stats.rebuild)
        batch_id = rec.batch_id
        digest, count = rec.digest, rec.count
        replayed += 1

    actual = edge_digest(dyn.current_edges())
    if actual != (digest, count):
        raise RecoveryFailed(
            f"edge-multiset digest mismatch after replay: recovered "
            f"{actual}, log says {(digest, count)}")

    report = RecoveryReport(
        snapshot_epoch=int(state["epoch"]), epoch=dyn.epoch,
        batch_id=batch_id, replayed=replayed, skipped=skipped,
        rebuilds=rebuilds, wal_records=len(records),
        snapshots_tried=tried)
    return RecoveredState(
        engine=engine, dynamic=dyn, epoch=dyn.epoch,
        seeds={k: (ep, arr) for k, (ep, arr) in state["seeds"].items()},
        mutation_log=mutation_log, wal=wal, digest=digest, count=count,
        batch_id=batch_id, persist_cfg=dict(state.get("persist", {})),
        report=report)
