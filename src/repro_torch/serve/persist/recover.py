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
"""

from __future__ import annotations

from dataclasses import dataclass

from repro_torch.core.api import GraphEngine
from repro_torch.serve.dynamic.mutation import DynamicGraph
from repro_torch.serve.persist.snapshot import SnapshotCorrupt, find_snapshots, \
    load_snapshot
from repro_torch.serve.persist.wal import WriteAheadLog, edge_digest, wal_path


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
    wal: WriteAheadLog
    digest: int
    count: int
    batch_id: int
    persist_cfg: dict
    report: RecoveryReport


def recover_state(dir_: str, *, device=None) -> RecoveredState:
    """Recover the serving state from a durability directory onto
    ``device`` (default: the card, or raise without one); raises
    :class:`RecoveryFailed` when no snapshot validates end to end."""
    snaps = find_snapshots(dir_)
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
            return _recover_from(state, wal, device, tried)
        except (SnapshotCorrupt, RecoveryFailed) as e:
            errors.append(f"  {path}: {e}")
    wal.close()
    raise RecoveryFailed(
        f"{dir_!r}: no digest-valid snapshot (tried {len(snaps)}):\n"
        + "\n".join(errors))


def _recover_from(state: dict, wal: WriteAheadLog, device,
                  tried: int) -> RecoveredState:
    g = state["graph"]
    if g.layout_signature() != state["layout_signature"]:
        raise RecoveryFailed(
            "pickled mirrors disagree with the recorded layout signature")
    engine = GraphEngine(g, device=device, layout=state["layout"])
    dyn = DynamicGraph(engine, planner_state=state["planner"])
    dyn.epoch = int(state["epoch"])

    digest, count = int(state["digest"]), int(state["count"])
    batch_id = int(state["batch_id"])
    mutation_log = [dict(m) for m in state["mutation_log"]]
    replayed = skipped = rebuilds = 0
    for rec in wal.records:
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
        rebuilds=rebuilds, wal_records=wal.n_records,
        snapshots_tried=tried)
    return RecoveredState(
        engine=engine, dynamic=dyn, epoch=dyn.epoch,
        seeds={k: (ep, arr) for k, (ep, arr) in state["seeds"].items()},
        mutation_log=mutation_log, wal=wal, digest=digest, count=count,
        batch_id=batch_id, persist_cfg=dict(state.get("persist", {})),
        report=report)
