"""Durable serving state: WAL + crash-consistent snapshots + recovery.

The resident ``GraphServer`` is long-lived infrastructure; this package
makes it crash-recoverable with BIT-IDENTICAL post-restart answers:

  ``wal.py``       write-ahead log of every mutation batch — logged and
                   fsynced BEFORE the batch applies, with a
                   commutative post-apply edge-multiset digest.
  ``snapshot.py``  periodic whole-state snapshots via write-temp +
                   atomic rename: graph mirrors, the planner's exact
                   free-slot state, warm seeds, the epoch watermark.
  ``recover.py``   newest digest-valid snapshot + WAL-suffix replay
                   through ``DynamicGraph.apply`` (idempotent on batch
                   id, rebuild records re-take the rebuild path), then
                   an end-to-end digest check of ``current_edges()``.

Wiring: ``GraphServer(engine, persistence=Persistence(dir=...))``
starts durable from scratch; ``GraphServer.recover(dir)`` resumes.
:class:`DurabilityState` runs the protocol for one server, called from
``mutate()``: ``logged_apply`` (WAL-before-apply ordering) then
``maybe_snapshot`` (every ``snapshot_every`` epochs).

Over ranks (a ``DistComm`` server, one part a rank) rank 0 alone keeps
the WAL, byte for byte the stacked server's for the same batches, and
each rank snapshots its own part; rank 0 commits each snapshot epoch
with a manifest of the rank files' digests (``snapshot.py``), and
``recover_state(dir, mesh=)`` loads each rank's part from the newest
manifest whose files all pass, then replays the WAL on every rank.  A
directory of one kind refuses to recover as the other.

Crash points (``crashpoints.py``) compile deterministic kill sites into
the protocol, so a drill can kill a server at one exact instruction and
prove that recovery lands on the exact epoch + edge multiset.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.obs import NULL_RECORDER
from repro_torch.serve.persist.crashpoints import CRASH_EXIT_CODE, CRASH_POINTS, \
    ENV_VAR, crash_points_markdown_table, maybe_crash, reset_counts
from repro_torch.serve.persist.snapshot import SnapshotCorrupt, capture_state, \
    find_manifests, find_snapshots, load_snapshot, prune_snapshots, \
    write_rank_snapshot, write_snapshot
from repro_torch.serve.persist.wal import WalError, WalRecord, WriteAheadLog, \
    edge_digest, update_digest, wal_path

__all__ = [
    "CRASH_EXIT_CODE", "CRASH_POINTS", "ENV_VAR", "DurabilityState",
    "Persistence", "SnapshotCorrupt", "WalError", "WalRecord",
    "WriteAheadLog", "as_persistence", "crash_points_markdown_table",
    "edge_digest", "maybe_crash", "reset_counts", "update_digest",
    "wal_path",
]


@dataclass
class Persistence:
    """Durability config for one server.

    ``dir`` holds the WAL (``wal.log``) and snapshots; ``snapshot_every``
    is the epoch stride between snapshot pumps; ``retain`` how many
    published snapshots to keep (>= 2 so a corrupt newest still has a
    fallback); ``fsync=False`` trades durability for test speed."""

    dir: str
    snapshot_every: int = 8
    retain: int = 2
    fsync: bool = True

    def __post_init__(self):
        if self.snapshot_every < 1:
            raise ValueError(
                f"snapshot_every must be >= 1: {self.snapshot_every}")
        if self.retain < 1:
            raise ValueError(f"retain must be >= 1: {self.retain}")


def as_persistence(obj) -> Persistence:
    if isinstance(obj, Persistence):
        return obj
    if isinstance(obj, (str, os.PathLike)):
        return Persistence(dir=str(obj))
    raise TypeError(f"persistence must be a dir path or Persistence: "
                    f"{type(obj).__name__}")


class DurabilityState:
    """The WAL/snapshot protocol of one GraphServer.

    Holds the open log plus the running (digest, count, batch_id)
    watermark — the arithmetic shadow of the edge multiset that lets
    each record carry its POST-apply digest while still being written
    ahead of the apply.  ``comm`` is a rank server's ``DistComm`` (None
    stacked): every rank keeps the watermark, rank 0 alone the log
    (``wal`` None elsewhere)."""

    def __init__(self, cfg: Persistence, wal: WriteAheadLog | None,
                 digest: int, count: int, batch_id: int,
                 last_snapshot_epoch: int | None, comm=None):
        self.cfg = cfg
        self.wal = wal
        self.comm = comm
        self.digest = digest
        self.count = count
        self.batch_id = batch_id
        self.last_snapshot_epoch = last_snapshot_epoch
        # span recorder for durability-path observability; the owning
        # server swaps in its own (obs/spans.py) when tracing is on
        self.obs = NULL_RECORDER

    @property
    def wal_records(self) -> int:
        return self.wal.n_records if self.wal is not None else 0

    @classmethod
    def create(cls, server, persistence) -> "DurabilityState":
        """Start durable from scratch: refuses a directory that already
        holds durable state (that is ``GraphServer.recover``'s job),
        writes the base snapshot so the WAL always has a floor.  Over
        ranks every rank calls this, and every rank refuses if any
        sees state."""
        cfg = as_persistence(persistence)
        comm = server.engine.comm if server.ranks else None
        os.makedirs(cfg.dir, exist_ok=True)
        held = bool(find_snapshots(cfg.dir) or find_manifests(cfg.dir)
                    or os.path.exists(wal_path(cfg.dir)))
        if comm is not None:
            held = not comm.agree(not held)
        if held:
            raise ValueError(
                f"{cfg.dir!r} already holds durable state; use "
                f"GraphServer.recover({cfg.dir!r}) to resume it")
        dyn = server.dynamic_graph()
        digest, count = edge_digest(dyn.current_edges())
        wal = WriteAheadLog(wal_path(cfg.dir), fsync=cfg.fsync) \
            if comm is None or comm.leader else None
        st = cls(cfg, wal, digest, count, batch_id=0,
                 last_snapshot_epoch=None, comm=comm)
        st.snapshot_now(server)
        return st

    @classmethod
    def resume(cls, cfg: Persistence, wal: WriteAheadLog | None,
               digest: int, count: int, batch_id: int,
               last_snapshot_epoch: int, comm=None) -> "DurabilityState":
        return cls(cfg, wal, digest, count, batch_id, last_snapshot_epoch,
                   comm)

    # -- the protocol --------------------------------------------------------

    def logged_apply(self, dyn, inserts=None, deletes=None):
        """WAL-before-apply: plan the batch (validation + the
        patch-vs-rebuild decision), log + fsync its record, THEN apply.
        An apply that still fails after logging truncates the orphan
        record back off — the log never names a batch that neither
        applied nor can replay.  Over ranks the plan and the apply are
        agreed (``DynamicGraph``) and rank 0 logs."""
        ins, dels, rebuild = dyn.plan(inserts, deletes)
        digest, count = update_digest(self.digest, self.count, ins, dels)
        rec = WalRecord(batch_id=self.batch_id + 1, epoch=dyn.epoch + 1,
                        rebuild=rebuild, digest=digest, count=count,
                        inserts=ins, deletes=dels)
        off = None
        if self.wal is not None:
            with self.obs.span("wal_append", "durability",
                               batch_id=rec.batch_id, epoch=rec.epoch,
                               n_insert=len(ins), n_delete=len(dels),
                               rebuild=bool(rebuild)):
                off = self.wal.append(rec)
        try:
            stats = dyn.apply(ins, dels, force_rebuild=rebuild)
        except BaseException:
            if off is not None:
                self.wal.truncate_to(off)
            raise
        self.digest, self.count = digest, count
        self.batch_id += 1
        return stats

    def maybe_snapshot(self, server) -> bool:
        due = (self.last_snapshot_epoch is None
               or server.epoch - self.last_snapshot_epoch
               >= self.cfg.snapshot_every)
        if due:
            self.snapshot_now(server)
        return due

    def snapshot_now(self, server) -> None:
        with self.obs.span("snapshot", "durability", epoch=server.epoch):
            state = capture_state(server, self)
            if self.comm is not None:
                write_rank_snapshot(self.cfg.dir, server.epoch, state,
                                    self.comm, fsync=self.cfg.fsync,
                                    retain=self.cfg.retain)
            else:
                write_snapshot(self.cfg.dir, server.epoch, state,
                               fsync=self.cfg.fsync)
                prune_snapshots(self.cfg.dir, self.cfg.retain)
            self.last_snapshot_epoch = server.epoch

    def close(self) -> None:
        if self.wal is not None:
            self.wal.close()
