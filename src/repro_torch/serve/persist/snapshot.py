"""Crash-consistent snapshots of the serving state.

A snapshot is ONE file, written via the classic atomic-publish recipe:
serialize to ``.snapshot-<epoch>.tmp`` in the same directory, fsync the
temp, ``os.replace`` onto the final ``snapshot-<epoch>.bin`` name, then
fsync the directory.  A crash before the rename leaves a torn temp that
recovery ignores (and the next successful snapshot garbage-collects);
a crash after the rename leaves a complete, valid snapshot.  There is
no instruction at which a partially-written file is visible under a
snapshot name.

Envelope: ``RSNAP001 || u64 epoch || u32 crc32(epoch_le8 || payload) ||
u32 payload_len || payload`` where payload is the pickled state dict.
Everything after the magic is covered by the CRC (the epoch through its
inclusion in the checksummed bytes), so a single bit flip anywhere in
the file raises :class:`SnapshotCorrupt` on load — which is how
recovery decides to fall back to the previous snapshot.

What the state dict carries (``capture_state``): the pickled
:class:`~repro_torch.core.graph.GraphShards` host mirrors, the dynamic
planner's EXACT free-slot state (occupancy, free-stack order, the
position lists of the keys mutations touched — slot placement must
replay identically or float reduction orders drift and answers stop
being bit-identical), the epoch / batch-id / digest watermark,
``layout_signature()``, the warm-seed store, and the mutation log.
The envelope is the JAX package's; the payload pickles this package's
classes, so the two packages' snapshot files are not interchangeable.

No device tensor is ever pickled: mirrors and warm seeds are numpy,
and recovery re-uploads them.

Ranks.  A server over P ranks (one part a rank) snapshots in the same
envelope, one file a rank (``rank<r>-snapshot-<epoch>.bin``, each
rank's part of the state), and rank 0 commits the epoch with a
manifest (``manifest-<epoch>.json``: the world size, each rank file's
name, bytes and SHA-256) written by the same temp + fsync + rename +
directory-fsync recipe, once every rank's file is durable.  An epoch
without a manifest was never committed: a crash between two ranks'
writes recovers the previous one.
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import re
import struct
import zlib

import numpy as np

from repro_torch.serve.persist.crashpoints import maybe_crash

SNAP_MAGIC = b"RSNAP001"
_SNAP_HEADER = struct.Struct("<QII")    # epoch, crc32, payload length
FORMAT_VERSION = 1
_NAME_RE = re.compile(r"^snapshot-(\d{10})\.bin$")
_RANK_RE = re.compile(r"^rank(\d{3})-snapshot-(\d{10})\.bin$")
_MANIFEST_RE = re.compile(r"^manifest-(\d{10})\.json$")
MANIFEST_FORMAT = 1


class SnapshotCorrupt(RuntimeError):
    """Snapshot file failed its envelope validation (flip / truncation)."""


# -- envelope ----------------------------------------------------------------

def _envelope(epoch: int, state: dict) -> tuple[bytes, bytes]:
    """(magic + header, payload): the CRC runs over the epoch's bytes
    and then the payload, without concatenating them."""
    payload = pickle.dumps(state, protocol=4)
    crc = zlib.crc32(payload, zlib.crc32(struct.pack("<Q", epoch)))
    return SNAP_MAGIC + _SNAP_HEADER.pack(epoch, crc, len(payload)), payload


def pack_snapshot(epoch: int, state: dict) -> bytes:
    head, payload = _envelope(epoch, state)
    return head + payload


def unpack_snapshot(data: bytes) -> tuple[int, dict]:
    head = len(SNAP_MAGIC) + _SNAP_HEADER.size
    if len(data) < head or not data.startswith(SNAP_MAGIC):
        raise SnapshotCorrupt("bad snapshot magic / truncated header")
    epoch, crc, length = _SNAP_HEADER.unpack_from(data, len(SNAP_MAGIC))
    payload = memoryview(data)[head:]
    if len(payload) != length:
        raise SnapshotCorrupt(
            f"payload length {len(payload)} != stated {length}")
    if zlib.crc32(payload, zlib.crc32(struct.pack("<Q", epoch))) != crc:
        raise SnapshotCorrupt("snapshot CRC mismatch")
    try:
        state = pickle.loads(payload)
    except Exception as e:          # CRC passed but unpickle failed:
        raise SnapshotCorrupt(f"unpicklable payload: {e}") from e
    return epoch, state


# -- files -------------------------------------------------------------------

def snapshot_path(dir_: str, epoch: int) -> str:
    return os.path.join(str(dir_), f"snapshot-{epoch:010d}.bin")


def find_snapshots(dir_: str) -> list[tuple[int, str]]:
    """Published snapshots, newest epoch first.  Torn temps
    (``.snapshot-*.tmp``) are invisible here by construction."""
    out = []
    for name in os.listdir(dir_):
        m = _NAME_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(str(dir_), name)))
    return sorted(out, reverse=True)


def write_snapshot(dir_: str, epoch: int, state: dict,
                   fsync: bool = True) -> str:
    head, payload = _envelope(epoch, state)
    return _publish(snapshot_path(dir_, epoch), (head, payload), fsync)


def _fsync_dir(dir_: str) -> None:
    fd = os.open(str(dir_), os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _publish(final: str, parts, fsync: bool,
             crash_points: bool = True) -> str:
    """Write ``parts`` (bytes, in order) as ``final`` by the atomic
    recipe (temp ``.<stem>.tmp`` beside it, fsync, rename, directory
    fsync); the snapshot crash points fire inside unless
    ``crash_points`` is off."""
    chunks = tuple(memoryview(m) for m in parts)

    def write_span(f, lo: int, hi: int) -> None:
        """Bytes [lo, hi) of the parts, without joining them."""
        off = 0
        for m in chunks:
            a, b = max(lo - off, 0), min(hi - off, len(m))
            if a < b:
                f.write(m[a:b])
            off += len(m)

    total = sum(len(m) for m in chunks)
    dir_, name = os.path.split(final)
    tmp = os.path.join(dir_, "." + name.rsplit(".", 1)[0] + ".tmp")
    with open(tmp, "wb") as f:
        half = total // 2
        write_span(f, 0, half)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
        if crash_points:
            maybe_crash("mid-snapshot-temp-write")
        write_span(f, half, total)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, final)           # the atomic publish
    if fsync:
        _fsync_dir(dir_)
    if crash_points:
        maybe_crash("post-rename")
    return final


# -- one file a rank, committed by a manifest ---------------------------------

def rank_snapshot_name(epoch: int, rank: int) -> str:
    return f"rank{rank:03d}-snapshot-{epoch:010d}.bin"


def find_manifests(dir_: str) -> list[tuple[int, str]]:
    """Committed rank epochs' manifests, newest epoch first."""
    out = []
    for name in os.listdir(dir_):
        m = _MANIFEST_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(str(dir_), name)))
    return sorted(out, reverse=True)


def load_manifest(path: str) -> dict:
    try:
        with open(path, "rb") as f:
            man = json.loads(f.read())
        if man.get("format") != MANIFEST_FORMAT:
            raise ValueError(f"format {man.get('format')!r}")
        return man
    except (OSError, ValueError) as e:
        raise SnapshotCorrupt(f"{path}: bad manifest: {e}") from e


def file_digest(data) -> str:
    return hashlib.sha256(data).hexdigest()


def write_rank_snapshot(dir_: str, epoch: int, state: dict, comm, *,
                        fsync: bool = True, retain: int = 2) -> dict:
    """One rank's part of a rank server's snapshot: every rank writes
    its file, rank 0 commits the epoch's manifest once every file is
    durable (the gather of the files' digests is the barrier) and drops
    manifests past ``retain``, and each rank then drops its files that
    no manifest names.  Every rank calls this; returns this rank's
    manifest entry."""
    rank = comm.first_part
    head, payload = _envelope(epoch, state)
    name = rank_snapshot_name(epoch, rank)
    _publish(os.path.join(str(dir_), name), (head, payload), fsync)
    h = hashlib.sha256(head)
    h.update(payload)
    entry = {"rank": rank, "name": name, "bytes": len(head) + len(payload),
             "sha256": h.hexdigest()}
    files = comm.gather_objects(entry)
    if comm.leader:
        man = {"format": MANIFEST_FORMAT, "epoch": int(epoch),
               "world": comm.parts, "files": files}
        _publish(os.path.join(str(dir_), f"manifest-{epoch:010d}.json"),
                 (json.dumps(man, indent=1).encode(),), fsync,
                 crash_points=False)
        for _, path in find_manifests(dir_)[retain:]:
            os.unlink(path)
    comm.agree(True)                  # the manifest is committed
    keep = {e for e, _ in find_manifests(dir_)}
    for name in os.listdir(dir_):
        m = _RANK_RE.match(name)
        stale = m and int(m.group(1)) == rank and int(m.group(2)) not in keep
        torn = name.startswith(f".rank{rank:03d}-") and name.endswith(".tmp")
        if stale or torn:
            os.unlink(os.path.join(str(dir_), name))
    return entry


def load_snapshot(path: str) -> tuple[int, dict]:
    try:
        with open(path, "rb") as f:
            data = f.read()
    except OSError as e:
        raise SnapshotCorrupt(f"unreadable: {e}") from e
    return unpack_snapshot(data)


def prune_snapshots(dir_: str, retain: int) -> None:
    """Keep the ``retain`` newest snapshots; drop older ones and any
    stale temp files a crashed writer left behind."""
    for _, path in find_snapshots(dir_)[retain:]:
        os.unlink(path)
    for name in os.listdir(dir_):
        if name.startswith(".snapshot-") and name.endswith(".tmp"):
            os.unlink(os.path.join(str(dir_), name))


# -- state capture -----------------------------------------------------------

def capture_state(server, durability) -> dict:
    """Everything a restart needs for bit-identical serving, read off
    the live server (duck-typed: any GraphServer-shaped object works);
    on a rank, its part's mirrors and planner, and its part index."""
    dyn = server.dynamic_graph()
    cfg = durability.cfg
    state = {
        "format": FORMAT_VERSION,
        "epoch": int(server.epoch),
        "batch_id": int(durability.batch_id),
        "digest": int(durability.digest),
        "count": int(durability.count),
        "layout": server.engine.layout,
        "layout_signature": server.engine.g.layout_signature(),
        "graph": server.engine.g,
        "planner": dyn.planner_state(),
        # the store holds host arrays (served fields are copied to the
        # host at demux); np.asarray refuses a device tensor
        "seeds": {k: (int(ep), np.asarray(arr))
                  for k, (ep, arr) in server._seeds.items()},
        "mutation_log": [dict(m) for m in server.mutation_log],
        "persist": {"snapshot_every": cfg.snapshot_every,
                    "retain": cfg.retain, "fsync": cfg.fsync},
    }
    if server.ranks:                  # this rank's part of the state
        state["part"] = server.engine.comm.first_part
        state["world"] = server.engine.comm.parts
    return state
