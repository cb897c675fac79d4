"""Write-ahead log of mutation batches: length-prefixed, CRC-checksummed
append-only records, one per ``GraphServer.mutate()`` batch.

File layout::

    RWAL0001                                   8-byte file magic
    [u32 payload_len][u32 crc32(payload)][payload]   repeated

Payload (all little-endian, no padding)::

    u64 batch_id    monotone from 1; the replay idempotence key
    u64 epoch       the epoch this batch PRODUCES when applied
    u8  rebuild     1 = the batch overflowed the free pools and took
                    the re-partition path; replay forces the same path
    u64 digest      post-apply edge-multiset digest (see below)
    u64 count       post-apply live-edge count
    u32 n_ins, u32 n_del
    n_ins x (i64 u, i64 v) insert pairs, then n_del x (i64, i64) deletes

The record is written and fsynced BEFORE the batch applies (the digest
is computable up front because it is commutative — see
``update_digest``), so a crash at any instruction leaves one of two
states: record absent and batch unapplied, or record present and batch
applied-or-replayable.  Never an applied batch missing from the log.

A torn tail (partial final record after a crash mid-append) is detected
by the length prefix / CRC on open and truncated away; a bit flip
anywhere in a record fails its CRC, and the scan stops at the first bad
record — everything after it is unreachable, which is exactly the
prefix-durability contract recovery relies on.

The format is plain bytes, the JAX package's byte for byte: a log
either package wrote, the other reads.
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from repro_torch.serve.persist.crashpoints import maybe_crash

FILE_MAGIC = b"RWAL0001"
_HEADER = struct.Struct("<II")       # payload length, crc32(payload)
_FIXED = struct.Struct("<QQBQQII")   # batch_id epoch rebuild digest count
                                     # n_ins n_del
_U64 = (1 << 64) - 1


class WalError(RuntimeError):
    """Malformed WAL framing (bad magic / short or inconsistent payload)."""


@dataclass
class WalRecord:
    """One logged mutation batch (see module docstring for semantics)."""

    batch_id: int
    epoch: int
    rebuild: bool
    digest: int          # post-apply edge-multiset digest, in [0, 2^64)
    count: int           # post-apply live-edge count
    inserts: np.ndarray = field(default_factory=lambda: np.zeros((0, 2),
                                                                 np.int64))
    deletes: np.ndarray = field(default_factory=lambda: np.zeros((0, 2),
                                                                 np.int64))


# -- edge-multiset digest ----------------------------------------------------
#
# Commutative over edges: digest = sum over (u, v) of mix64(u, v) mod
# 2^64, plus the live count.  Commutativity is the load-bearing
# property — the post-apply digest of a batch is computable BEFORE the
# batch applies (old digest + inserts - deletes), which is what lets
# the WAL record carry it while still being written ahead of the apply.

def _mix64(x: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer on a uint64 array (wraps mod 2^64)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def edge_digest(edges) -> tuple[int, int]:
    """(digest, count) of an edge multiset — order-independent, and
    sensitive to multiplicity through the count + per-edge hash sum."""
    e = np.asarray(edges, np.int64).reshape(-1, 2)
    if not len(e):
        return 0, 0
    with np.errstate(over="ignore"):
        u = e[:, 0].astype(np.uint64)
        v = e[:, 1].astype(np.uint64)
        h = _mix64(_mix64(u + np.uint64(0x9E3779B97F4A7C15)) ^
                   (v * np.uint64(0xC2B2AE3D27D4EB4F)))
        return int(np.sum(h, dtype=np.uint64)), len(e)


def update_digest(digest: int, count: int, inserts, deletes
                  ) -> tuple[int, int]:
    """Fold one batch into (digest, count) arithmetically — the
    pre-apply computation of the post-apply digest."""
    di, ci = edge_digest(inserts)
    dd, cd = edge_digest(deletes)
    return (digest + di - dd) & _U64, count + ci - cd


# -- record framing ----------------------------------------------------------

def encode_record(rec: WalRecord) -> bytes:
    """One framed record: ``[len][crc][payload]`` (canonical — equal
    records encode to identical bytes)."""
    ins = np.ascontiguousarray(np.asarray(rec.inserts, np.int64)
                               .reshape(-1, 2))
    dels = np.ascontiguousarray(np.asarray(rec.deletes, np.int64)
                                .reshape(-1, 2))
    payload = _FIXED.pack(rec.batch_id, rec.epoch, int(rec.rebuild),
                          rec.digest & _U64, rec.count,
                          len(ins), len(dels)) \
        + ins.tobytes() + dels.tobytes()
    return _HEADER.pack(len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> WalRecord:
    if len(payload) < _FIXED.size:
        raise WalError(f"payload too short: {len(payload)} bytes")
    bid, epoch, rebuild, digest, count, n_ins, n_del = \
        _FIXED.unpack_from(payload)
    need = _FIXED.size + 16 * (n_ins + n_del)
    if len(payload) != need:
        raise WalError(f"payload length {len(payload)} != {need} "
                       f"for {n_ins} inserts + {n_del} deletes")
    ins = np.frombuffer(payload, np.int64, 2 * n_ins,
                        _FIXED.size).reshape(-1, 2)
    dels = np.frombuffer(payload, np.int64, 2 * n_del,
                         _FIXED.size + 16 * n_ins).reshape(-1, 2)
    return WalRecord(bid, epoch, bool(rebuild), digest, count,
                     ins.copy(), dels.copy())


def scan_records(data: bytes, offset: int = 0
                 ) -> tuple[list[WalRecord], int]:
    """Parse the maximal valid record prefix of ``data[offset:]``;
    returns ``(records, end_offset)`` where ``end_offset`` is the byte
    after the last valid record.  A torn tail, a flipped bit, or any
    framing damage stops the scan — it never raises."""
    recs: list[WalRecord] = []
    while True:
        if offset + _HEADER.size > len(data):
            break
        length, crc = _HEADER.unpack_from(data, offset)
        end = offset + _HEADER.size + length
        if length < _FIXED.size or end > len(data):
            break
        payload = data[offset + _HEADER.size:end]
        if zlib.crc32(payload) != crc:
            break
        try:
            recs.append(decode_payload(payload))
        except WalError:
            break
        offset = end
    return recs, offset


# -- the log file ------------------------------------------------------------

class WriteAheadLog:
    """Append-only record log over one file.

    Opening an existing log scans it, keeps the valid record prefix in
    ``self.records``, and truncates any torn tail off the file; opening
    a fresh path writes the file magic.  ``append`` is durable before
    it returns (write + flush + fsync) and returns the pre-append byte
    offset so a caller whose apply subsequently fails can
    ``truncate_to`` it — keeping "record present <=> batch applied or
    replayable" an invariant rather than a hope.
    """

    def __init__(self, path, fsync: bool = True):
        self.path = str(path)
        self.fsync = bool(fsync)
        self.records: list[WalRecord] = []
        if os.path.exists(self.path) and os.path.getsize(self.path):
            with open(self.path, "rb") as f:
                data = f.read()
            if not data.startswith(FILE_MAGIC):
                raise WalError(f"{self.path}: not a WAL (bad file magic)")
            self.records, end = scan_records(data, len(FILE_MAGIC))
            if end < len(data):              # torn tail from a crash
                with open(self.path, "r+b") as f:
                    f.truncate(end)
        else:
            with open(self.path, "wb") as f:
                f.write(FILE_MAGIC)
                f.flush()
                if self.fsync:
                    os.fsync(f.fileno())
        self._f = open(self.path, "ab")
        self._end = os.path.getsize(self.path)

    @property
    def n_records(self) -> int:
        return len(self.records)

    def append(self, rec: WalRecord) -> int:
        """Durably append one record; returns the byte offset the
        record starts at (the ``truncate_to`` target on apply failure)."""
        buf = encode_record(rec)
        off = self._end
        self._f.write(buf)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        maybe_crash("after-wal-append")
        self._end = off + len(buf)
        self.records.append(rec)
        return off

    def truncate_to(self, offset: int) -> None:
        """Drop every record at/after ``offset`` (undo of appends whose
        apply failed, so the log never outruns reality by a dead record)."""
        if not len(FILE_MAGIC) <= offset <= self._end:
            raise WalError(f"truncate offset {offset} outside "
                           f"[{len(FILE_MAGIC)}, {self._end}]")
        self._f.close()
        with open(self.path, "r+b") as f:
            f.truncate(offset)
        while self._end > offset and self.records:
            self._end -= len(encode_record(self.records.pop()))
        if self._end != offset:
            raise WalError(f"truncate offset {offset} is not a record "
                           "boundary")
        self._f = open(self.path, "ab")

    def close(self) -> None:
        self._f.close()


def read_records(path) -> list[WalRecord]:
    """The valid record prefix of a log, read without opening it for
    append (a rank other than 0 replays the WAL that rank 0 keeps)."""
    with open(str(path), "rb") as f:
        data = f.read()
    if not data.startswith(FILE_MAGIC):
        raise WalError(f"{path}: not a WAL (bad file magic)")
    return scan_records(data, len(FILE_MAGIC))[0]


def wal_path(dir_: str) -> str:
    return os.path.join(str(dir_), "wal.log")
