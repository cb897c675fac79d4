"""Bucket tables of the blocked-ELL kernels (``spmv_ell``, ``bfs_pull``).

A bucket table is ``EllMeta.buckets``: ``(rows, K)`` runs in ELL row
order over a part's flat ``(slots,)`` index row, ``rows * K`` slots
each; a zero-width run holds rows with no slot.  The kernels take up to
:data:`MAX_BUCKETS` buckets in one launch, each as ``(row0, slot0, rows,
K)``; a longer table takes one launch per :data:`MAX_BUCKETS` buckets.
"""

from __future__ import annotations

import ctypes
import functools

import torch

MAX_BUCKETS = 64      # kMaxBuckets of csrc/spmv_ell.cu and csrc/bfs_pull.cu


@functools.lru_cache(maxsize=256)
def _table(buckets: tuple) -> tuple[tuple, int, int]:
    """(buckets as int pairs, slots, rows) of a valid table."""
    pairs = tuple((int(r), int(k)) for r, k in buckets)
    if not pairs or any(r < 0 or k < 0 for r, k in pairs):
        raise ValueError(f"bucket table {buckets!r} needs (rows, K) >= 0")
    rows = sum(r for r, _ in pairs)
    if rows < 1:
        raise ValueError("bucket table has no rows")
    return pairs, sum(r * k for r, k in pairs), rows


def check_table(flat: torch.Tensor, buckets, what: str) -> tuple[tuple, int]:
    """Raise unless ``flat`` is a (P, S) int32 tensor with contiguous
    slots that ``buckets`` covers exactly (``S == max(slots, 1)``, as
    ``core/graph.py`` lays it out).  Returns the table as a tuple of
    (rows, K) int pairs and its row count."""
    if flat.dtype != torch.int32 or flat.dim() != 2 or flat.shape[0] < 1:
        raise ValueError(f"{what} must be (P, slots) int32, got "
                         f"{tuple(flat.shape)} {flat.dtype}")
    if flat.stride(1) != 1:
        raise ValueError(f"{what} slots must be contiguous")
    pairs, slots, rows = _table(tuple(map(tuple, buckets)))
    if flat.shape[1] != max(slots, 1):
        raise ValueError(f"bucket table covers {slots} slots, {what} has "
                         f"{flat.shape[1]}")
    return pairs, rows


def bucket_views(flat: torch.Tensor, buckets):
    """Yield (row0, rows, K, (P, rows, K) view or None) per bucket."""
    off = r0 = 0
    for rows, k in buckets:
        rows, k = int(rows), int(k)
        blk = flat[:, off:off + rows * k].reshape(flat.shape[0], rows, k) \
            if k else None
        yield r0, rows, k, blk
        off += rows * k
        r0 += rows


@functools.lru_cache(maxsize=256)
def launch_tables(buckets: tuple) -> tuple:
    """The C tables of one call: per launch, a ctypes int64 array of
    (row0, slot0, rows, K) rows and its bucket count.  Buckets of no
    rows are left out."""
    rows_ = []
    off = r0 = 0
    for rows, k in buckets:
        rows, k = int(rows), int(k)
        if rows:
            rows_.append((r0, off, rows, k))
        off += rows * k
        r0 += rows
    tables = []
    for i in range(0, len(rows_), MAX_BUCKETS):
        part = rows_[i:i + MAX_BUCKETS]
        flat = [v for row in part for v in row]
        tables.append(((ctypes.c_longlong * len(flat))(*flat), len(part)))
    return tuple(tables)
