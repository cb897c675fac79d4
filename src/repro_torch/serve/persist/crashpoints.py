"""Deterministic crash points for the durability drills.

A kill drill needs the victim to die at an EXACT place in the
WAL/snapshot protocol, not "roughly during a mutation" — otherwise the
drill proves nothing about the ordering invariants.  Each named point
below is a ``maybe_crash(name)`` call compiled into the protocol; a
victim process opts in through the environment::

    REPRO_CRASH_POINT=<name>[:k]     # die at the k-th occurrence (default 1)

and dies with ``os._exit(CRASH_EXIT_CODE)`` — no atexit handlers, no
buffered flushes, exactly what ``kill -9`` at that instruction would
leave on disk.  Unset, every hook is a no-op.
"""

from __future__ import annotations

import os
import sys

ENV_VAR = "REPRO_CRASH_POINT"
CRASH_EXIT_CODE = 113

# name -> where in the protocol it fires (the docs table renders this)
CRASH_POINTS = {
    "between-batches":
        "top of `GraphServer.mutate()`, before the batch is logged "
        "or applied",
    "after-wal-append":
        "after the WAL record is written and fsynced, before the "
        "batch applies to the graph",
    "mid-snapshot-temp-write":
        "halfway through the snapshot temp-file write — a torn temp "
        "that is never renamed",
    "post-rename":
        "right after the snapshot's atomic rename, before old "
        "snapshots are pruned",
}

_counts: dict[str, int] = {}


def reset_counts() -> None:
    """Forget occurrence counts (tests that exercise ``:k`` specs)."""
    _counts.clear()


def maybe_crash(point: str) -> None:
    """Die here iff ``REPRO_CRASH_POINT`` names this point (and its
    occurrence count, ``name:k``, has been reached)."""
    if point not in CRASH_POINTS:
        raise ValueError(f"unknown crash point {point!r}; "
                         f"known: {sorted(CRASH_POINTS)}")
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return
    name, _, at = spec.partition(":")
    if name != point:
        return
    _counts[point] = _counts.get(point, 0) + 1
    if _counts[point] >= int(at or 1):
        sys.stderr.write(f"[persist] crash point {spec} firing\n")
        sys.stderr.flush()
        os._exit(CRASH_EXIT_CODE)


def crash_points_markdown_table() -> str:
    """The crash-point table as markdown (the JAX package's docs/API.md
    carries the same table)."""
    lines = ["| crash point | fires |", "| --- | --- |"]
    for name, where in CRASH_POINTS.items():
        lines.append(f"| `{name}` | {where} |")
    return "\n".join(lines)
