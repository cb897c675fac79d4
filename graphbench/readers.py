"""Arithmetic shared by the metric files in ``metrics/``.

Each reader takes the run's :class:`graphbench.harness.Record` and
returns a number, or None where the run has nothing to read (another
program's cell, an untraced run for a trace metric, a card the peak
table does not hold).  None leaves the metric out of the result line.
"""

from __future__ import annotations

import statistics


def _of(record, program: str, traced: bool) -> bool:
    return record.program == program and record.traced == traced \
        and bool(record.durations_s)


def rate_per_s(record, program: str) -> float | None:
    """Work completed in the window over the window's time."""
    if not _of(record, program, False):
        return None
    return sum(record.work) / record.window_s


def time_per_call_s(record, program: str) -> float | None:
    """The window's time over the calls completed in it."""
    if not _of(record, program, False):
        return None
    return record.window_s / len(record.durations_s)


def percentile_s(record, program: str, q: int) -> float | None:
    """The ``q``-th percentile of every call's time in the window
    (``statistics.quantiles``, inclusive method)."""
    if not _of(record, program, False) or len(record.durations_s) < 2:
        return None
    return statistics.quantiles(record.durations_s, n=100,
                                method="inclusive")[q - 1]


def syncs_per_call(record, program: str) -> float | None:
    if not _of(record, program, True) or record.trace is None:
        return None
    return record.trace.syncs_per_call


def wire_mb_per_call(record, program: str) -> float | None:
    if not _of(record, program, True) or not record.wire_bytes:
        return None
    return statistics.fmean(record.wire_bytes) / 1e6


def roofline_pct(record, program: str) -> float | None:
    """The least bytes of the traced calls at the card's peak bandwidth,
    over the device-busy time of those calls."""
    if not _of(record, program, True) or record.trace is None \
            or not record.hbm_bytes_per_s:
        return None
    busy = sum(record.trace.call_busy_s)
    if busy <= 0:
        return None
    return 100.0 * sum(record.least_bytes) / record.hbm_bytes_per_s / busy


def idle_pct(record, program: str) -> float | None:
    if not _of(record, program, True) or record.trace is None \
            or record.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - record.trace.busy_s / record.trace.window_s)


def scaled(value: float | None, factor: float) -> float | None:
    return None if value is None else value * factor
