"""Serving metrics: queries/sec and latency percentiles per
(program, bucket) cell.

Latency is admission-to-demux (queue wait + launch + demux slice), the
number a client of the server would see.  Cells are keyed by the
program label and the launch bucket width the query actually rode
(0 = shared refresh launch), so the bench can compare the ladder rungs
directly — ``qps`` at bucket 32 vs bucket 1 IS the coalescing win.

The measurement window opens at the FIRST ADMISSION (``GraphServer``
calls :meth:`ServeMetrics.start` from ``submit_query``) and closes at
the last demux — the first query's queue wait is inside the window, so
``qps`` never overcounts a burst that sat queued before its first
launch.  ``start`` is idempotent; a bare :meth:`record` still
self-opens the window for direct/standalone use.
"""

from __future__ import annotations

import time

import numpy as np


COUNTERS = ("shed", "timed_out", "retries", "quarantined", "rejected")


def percentiles(lat, qs=(50, 95, 99)):
    """Latency percentiles with EXPLICIT small-sample semantics.

    ``np.percentile`` on tiny cells is easy to misread (one sample
    "has" a p99; two samples interpolate), so the degenerate cases are
    spelled out rather than inherited:

      0 samples -> all zeros (an empty cell reports 0.0, not NaN)
      1 sample  -> every percentile IS that sample
      2+        -> linear-interpolated ``np.percentile`` (the default
                   method), so p50 of two samples is their midpoint and
                   p99 leans toward the max — documented, not accidental.
    """
    lat = np.asarray(lat, np.float64)
    if lat.size == 0:
        return tuple(0.0 for _ in qs)
    if lat.size == 1:
        return tuple(float(lat[0]) for _ in qs)
    return tuple(float(v) for v in np.percentile(lat, qs))


class ServeMetrics:
    """Latency cells record only ``status == "ok"`` answers — p99 of a
    cell is the tail of latencies clients actually waited for an answer
    through.  Resilience events ride the ``counts`` dict instead
    (:data:`COUNTERS`): shed admissions, deadline misses, launch
    retries, quarantined poison queries, admission rejects."""

    def __init__(self):
        self._lat: dict[tuple[str, int], list[float]] = {}
        self._t0: float | None = None
        self._t1: float | None = None
        self.counts: dict[str, int] = {c: 0 for c in COUNTERS}
        # durability / dynamic-graph observability (the server keeps
        # these current): snapshot epoch being served, restarts this
        # process recovered through, valid records in the open WAL
        self.epoch = 0
        self.recoveries = 0
        self.wal_records = 0

    def count(self, name: str, k: int = 1) -> None:
        self.counts[name] = self.counts.get(name, 0) + k

    def start(self) -> None:
        if self._t0 is None:
            self._t0 = time.perf_counter()

    def stop(self) -> None:
        self._t1 = time.perf_counter()

    def record(self, label: str, bucket: int, latency_s: float) -> None:
        self.start()
        self._lat.setdefault((label, bucket), []).append(latency_s)
        self._t1 = time.perf_counter()

    def latencies(self) -> dict[tuple[str, int], list[float]]:
        """Raw per-cell ``ok`` latencies (seconds), copied.  The span
        layer (``obs.report.derive_latency_cells``) reconstructs this
        exact mapping from query spans — the reconciliation the obs
        tests pin — so the metrics cells are a derived view of the
        trace, not a second source of truth."""
        return {k: list(v) for k, v in self._lat.items()}

    @property
    def window_s(self) -> float:
        if self._t0 is None:
            return 0.0
        return max((self._t1 or time.perf_counter()) - self._t0, 1e-9)

    def rows(self) -> list[dict]:
        """One dict per (algo, bucket) cell: count, qps, p50/p95/p99 ms.

        ``qps`` is cell throughput over the shared measurement window —
        under a mixed stream the cells split the window, so per-cell qps
        sums to total throughput.
        """
        out = []
        for (label, bucket) in sorted(self._lat):
            lat = np.asarray(self._lat[(label, bucket)], np.float64)
            p50, p95, p99 = (v * 1e3 for v in percentiles(lat))
            out.append({
                "algo": label, "bucket": bucket, "count": int(lat.size),
                "qps": round(lat.size / self.window_s, 2),
                "p50_ms": round(float(p50), 2),
                "p95_ms": round(float(p95), 2),
                "p99_ms": round(float(p99), 2),
            })
        return out

    def snapshot(self) -> dict:
        """One JSON-ready dict of everything observable: the latency
        cells, the resilience counters, and the durability state
        (epoch / recoveries / wal_records) — what ``graph_serve --json``
        publishes, so overload and recovery drills are scriptable
        without grepping logs."""
        return {
            "window_s": round(self.window_s, 4),
            "epoch": int(self.epoch),
            "recoveries": int(self.recoveries),
            "wal_records": int(self.wal_records),
            "counts": dict(self.counts),
            "rows": self.rows(),
        }

    def table(self) -> str:
        rows = self.rows()
        lines = [f"{'program':16s} {'bucket':>6s} {'count':>6s} "
                 f"{'qps':>8s} {'p50_ms':>8s} {'p95_ms':>8s} {'p99_ms':>8s}"]
        for r in rows:
            b = str(r["bucket"]) if r["bucket"] else "shared"
            lines.append(
                f"{r['algo']:16s} {b:>6s} {r['count']:6d} {r['qps']:8.1f} "
                f"{r['p50_ms']:8.1f} {r['p95_ms']:8.1f} {r['p99_ms']:8.1f}")
        lines.append(f"{'total':16s} {'':>6s} "
                     f"{sum(r['count'] for r in rows):6d} "
                     f"{sum(r['qps'] for r in rows):8.1f} "
                     f"(window {self.window_s:.2f}s)")
        if any(self.counts.values()):
            lines.append("  ".join(f"{k}={v}"
                                   for k, v in sorted(self.counts.items())
                                   if v))
        return "\n".join(lines)
