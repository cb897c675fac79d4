"""Derived views over a ``SpanRecorder``: the ``trace_summary`` block a
traced run publishes and the latency cells derived from ``query`` spans.

``derive_latency_cells`` keeps the reference's contract with its
serving metrics (the serving layer is not ported yet): every resolved
query records a ``query`` span whose args carry the SAME ``latency_s``
float the metrics record (stored, not recomputed from ``t1 - t0``, so a
reconciliation can demand exact equality).
"""

from __future__ import annotations

from collections import Counter, defaultdict

import numpy as np


def _p99_ms(durs_s) -> float:
    arr = np.asarray(durs_s, dtype=np.float64)
    if arr.size == 0:
        return 0.0
    return float(np.percentile(arr, 99)) * 1e3


def trace_summary(rec, top: int = 3) -> dict:
    """Span counts per component + the top-``top`` p99 contributors
    (span kinds ranked by p99 duration) — the ``--json`` block."""
    spans = rec.spans()
    events = rec.events()
    durs = defaultdict(list)
    for s in spans:
        durs[s.kind].append(s.dur)
    ranked = sorted(
        ({"kind": kind, "count": len(ds), "p99_ms": round(_p99_ms(ds), 4)}
         for kind, ds in durs.items()),
        key=lambda row: -row["p99_ms"])
    return {
        "spans_total": len(spans),
        "events_total": len(events),
        "spans_per_component": dict(
            sorted(Counter(s.component for s in spans).items())),
        "spans_per_kind": dict(
            sorted(Counter(s.kind for s in spans).items())),
        "events_per_kind": dict(
            sorted(Counter(e.kind for e in events).items())),
        "top_p99_ms": ranked[:top],
        "dropped_spans": rec.dropped_spans,
        "dropped_events": rec.dropped_events,
    }


def derive_latency_cells(rec) -> dict:
    """{(label, bucket): [latency_s, ...]} from ``query`` spans — the
    derived view ``ServeMetrics`` latency cells must reconcile with.
    Only ``status == "ok"`` spans count, mirroring the metrics contract
    that latency cells hold answered queries (misses ride counters)."""
    cells: dict[tuple, list] = {}
    for s in rec.spans():
        if s.kind != "query" or s.args.get("status") != "ok":
            continue
        key = (s.args.get("label"), s.args.get("bucket"))
        cells.setdefault(key, []).append(s.args["latency_s"])
    return cells
