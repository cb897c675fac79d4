"""Declared observability vocabulary + the runtime instrument registry.

Everything the subsystem can emit is declared HERE, statically:

  * ``COMPONENTS`` — the tracks a span/event can land on.  The trace
    exporter gives each component its own ``tid`` in declaration
    order, so track layout in Perfetto is stable across runs.
  * ``SPAN_KINDS`` — every interval kind, its canonical component, its
    Chrome export shape (``complete`` -> one "X" event; ``async`` ->
    "b"/"e" pairs, used for kinds that OVERLAP on one track: a query's
    lifetime brackets many nested server spans, device launches
    double-buffer), and a one-line description.
  * ``EVENT_KINDS`` — instant events ("i" in the export).
  * ``INSTRUMENTS`` — the counters/gauges/histograms the roll-up
    report knows about.  ``Registry`` refuses undeclared names, so an
    instrumentation site cannot silently invent a metric the docs
    table doesn't list.

``docs/API.md``'s Observability tables are generated by
``spans_markdown_table()`` / ``instruments_markdown_table()`` and
drift-tested with the same ``table in docs`` idiom as the algorithm
and crash-point tables.
"""

from __future__ import annotations

import numpy as np

# component -> description (declaration order = exported tid order)
COMPONENTS = {
    "server": "GraphServer request path (admission, demux, mutation)",
    "coalescer": "bucket-ladder batch formation",
    "executor": "double-buffered executor host side",
    "device": "device launches (dispatch -> done)",
    "durability": "WAL appends and snapshot writes",
    "engine": "superstep rounds from engine telemetry",
    "recovery": "checkpoint runner (chunks, detections, rollbacks)",
}

# kind -> (component, export, description); export in {complete, async}
SPAN_KINDS = {
    "query": ("server", "async",
              "whole query lifetime, submit -> resolve; args carry the "
              "exact latency_s ServeMetrics recorded"),
    "admission": ("server", "complete",
                  "submit_query: stamp, validate, hand to coalescer"),
    "validate": ("server", "complete",
                 "root/weight validation inside admission"),
    "coalesce_wait": ("coalescer", "async",
                      "batch formation: first admit -> batch formed"),
    "dispatch": ("executor", "complete",
                 "host-side build + dispatch of a formed batch"),
    "device": ("device", "async",
               "device launch in flight: t_dispatch -> t_done"),
    "demux": ("server", "complete",
              "launch result demux + per-query resolve"),
    "mutation": ("server", "complete",
                 "mutate(): barrier flush, apply, snapshot check"),
    "wal_append": ("durability", "complete",
                   "write-ahead-log record append (incl. flush)"),
    "snapshot": ("durability", "complete",
                 "crash-consistent snapshot write"),
    "recovery": ("server", "complete",
                 "GraphServer.recover(): snapshot load + WAL replay"),
    "engine_round": ("engine", "complete",
                     "one superstep (engine telemetry; rounds splay "
                     "the measured wall-time uniformly)"),
    "chunk": ("recovery", "complete",
              "one checkpointed chunk of rounds in CheckpointRunner"),
}

# instant events: kind -> (component, description)
EVENT_KINDS = {
    "fault_detection": ("recovery",
                        "guard tripped; chunk result discarded"),
    "rollback": ("recovery", "carry restored from last checkpoint"),
    "checkpoint": ("recovery", "chunk committed as a new checkpoint"),
    "shed": ("server", "query shed at admission (queue full)"),
    "rejected": ("server", "query rejected at validation"),
    "timed_out": ("server", "query deadline expired before dispatch"),
    "launch_failure": ("executor", "device launch raised; batch failed"),
}

# name -> (type, unit, description); type in {counter, gauge, histogram}
INSTRUMENTS = {
    "queries_submitted": ("counter", "1", "queries accepted at admission"),
    "queries_resolved": ("counter", "1", "query futures resolved (any "
                                         "status)"),
    "mutations_applied": ("counter", "1", "mutation batches applied"),
    "wal_appends": ("counter", "1", "WAL records appended"),
    "snapshots_written": ("counter", "1", "snapshots written"),
    "faults_detected": ("counter", "1", "checkpoint-runner detections"),
    "rollbacks": ("counter", "1", "checkpoint-runner rollbacks"),
    "spans_dropped": ("counter", "1", "spans lost to the ring bound"),
    "epoch": ("gauge", "1", "current snapshot epoch"),
    "wal_records": ("gauge", "1", "records in the live WAL"),
    "query_latency_ms": ("histogram", "ms", "submit -> resolve latency"),
    "batch_fill": ("histogram", "1", "queries per dispatched batch"),
    "device_ms": ("histogram", "ms", "device launch wall-time"),
    "wal_append_ms": ("histogram", "ms", "WAL append wall-time"),
}


class Registry:
    """Runtime counters/gauges/histograms over the declared names."""

    def __init__(self):
        self._counters: dict[str, int] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list[float]] = {}

    @staticmethod
    def _check(name: str, typ: str) -> None:
        decl = INSTRUMENTS.get(name)
        if decl is None or decl[0] != typ:
            raise KeyError(f"{name!r} is not a declared {typ} "
                           "(add it to obs.registry.INSTRUMENTS)")

    def count(self, name: str, n: int = 1) -> None:
        self._check(name, "counter")
        self._counters[name] = self._counters.get(name, 0) + n

    def gauge(self, name: str, value: float) -> None:
        self._check(name, "gauge")
        self._gauges[name] = float(value)

    def observe(self, name: str, value: float) -> None:
        self._check(name, "histogram")
        self._hists.setdefault(name, []).append(float(value))

    def snapshot(self) -> dict:
        """JSON-friendly state; histograms roll up to count/mean/p99."""
        hists = {}
        for name, vals in sorted(self._hists.items()):
            arr = np.asarray(vals, dtype=np.float64)
            hists[name] = {
                "count": int(arr.size),
                "mean": float(arr.mean()) if arr.size else 0.0,
                "p99": float(np.percentile(arr, 99)) if arr.size else 0.0,
            }
        return {"counters": dict(sorted(self._counters.items())),
                "gauges": dict(sorted(self._gauges.items())),
                "histograms": hists}


def spans_markdown_table() -> str:
    """Span + event kinds as one markdown table (docs-drift-tested)."""
    lines = ["| kind | component | shape | description |",
             "|------|-----------|-------|-------------|"]
    for kind, (comp, export, desc) in SPAN_KINDS.items():
        lines.append(f"| `{kind}` | {comp} | span ({export}) | {desc} |")
    for kind, (comp, desc) in EVENT_KINDS.items():
        lines.append(f"| `{kind}` | {comp} | event | {desc} |")
    return "\n".join(lines)


def instruments_markdown_table() -> str:
    """The instrument registry as a markdown table."""
    lines = ["| instrument | type | unit | description |",
             "|------------|------|------|-------------|"]
    for name, (typ, unit, desc) in INSTRUMENTS.items():
        lines.append(f"| `{name}` | {typ} | {unit} | {desc} |")
    return "\n".join(lines)
