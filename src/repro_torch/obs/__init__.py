"""Observability: engine telemetry, spans, the instrument registry,
reports and trace export.

  ``telemetry.py``     the per-round ENGINE telemetry: the series
                       ``[done, halt, *probes]`` the superstep loops
                       write on the host when built with
                       ``telemetry=True`` (a cache dimension of
                       ``GraphEngine.program``, like ``guard=``; the off
                       path is the plain loop), and the wire record
                       measured from the exchanges' byte tallies in
                       ``core/partitioned.py``.
  ``spans.py``         the span/event model: a bounded ring buffer of
                       monotonic-timestamped spans and instant events
                       (the checkpoint runner's chunks, checkpoints,
                       detections and rollbacks).
  ``registry.py``      the declared span kinds + instrument registry
                       (counters / gauges / histograms) with the
                       markdown-table generators ``docs/API.md`` is
                       drift-tested against.
  ``report.py``        derived views: the plain-text roll-up report,
                       ``trace_summary``, and the latency cells derived
                       from query spans.
  ``trace_export.py``  Chrome trace-event (Perfetto-loadable) JSON:
                       per-component tracks for spans and events,
                       per-part tracks for engine rounds, plus the
                       schema validator.

Layering: this package imports nothing from ``repro_torch.core`` (numpy
and the standard library only), so ``core/`` calls into it without a
cycle.  It carries its own copy of the JAX package's ``repro.obs``:
the registry tables, the span model, the reports and the Chrome export
give the same values, and the telemetry differs where the port's eager
loop sees more (see ``telemetry.py``).
"""

from repro_torch.obs.registry import COMPONENTS, INSTRUMENTS, SPAN_KINDS, \
    Registry, instruments_markdown_table, spans_markdown_table
from repro_torch.obs.report import derive_latency_cells, rollup, \
    trace_summary
from repro_torch.obs.spans import NULL_RECORDER, Event, Span, SpanRecorder
from repro_torch.obs.telemetry import PhaseSeries, RunTelemetry, WireRecord
from repro_torch.obs.trace_export import chrome_trace, \
    validate_chrome_trace, write_trace

__all__ = [
    "COMPONENTS", "Event", "INSTRUMENTS", "NULL_RECORDER", "PhaseSeries",
    "Registry", "RunTelemetry", "SPAN_KINDS", "Span", "SpanRecorder",
    "WireRecord", "chrome_trace", "derive_latency_cells",
    "instruments_markdown_table", "rollup", "spans_markdown_table",
    "trace_summary", "validate_chrome_trace", "write_trace",
]
