"""Observability: engine telemetry, spans and the layer sites, the
declared vocabulary, reports and trace export.

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
                       (serving, the checkpoint runner's chunks,
                       checkpoints, detections and rollbacks), and the
                       analytics path's layer sites (``span``,
                       ``spanned``, the current recorder ``recording``
                       sets, the profiler range of each site).
  ``registry.py``      the declared components, span and event kinds,
                       with the markdown table ``docs/API.md`` is
                       drift-tested against.
  ``report.py``        derived views: ``trace_summary`` and the latency
                       cells derived from query spans.
  ``trace_export.py``  Chrome trace-event (Perfetto-loadable) JSON:
                       per-component tracks for spans and events, plus
                       the schema validator.

Layering: this package imports nothing from ``repro_torch.core`` (numpy
and the standard library only), so ``core/`` calls into it without a
cycle; ``core`` installs torch's profiler hook (``install_profiler``).
It began as a copy of the JAX package's ``repro.obs``: the span model,
the reports and the Chrome export of the same spans give the same
values.  The port declares the layer spans besides the reference's
kinds, measures rounds where the reference splays a call's wall time
over them, and has no instrument registry; the telemetry differs where
the port's eager loop sees more (see ``telemetry.py``).
"""

from repro_torch.obs.registry import COMPONENTS, SPAN_KINDS, \
    spans_markdown_table
from repro_torch.obs.report import derive_latency_cells, trace_summary
from repro_torch.obs.spans import NULL_RECORDER, Event, Span, \
    SpanRecorder, recording, span, spanned
from repro_torch.obs.telemetry import PhaseSeries, RunTelemetry, WireRecord
from repro_torch.obs.trace_export import chrome_trace, \
    validate_chrome_trace, write_trace

__all__ = [
    "COMPONENTS", "Event", "NULL_RECORDER", "PhaseSeries", "RunTelemetry",
    "SPAN_KINDS", "Span", "SpanRecorder", "WireRecord", "chrome_trace",
    "derive_latency_cells", "recording", "span", "spanned",
    "spans_markdown_table", "trace_summary", "validate_chrome_trace",
    "write_trace",
]
