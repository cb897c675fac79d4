"""Span/event model of traced runs: a bounded ring buffer of
monotonic-timestamped spans (the checkpoint runner's chunks and
checkpoint / detection / rollback events; the serving path's spans
when it is ported).

A ``Span`` is a named interval on a component track (``t0``..``t1`` in
``time.perf_counter()`` seconds); an ``Event`` is an instant.  The
``SpanRecorder`` is the only mutable object — everything downstream
(`report.trace_summary`, `trace_export.chrome_trace`) consumes the
immutable ``spans()`` / ``events()`` snapshots.

Design points (cheap when off, as ``core/faults.py`` is):

  * ``NULL_RECORDER`` is a disabled recorder; every instrumentation
    site guards on ``recorder.enabled`` so an untraced run
    pays one attribute read per site and allocates nothing.
  * The buffers are RINGS (``maxlen`` spans / events each).  A long
    run cannot grow host memory without bound; the exporter
    simply sees the most recent window.  ``dropped_spans`` counts what
    fell off so roll-ups can say "truncated" instead of lying.
  * Timestamps come from one clock (``perf_counter``) for every
    component, so cross-track ordering in the exported trace is real.
  * Spans record ``seq`` — a recorder-global monotone id — so nesting
    on one track can be reconstructed even when two spans share a
    ``t0`` (ties broken by start order).

Span kinds, components, and which kinds export as Chrome *async*
events (they overlap on one track: ``query``, ``device``,
``coalesce_wait``) are declared in ``obs/registry.py``.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    """A closed interval on a component track."""

    kind: str           # registry.SPAN_KINDS key, e.g. "admission"
    component: str      # registry.COMPONENTS key -> its own track (tid)
    t0: float           # perf_counter seconds
    t1: float
    seq: int            # recorder-global start order (nesting tiebreak)
    args: dict = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


@dataclass(frozen=True)
class Event:
    """An instant on a component track."""

    kind: str
    component: str
    t: float
    seq: int
    args: dict = field(default_factory=dict)


class _OpenSpan:
    """Context manager returned by ``SpanRecorder.span`` — closes the
    span on exit and lets the body attach args lazily."""

    __slots__ = ("_rec", "kind", "component", "t0", "seq", "args")

    def __init__(self, rec, kind, component, args):
        self._rec = rec
        self.kind = kind
        self.component = component
        self.args = dict(args) if args else {}
        self.t0 = time.perf_counter()
        self.seq = rec._next_seq()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        self._rec._push_span(Span(self.kind, self.component, self.t0,
                                  time.perf_counter(), self.seq, self.args))
        return False


class _NullSpan:
    """No-op stand-in so ``with rec.span(...)`` works when disabled."""

    __slots__ = ("args",)

    def __init__(self):
        self.args = {}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class SpanRecorder:
    """Bounded, thread-safe recorder for spans and instant events.

    The serve pipeline closes spans from both the submitting thread and
    the executor's demux thread, so pushes take a lock; reads snapshot
    under the same lock.  ``maxlen`` bounds EACH ring (spans, events).
    """

    def __init__(self, maxlen: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self.maxlen = maxlen
        self._spans: deque[Span] = deque(maxlen=maxlen)
        self._events: deque[Event] = deque(maxlen=maxlen)
        self._lock = threading.Lock()
        self._seq = 0
        self.dropped_spans = 0
        self.dropped_events = 0

    # -- recording ----------------------------------------------------
    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _push_span(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) == self.maxlen:
                self.dropped_spans += 1
            self._spans.append(span)

    def span(self, kind: str, component: str, **args):
        """``with rec.span("validate", "server"): ...`` — records a
        Span on exit; disabled recorders return a shared no-op."""
        if not self.enabled:
            return _NULL_SPAN
        return _OpenSpan(self, kind, component, args)

    def add_span(self, kind: str, component: str, t0: float, t1: float,
                 **args) -> None:
        """Record a span whose interval was measured elsewhere (e.g. a
        device launch stamped by the executor thread)."""
        if not self.enabled:
            return
        self._push_span(Span(kind, component, t0, t1, self._next_seq(),
                             args))

    def event(self, kind: str, component: str, **args) -> None:
        """Record an instant event at now."""
        if not self.enabled:
            return
        ev = Event(kind, component, time.perf_counter(), self._next_seq(),
                   args)
        with self._lock:
            if len(self._events) == self.maxlen:
                self.dropped_events += 1
            self._events.append(ev)

    # -- reading ------------------------------------------------------
    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def events(self) -> list[Event]:
        with self._lock:
            return list(self._events)

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._events.clear()
            self.dropped_spans = 0
            self.dropped_events = 0


NULL_RECORDER = SpanRecorder(maxlen=1, enabled=False)
