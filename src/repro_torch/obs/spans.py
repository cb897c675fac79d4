"""Span/event model of traced runs: a bounded ring buffer of
monotonic-timestamped spans (the serving path's spans, the checkpoint
runner's chunks and checkpoint / detection / rollback events, and the
analytics path's layer spans) and the layer sites that record them.

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

Layer sites.  The analytics path (``core/``) marks its layer boundaries
with ``with span(kind, component):``, or ``@spanned(kind, component)``
around a whole function: the engine's call, the superstep loop's init,
rounds and outputs, bfs/fast's push and pull levels, the local ops and
the exchanges.  A site reads the recorder made current by
:func:`recording` (nothing is plumbed through the programs) and torch's
profiler state, through the hook ``core`` installs with
:func:`install_profiler` (this package imports no torch):

  * a current, enabled recorder gets a ``Span`` on ``perf_counter``;
  * while torch's profiler records, the site also opens the profiler
    range ``repro_torch.<component>.<kind>``, so the span lands in the
    profiler's trace on the device trace's clock and each kernel can
    be put down to the span that launched it;
  * with neither, a site reads the two flags and returns: it enters no
    profiler range, allocates nothing and runs no tensor op.
"""

from __future__ import annotations

import functools
import threading
import time
from collections import deque
from contextlib import contextmanager
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


# -- layer sites ----------------------------------------------------------

class _NoProfiler:
    """The profiler state before ``core`` installs torch's."""

    _is_profiler_enabled = False


_recorder = NULL_RECORDER      # the recorder ``recording`` made current
_profiler_state = _NoProfiler  # ``._is_profiler_enabled``: torch records
_open_range = None             # name -> a profiler range context manager


def install_profiler(state, open_range) -> None:
    """Hand the layer sites torch's profiler: ``state`` is the object whose
    ``_is_profiler_enabled`` is True while torch's profiler records
    (``torch.autograd.profiler``), ``open_range(name)`` the context
    manager that opens a named range under it (``record_function``)."""
    global _profiler_state, _open_range
    _profiler_state, _open_range = state, open_range


@contextmanager
def recording(rec: SpanRecorder):
    """Make ``rec`` the recorder the layer sites record into for the
    block, restoring the previous one after it."""
    global _recorder
    prev, _recorder = _recorder, rec
    try:
        yield rec
    finally:
        _recorder = prev


class _LayerSpan:
    """A layer site while a recorder or the profiler is on: the profiler
    range, then the recorder's span, whichever is on."""

    __slots__ = ("_parts",)

    def __init__(self, kind: str, component: str):
        parts = []
        if _profiler_state._is_profiler_enabled:
            parts.append(_open_range(f"repro_torch.{component}.{kind}"))
        if _recorder.enabled:
            parts.append(_recorder.span(kind, component))
        self._parts = parts

    def __enter__(self):
        for part in self._parts:
            part.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        for part in reversed(self._parts):
            part.__exit__(exc_type, exc, tb)
        return False


def span(kind: str, component: str):
    """``with span("round", "engine"): ...``: a layer site (see the
    module's notes); the shared no-op when nothing records."""
    if not (_recorder.enabled or _profiler_state._is_profiler_enabled):
        return _NULL_SPAN
    return _LayerSpan(kind, component)


def spanned(kind: str, component: str):
    """A layer site around a whole function: ``span(kind, component)``
    over each call, the function called directly when nothing records."""

    def wrap(fn):
        @functools.wraps(fn)
        def site(*args, **kwargs):
            if not (_recorder.enabled
                    or _profiler_state._is_profiler_enabled):
                return fn(*args, **kwargs)
            with _LayerSpan(kind, component):
                return fn(*args, **kwargs)

        return site

    return wrap
