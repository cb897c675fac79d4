"""The port's layer spans in the traced window's Chrome trace.

``repro_torch`` marks its layer boundaries with profiler ranges named
``repro_torch.<component>.<kind>`` (its ``obs/spans.py``), host events
of the trace: each call
(``engine.call``), the loop's init, rounds and outputs, bfs/fast's push
and pull levels, the local ops and the exchanges.  From the trace the
harness keeps in ``out/`` this takes, for each such name over the
window:

* its count;
* its host self time: the span's time less that of the port spans
  directly inside it;
* its device self time: the device-busy seconds of the device operations
  it launched itself.  A device operation belongs to the innermost port
  span open on its launching thread at its launch (the ``cuda_runtime``
  or ``cuda_driver`` event of the same ``correlation`` id), and a span's
  operations are clipped to the window and merged as ``trace.py``'s
  ``busy_s`` is.

Besides, each call's device-busy seconds launched outside any port span.

A trace with no port span (a program without them) reads as None, and so
does every metric read from it.  The readers find the run's trace by its
window: the one whose calls and window are those of ``record.trace``.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

from graphbench import harness, trace

PREFIX = "repro_torch."
# a port span is a user annotation (record_function) or, from torch's
# C++ range, a host op
SPAN_CATS = {"user_annotation", "cpu_op"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver"}


@dataclass
class Layers:
    window_s: float
    calls: int
    count: dict = field(default_factory=dict)        # name -> spans
    host_self_s: dict = field(default_factory=dict)  # name -> seconds
    device_s: dict = field(default_factory=dict)     # name -> seconds
    outside_s: list = field(default_factory=list)    # a call's seconds


def _span(e):
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _corr(e):
    return (e.get("args") or {}).get("correlation")


def _busy(intervals, w0, w1) -> float:
    merged = trace._merge([(max(a, w0), min(b, w1)) for a, b in intervals
                           if b > w0 and a < w1])
    return sum(b - a for a, b in merged) * 1e-6


def summarize(events: list[dict]) -> Layers | None:
    """The :class:`Layers` of one traced window, or None without port
    spans."""
    calls = sorted(_span(e) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == trace.CALL)
    if not calls:
        raise ValueError(f"no {trace.CALL!r} ranges in the trace")
    w0, w1 = calls[0][0], calls[-1][1]

    # port spans and launches by host thread, in time order (outer first)
    spans, launches = defaultdict(list), defaultdict(list)
    for e in events:
        cat = e.get("cat")
        if cat in SPAN_CATS and e.get("name", "").startswith(PREFIX):
            a, b = _span(e)
            if w0 <= a <= w1:
                spans[(e.get("pid"), e.get("tid"))].append((a, b, e["name"]))
        elif cat in LAUNCH_CATS and _corr(e) is not None:
            launches[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), _corr(e)))
    if not spans:
        return None

    count, host_self = defaultdict(int), defaultdict(float)
    owner = {}                      # correlation -> innermost span name
    for thread, ss in spans.items():
        ss.sort(key=lambda s: (s[0], -s[1]))
        stack, inner = [], defaultdict(float)    # index -> child time
        for i, (a, b, name) in enumerate(ss):
            while stack and ss[stack[-1]][1] <= a:
                stack.pop()
            if stack:
                inner[stack[-1]] += b - a
            stack.append(i)
        for i, (a, b, name) in enumerate(ss):
            count[name] += 1
            host_self[name] += (b - a - inner[i]) * 1e-6
        starts = [s[0] for s in ss]
        for t, corr in launches.get(thread, ()):
            # spans nest: the latest-starting one still open at t is the
            # innermost
            i = bisect.bisect_right(starts, t) - 1
            while i >= 0 and ss[i][1] < t:
                i -= 1
            if i >= 0:
                owner[corr] = ss[i][2]

    call_starts = [c[0] for c in calls]
    launch_call = {}
    for thread_launches in launches.values():
        for t, corr in thread_launches:
            j = bisect.bisect_right(call_starts, t) - 1
            if j >= 0 and t <= calls[j][1]:
                launch_call[corr] = j
    by_name, outside = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("cat") not in trace.DEVICE_CATS:
            continue
        corr = _corr(e)
        name = owner.get(corr)
        if name is not None:
            by_name[name].append(_span(e))
        elif corr in launch_call:
            outside[launch_call[corr]].append(_span(e))
    return Layers(
        window_s=(w1 - w0) * 1e-6, calls=len(calls), count=dict(count),
        host_self_s=dict(host_self),
        device_s={n: _busy(iv, w0, w1) for n, iv in by_name.items()},
        outside_s=[_busy(outside.get(j, ()), w0, w1)
                   for j in range(len(calls))])


_CACHE: dict = {}


def of_record(record) -> Layers | None:
    """The :class:`Layers` of the run ``record`` describes: the trace in
    ``out/`` whose calls and window are ``record.trace``'s, summarised
    once.  None for an untraced record or a trace without port spans."""
    if not record.traced or record.trace is None:
        return None
    paths = sorted(harness.OUT.glob("trace-*.json"),
                   key=lambda p: p.stat().st_mtime_ns, reverse=True)
    for path in paths:
        st = path.stat()
        key = (str(path), st.st_mtime_ns, st.st_size)
        if key not in _CACHE:
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            calls = [e for e in events if e.get("cat") == "user_annotation"
                     and e.get("name") == trace.CALL]
            _CACHE[key] = (len(calls), summarize(events) if calls else None)
        calls, layers = _CACHE[key]
        if calls == record.trace.calls and layers is not None \
                and layers.window_s == record.trace.window_s:
            return layers
    return None


def _layers(record, program: str) -> Layers | None:
    if record.program != program or not record.durations_s:
        return None
    return of_record(record)


def _names(layers: Layers, names) -> list[str]:
    """``names`` as full span names; one ending in ``.*`` is every span
    of that component."""
    out = []
    for n in names:
        if n.endswith(".*"):
            out += [k for k in layers.count
                    if k.startswith(PREFIX + n[:-1])]
        else:
            out.append(PREFIX + n)
    return out


def device_ms_per_call(record, program: str, *names) -> float | None:
    """Device self time of the spans ``names`` (``component.kind`` or
    ``component.*``), in ms a traced call."""
    layers = _layers(record, program)
    if layers is None:
        return None
    return 1e3 * sum(layers.device_s.get(n, 0.0)
                     for n in _names(layers, names)) / layers.calls


def count_per_call(record, program: str, name: str) -> float | None:
    """Spans named ``name`` (``component.kind``) a traced call."""
    layers = _layers(record, program)
    if layers is None:
        return None
    return layers.count.get(PREFIX + name, 0) / layers.calls


def host_self_ms_per_call(record, program: str, name: str) -> float | None:
    """Host self time of the spans named ``name``, in ms a traced call."""
    layers = _layers(record, program)
    if layers is None:
        return None
    return 1e3 * layers.host_self_s.get(PREFIX + name, 0.0) / layers.calls
