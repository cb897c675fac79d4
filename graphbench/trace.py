"""Reading a ``torch.profiler`` Chrome trace of the traced window.

The harness wraps each call in ``record_function(CALL)`` (the call and
the synchronise that ends it) and the program's own call in
``record_function(PROGRAM)``.  From the exported trace this takes:

* device busy time: the union of device operations (kernels, copies,
  sets), over the window and over each call;
* blocking host-device synchronisations inside the program's calls,
  counted from the CUDA runtime events;
* the device operations that took most time, and the idle gaps of the
  device by what the host was doing then (the innermost host event
  open at the gap's middle).
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict
from dataclasses import dataclass, field

CALL = "graphbench.call"
PROGRAM = "graphbench.program"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function"}
SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy", "cudaMemcpy2D"}
NAME_CHARS = 96
TOP = 10


@dataclass
class Summary:
    window_s: float
    busy_s: float
    calls: int
    call_busy_s: list[float]
    syncs: int
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)

    @property
    def syncs_per_call(self) -> float:
        return self.syncs / self.calls


def _merge(intervals):
    out = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return out


def _covered(merged, starts, lo, hi) -> float:
    """Length of ``[lo, hi]`` that the merged intervals cover."""
    total = 0.0
    i = max(0, bisect.bisect_right(starts, lo) - 1)
    for a, b in merged[i:]:
        if a >= hi:
            break
        total += max(0.0, min(b, hi) - max(a, lo))
    return total


def _innermost(host, starts, t) -> str:
    """The host event open at ``t`` that started last."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        ts, end, name = host[i]
        if end >= t:
            return name
        i -= 1
    return "(no host event)"


def summarize(events: list[dict]) -> Summary:
    """A :class:`Summary` of the ``traceEvents`` of one traced window."""
    def span(e):
        return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))

    calls = sorted(span(e) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == CALL)
    progs = sorted(span(e) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == PROGRAM)
    if not calls:
        raise ValueError(f"no {CALL!r} ranges in the trace")
    w0, w1 = calls[0][0], calls[-1][1]
    dev = [(*span(e), e.get("name", "?")) for e in events
           if e.get("cat") in DEVICE_CATS]
    merged = _merge([(max(a, w0), min(b, w1)) for a, b, _ in dev
                     if b > w0 and a < w1])
    busy = sum(b - a for a, b in merged)
    merged_starts = [m[0] for m in merged]
    call_busy = [_covered(merged, merged_starts, a, b) * 1e-6
                 for a, b in calls]

    prog_starts = [p[0] for p in progs]
    syncs = 0
    for e in events:
        if e.get("cat") == "cuda_runtime" and e.get("name") in SYNCS:
            t = float(e["ts"])
            i = bisect.bisect_right(prog_starts, t) - 1
            if i >= 0 and t <= progs[i][1]:
                syncs += 1

    by_op = defaultdict(float)
    for a, b, name in dev:
        lo, hi = max(a, w0), min(b, w1)
        if hi > lo:
            by_op[name[:NAME_CHARS]] += (hi - lo) * 1e-6

    # outer before inner where two start together
    host = sorted(((*span(e), e.get("name", "?")) for e in events
                   if e.get("cat") in HOST_CATS),
                  key=lambda h: (h[0], -h[1]))
    starts = [h[0] for h in host]
    by_host = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for lo, hi in zip(edges[::2], edges[1::2]):
        if hi > lo:
            name = _innermost(host, starts, (lo + hi) / 2)
            by_host[name[:NAME_CHARS]] += (hi - lo) * 1e-6

    def top(d):
        return [[k, v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

    return Summary(window_s=(w1 - w0) * 1e-6, busy_s=busy * 1e-6,
                   calls=len(calls), call_busy_s=call_busy, syncs=syncs,
                   device_ops=top(by_op), idle_gaps=top(by_host))


def summarize_file(path) -> Summary:
    with open(path) as f:
        return summarize(json.load(f)["traceEvents"])
