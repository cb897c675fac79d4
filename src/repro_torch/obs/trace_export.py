"""Chrome trace-event (Perfetto-loadable) JSON export + schema check.

``chrome_trace`` turns recorder spans/events into the Trace Event
Format dict ``chrome://tracing`` and https://ui.perfetto.dev load
directly:

  * one process (pid 1) with one track (tid) per declared component
    (``registry.COMPONENTS`` order), so admission/validate/demux nest
    on the "server" track while batch formation and device launches
    read on their own lanes, and the analytics path's measured layer
    spans nest on theirs (a call's init, rounds and outputs on
    "engine", its exchanges on "comm");
  * span kinds declared ``complete`` export as "X" events; kinds
    declared ``async`` (query / device / coalesce_wait — they overlap
    on their track) export as "b"/"e" pairs keyed by the recorder
    ``seq``; instant events export as "i".

Timestamps are microseconds relative to the earliest stamp in the
trace (Chrome wants µs; perf_counter's epoch is arbitrary anyway).

``validate_chrome_trace`` is the schema gate every export passes: required fields per event shape, matched and
ordered async begin/end pairs, non-decreasing per-track timestamps,
and proper "X" nesting (intervals on one track may contain each other
but never partially overlap).  It raises ``ValueError`` with the first
offending event; on success it returns per-``ph`` counts.
"""

from __future__ import annotations

import json
import pathlib

from repro_torch.obs.registry import COMPONENTS, SPAN_KINDS

_PID = 1
_COMPONENT_TID = {name: i for i, name in enumerate(COMPONENTS)}


def _meta(pid: int, name: str, tid: int = 0, thread: str | None = None):
    ev = {"ph": "M", "pid": pid, "tid": tid, "ts": 0,
          "name": "process_name" if thread is None else "thread_name",
          "args": {"name": name if thread is None else thread}}
    return ev


def chrome_trace(spans=(), events=()) -> dict:
    """Build the trace dict of ``SpanRecorder.spans()`` / ``.events()``."""
    spans = list(spans)
    events = list(events)
    stamps = [s.t0 for s in spans] + [e.t for e in events]
    base = min(stamps) if stamps else 0.0

    def us(t: float) -> float:
        return round((t - base) * 1e6, 3)

    out = []
    if spans or events:
        out.append(_meta(_PID, "repro_torch"))
        for comp, tid in _COMPONENT_TID.items():
            out.append(_meta(_PID, "", tid, thread=comp))
    for span in spans:
        tid = _COMPONENT_TID.get(span.component, len(_COMPONENT_TID))
        decl = SPAN_KINDS.get(span.kind)
        if decl is not None and decl[1] == "async":
            common = {"name": span.kind, "cat": span.component,
                      "pid": _PID, "tid": tid, "id": span.seq}
            out.append({"ph": "b", "ts": us(span.t0),
                        "args": dict(span.args), **common})
            out.append({"ph": "e", "ts": us(span.t1), **common})
        else:
            out.append({"ph": "X", "name": span.kind,
                        "cat": span.component, "pid": _PID,
                        "tid": tid, "ts": us(span.t0),
                        "dur": round(span.dur * 1e6, 3),
                        "args": dict(span.args)})
    for ev in events:
        tid = _COMPONENT_TID.get(ev.component, len(_COMPONENT_TID))
        out.append({"ph": "i", "s": "t", "name": ev.kind,
                    "cat": ev.component, "pid": _PID, "tid": tid,
                    "ts": us(ev.t), "args": dict(ev.args)})
    out.sort(key=lambda e: (e["ph"] == "M" and -1, e["ts"]))
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def validate_chrome_trace(trace: dict) -> dict:
    """Schema-check ``trace``; raises ValueError, returns ph counts."""
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with 'traceEvents'")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    counts: dict[str, int] = {}
    tracks: dict[tuple, list] = {}
    open_async: dict[tuple, float] = {}
    for i, ev in enumerate(evs):
        for field in ("ph", "ts", "pid", "tid"):
            if field not in ev:
                raise ValueError(f"event {i} missing {field!r}: {ev}")
        ph = ev["ph"]
        counts[ph] = counts.get(ph, 0) + 1
        if not isinstance(ev["ts"], (int, float)) or ev["ts"] < 0:
            raise ValueError(f"event {i} has bad ts: {ev}")
        if ph in ("X", "b", "e", "i", "M") and "name" not in ev:
            raise ValueError(f"event {i} missing name: {ev}")
        if ph == "M":
            continue
        tracks.setdefault((ev["pid"], ev["tid"], ph), []).append(ev)
        if ph == "X":
            if not isinstance(ev.get("dur"), (int, float)) or \
                    ev["dur"] < 0:
                raise ValueError(f"X event {i} has bad dur: {ev}")
        elif ph in ("b", "e"):
            if "cat" not in ev or "id" not in ev:
                raise ValueError(f"async event {i} missing cat/id: {ev}")
            key = (ev["pid"], ev["cat"], ev["id"])
            if ph == "b":
                if key in open_async:
                    raise ValueError(f"async id reused before end: {ev}")
                open_async[key] = ev["ts"]
            else:
                if key not in open_async:
                    raise ValueError(f"'e' without matching 'b': {ev}")
                if ev["ts"] < open_async.pop(key):
                    raise ValueError(f"async end before begin: {ev}")
    if open_async:
        raise ValueError(f"{len(open_async)} async span(s) never ended: "
                         f"{sorted(open_async)[:3]}")
    for (pid, tid, ph), evs_t in tracks.items():
        last = -1.0
        for ev in evs_t:
            if ev["ts"] < last:
                raise ValueError(
                    f"track (pid={pid}, tid={tid}, ph={ph}) timestamps "
                    f"decrease at {ev}")
            last = ev["ts"]
        if ph != "X":
            continue
        # "X" nesting: sort by (start, -dur) then stack-check — each
        # interval must close inside (or exactly at the edge of) its
        # enclosing interval; partial overlap is malformed.
        stack: list[float] = []
        eps = 1e-2  # µs; stamps are rounded to 3 decimals
        for ev in sorted(evs_t, key=lambda e: (e["ts"], -e["dur"])):
            end = ev["ts"] + ev["dur"]
            while stack and ev["ts"] >= stack[-1] - eps:
                stack.pop()
            if stack and end > stack[-1] + eps:
                raise ValueError(
                    f"track (pid={pid}, tid={tid}) spans partially "
                    f"overlap at {ev}")
            stack.append(end)
    return counts


def write_trace(path, trace: dict) -> dict:
    """Validate then write ``trace`` as JSON; returns the validator's
    per-``ph`` counts (what the launchers report)."""
    counts = validate_chrome_trace(trace)
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(trace, indent=None,
                               separators=(",", ":")) + "\n")
    return counts
