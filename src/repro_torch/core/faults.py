"""Deterministic fault injection at the exchanges.

Every exchange of ``partitioned.StackedComm`` (and ``DistComm``) routes
its OUTGOING payload through :func:`tap`; when a :class:`FaultSchedule` is armed
(:func:`active`) the tap perturbs one part's slice of that payload, with
seeded choices, at the rounds the schedule addresses, so a chaos run is
as reproducible as a clean one (same schedule, same graph, same faults,
bit for bit).  With no schedule armed the tap returns the payload it was
given and does nothing else.

Fault model (one :class:`FaultEvent` per fault), part ``p``'s slice
``payload[p]`` being what part p ships:

  * ``drop``    -- the slice becomes the combine identity (0 for sum / or
                   / bcast / perm, the dtype's largest value or +inf for
                   min): the message never arrives.
  * ``stall``   -- ``drop`` sustained for ``rounds`` consecutive rounds:
                   a part that stops answering.
  * ``dup``     -- duplicate delivery: a sum slice arrives twice
                   (doubled); min / or / bcast / perm are idempotent, so
                   the duplicate changes nothing.
  * ``corrupt`` -- one seeded element is overwritten with an invalid
                   value: NaN for floats, ``-2**30`` for signed integers
                   (all engine state is non-negative), all ones for a
                   bitmap word.
  * ``stale``   -- a seeded half of the slice reverts to the combine
                   identity: partial delivery.  Monotone programs absorb
                   it exactly, and it is not transport-detectable.

Detection has two channels, both read by the guarded loops
(``superstep.run_program(..., guard=True)``):

  * transport stamps -- :func:`stamp_violation` says whether a stamped
    kind (drop / stall / dup / corrupt) covers the current round: the
    stand-in for sequence numbers and payload checksums.  It is a pure
    function of the schedule and the round (so every rank of a
    ``DistComm`` group gives the same verdict), never of whether a tap
    fired: a stamped event taints its round even when that round's
    branch never shipped the addressed payload (bfs/fast's push / pull
    switch); ``stale`` stays silent;
  * value guards -- each program's invariant check, which catches
    corruption that lands in the state whatever its cause.

Round addressing: ``FaultEvent.round`` matches the loop's round counter
when the exchange runs, published with :func:`set_round` (host ints).
The exchange an async ``init`` starts is round 0; outputs run at round
-1, which no event addresses.

Bitmaps are int32 words here where the JAX package ships uint32 words:
a corrupt bitmap word is written as ``-1``, the same 32 bits as its
``0xFFFFFFFF``.  The callers say which payloads are bitmap words.
"""

from __future__ import annotations

import re
from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

KINDS = ("drop", "dup", "corrupt", "stall", "stale")
OPS = ("sum", "min", "or", "bcast", "perm")

# kinds the transport stamp marks; ``stale`` alone is transport-silent
_STAMP_KINDS = ("drop", "stall", "dup", "corrupt")


@dataclass(frozen=True)
class FaultEvent:
    """One schedule-addressable fault: ``kind`` fired by part ``part`` at
    loop round ``round``, optionally restricted to one exchange ``op``
    (None = every op that round), ``stall`` sustained for ``rounds``."""

    round: int
    part: int
    kind: str
    op: str | None = None
    rounds: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"fault kind {self.kind!r} not in {KINDS}")
        if self.op is not None and self.op not in OPS:
            raise ValueError(f"fault op {self.op!r} not in {OPS}")
        if self.round < 0 or self.part < 0 or self.rounds < 1:
            raise ValueError(f"bad fault addressing: {self}")

    def spec(self) -> str:
        s = f"{self.kind}@r{self.round}p{self.part}"
        if self.op is not None:
            s += f":{self.op}"
        if self.rounds != 1:
            s += f"x{self.rounds}"
        return s


_EVENT_RE = re.compile(
    r"^(?P<kind>[a-z]+)@r(?P<round>\d+)p(?P<part>\d+)"
    r"(?::(?P<op>[a-z]+))?(?:x(?P<rounds>\d+))?$")


@dataclass(frozen=True)
class FaultSchedule:
    """A hashable, seeded set of fault events (it fits the engine's cache
    key).  ``seed`` feeds every seeded choice (the corrupt element, the
    stale mask), so one (schedule, graph) pair is one chaos run."""

    events: tuple[FaultEvent, ...]
    seed: int = 0

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    def spec(self) -> str:
        return " ".join(ev.spec() for ev in self.events) + f" seed={self.seed}"

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultSchedule":
        """Parse the compact form: whitespace-separated
        ``kind@r<round>p<part>[:<op>][x<rounds>]`` events plus an
        optional ``seed=<n>`` token, e.g.
        ``"drop@r1p0 corrupt@r2p1:min stall@r3p0x2 seed=7"``."""
        events = []
        for tok in text.split():
            if tok.startswith("seed="):
                seed = int(tok[len("seed="):])
                continue
            m = _EVENT_RE.match(tok)
            if not m:
                raise ValueError(
                    f"bad fault event {tok!r}; expected "
                    "kind@r<round>p<part>[:<op>][x<rounds>]")
            events.append(FaultEvent(
                round=int(m.group("round")), part=int(m.group("part")),
                kind=m.group("kind"), op=m.group("op"),
                rounds=int(m.group("rounds") or 1)))
        return cls(events=tuple(events), seed=seed)


def as_schedule(faults) -> FaultSchedule | None:
    """Coerce a schedule argument: None, a FaultSchedule, or the compact
    string form accepted by :meth:`FaultSchedule.parse`."""
    if faults is None or isinstance(faults, FaultSchedule):
        return faults
    if isinstance(faults, str):
        return FaultSchedule.parse(faults)
    raise TypeError(f"faults must be None, FaultSchedule, or str: "
                    f"{type(faults).__name__}")


# --------------------------------------------------------------------------
# The armed schedule and the round it is read at.  ``GraphEngine``'s
# programs and ``CheckpointRunner`` enter ``active`` around a run.
# --------------------------------------------------------------------------


class _Ctx:
    __slots__ = ("schedule", "detect", "round")

    def __init__(self, schedule: FaultSchedule, detect: bool):
        self.schedule = schedule
        self.detect = detect
        self.round = 0


_ctx: _Ctx | None = None


@contextmanager
def active(schedule: FaultSchedule | None, detect: bool = False):
    """Arm ``schedule`` for the exchanges run inside the block (None
    disarms); ``detect`` also turns the transport stamps on."""
    global _ctx
    prev = _ctx
    _ctx = _Ctx(schedule, detect) if schedule is not None else None
    try:
        yield
    finally:
        _ctx = prev


def is_active() -> bool:
    return _ctx is not None


def set_round(r: int) -> None:
    """Publish the loop's round counter for event matching."""
    if _ctx is not None:
        _ctx.round = r


def _span(ev: FaultEvent) -> int:
    return ev.rounds if ev.kind == "stall" else 1


def stamp_violation() -> bool:
    """Transport-stamp verdict for the current round: True when a
    stamped-kind event covers it.  False when no schedule is armed or
    detection is off.  It reads the schedule and the round only, so it
    is the same for every part."""
    if _ctx is None or not _ctx.detect:
        return False
    r = _ctx.round
    return any(ev.kind in _STAMP_KINDS and ev.round <= r < ev.round + _span(ev)
               for ev in _ctx.schedule.events)


# --------------------------------------------------------------------------
# The tap.
# --------------------------------------------------------------------------


def _identity_value(op: str, dtype: torch.dtype):
    if op == "min":
        return float("inf") if dtype.is_floating_point \
            else torch.iinfo(dtype).max
    return 0


def _corrupt_value(dtype: torch.dtype, words: bool):
    if dtype.is_floating_point:
        return float("nan")
    if words:
        return -1               # all 32 bits of an int32 bitmap word
    return -(2 ** 30)


def _rng(ev: FaultEvent, seed: int) -> np.random.Generator:
    return np.random.default_rng(
        np.array([seed, ev.round, ev.part, KINDS.index(ev.kind)],
                 np.uint64))


def tap(op: str, payload: torch.Tensor, parts: int,
        words: bool = False, first: int = 0) -> torch.Tensor:
    """Perturb an OUTGOING ``(L, ...)`` exchange payload per the armed
    schedule: row i is what global part ``first + i`` ships (``first``
    0 and L = P when every part is stacked here, the rank's part alone
    under ``DistComm``), and event ``ev`` perturbs part ``ev.part``'s
    slice at the rounds it addresses, on the process that holds that
    part (an event whose part is past ``parts`` never fires).  ``words``
    marks a payload of bitmap words.

    Returns ``payload`` itself when nothing fires, else a perturbed copy:
    the caller's tensor is never written (a broadcast ships the sender's
    own state).  Detection is not the tap's job: see
    :func:`stamp_violation`.
    """
    if _ctx is None:
        return payload
    sched, r = _ctx.schedule, _ctx.round
    out = None
    for ev in sched.events:
        if ev.op is not None and ev.op != op:
            continue
        if not ev.round <= r < ev.round + _span(ev) or ev.part >= parts \
                or not first <= ev.part < first + payload.shape[0]:
            continue
        if ev.kind == "dup" and op != "sum":
            continue                        # the others are idempotent
        if out is None:
            out = payload.clone(memory_format=torch.contiguous_format)
        piece = out[ev.part - first]
        if ev.kind in ("drop", "stall"):
            piece.fill_(_identity_value(op, out.dtype))
        elif ev.kind == "dup":
            piece.mul_(2)
        elif ev.kind == "corrupt":
            idx = int(_rng(ev, sched.seed).integers(piece.numel()))
            piece.view(-1)[idx] = _corrupt_value(out.dtype, words)
        else:                               # stale: seeded partial loss
            keep = _rng(ev, sched.seed).random(tuple(piece.shape)) < 0.5
            lost = torch.from_numpy(~keep).to(piece.device)
            piece.masked_fill_(lost, _identity_value(op, out.dtype))
    return payload if out is None else out
