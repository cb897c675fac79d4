"""Double-buffered launch pipeline.

The executor holds up to ``depth`` launches in flight and blocks only
on the OLDEST launch when a new one needs its slot or at drain.  On a
card ``push`` records a CUDA event on the current stream behind the
launch's work, and completion waits on that event; on the CPU the
outputs are already computed and completion waits on nothing.

What this overlaps here: the engine's programs halt on host values
every round (``core/superstep.py``), so a dispatch returns only after
its last round has been issued and read.  What is left in flight is
the tail of the launch (the output kernels after the last halt test),
so ``depth=2`` overlaps that tail with the next batch's formation, not
a whole launch with the next one.  The server's ``dispatch`` and
``device`` spans show the split.

The executor knows nothing about queries or programs — it pipelines
``(payload, outputs)`` pairs and hands completed ones back in dispatch
order.

Failure safety: an asynchronous device error surfaces at the blocking
call, so waiting on one launch may raise long after the push that
enqueued it.  The executor converts that into data — the launch is
popped BEFORE blocking and the exception lands in ``Launch.error`` — so
a poisoned launch can never orphan its in-flight peers or wedge the
pipeline: ``push``/``complete_one``/``drain`` never raise, and a drain
after a failed launch still returns every remaining result.  Routing
(retry, quarantine) is the server's job.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import torch


@dataclass
class Launch:
    """One in-flight dispatch: opaque payload + its outputs.  ``event``
    is the CUDA event recorded behind the launch's work (None when no
    output lies on a card).  ``error`` is the exception waiting on it
    raised, if any — a failed launch completes like any other and the
    consumer decides what to do with it."""

    payload: object
    out: object
    t_dispatch: float
    event: torch.cuda.Event | None = None
    t_done: float = 0.0
    error: Exception | None = None
    seq: int = -1       # executor-global dispatch order (trace correlation)


def _cuda_device(out) -> torch.device | None:
    """The card the launch's top-level tensor outputs lie on, if any."""
    for o in (out if isinstance(out, (tuple, list)) else (out,)):
        if isinstance(o, torch.Tensor) and o.is_cuda:
            return o.device
    return None


def _block(launch: Launch) -> None:
    """Wait until the launch's work is done (nothing to wait for when it
    recorded no event)."""
    if launch.event is not None:
        launch.event.synchronize()


class DoubleBufferedExecutor:
    def __init__(self, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.depth = depth
        self._inflight: deque[Launch] = deque()
        self._seq = 0

    def __len__(self) -> int:
        return len(self._inflight)

    def push(self, payload, out) -> list[Launch]:
        """Enqueue a launch; returns the launches this push had to
        retire to stay within ``depth`` (0 or 1 of them)."""
        done = []
        while len(self._inflight) >= self.depth:
            done.append(self._complete_oldest())
        event = None
        device = _cuda_device(out)
        if device is not None:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        self._inflight.append(
            Launch(payload, out, time.perf_counter(), event, seq=self._seq))
        self._seq += 1
        return done

    def complete_one(self) -> Launch | None:
        """Block on and retire the oldest in-flight launch, if any."""
        if not self._inflight:
            return None
        return self._complete_oldest()

    def drain(self) -> list[Launch]:
        """Retire everything in flight, oldest first."""
        done = []
        while self._inflight:
            done.append(self._complete_oldest())
        return done

    def _complete_oldest(self) -> Launch:
        # pop FIRST: if the wait raises, the launch is already out of
        # the pipeline and the ones behind it stay retrievable
        launch = self._inflight.popleft()
        try:
            _block(launch)
        except Exception as e:
            launch.error = e
        launch.t_done = time.perf_counter()
        return launch
