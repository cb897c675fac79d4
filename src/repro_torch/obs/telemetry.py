"""Engine telemetry: the per-round series and the measured wire record.

Two channels, both free when off:

**Series** — the superstep loops (``core/superstep.py``), run with
``telemetry=True``, keep a zero-initialised ``(max_rounds, 2 + K)``
float32 array on the host and write one row per round:

    [done, halt, *probes]

``done`` is 1.0 for rows a round wrote; the host trims on it
(``PhaseSeries.from_array``), which is what lets a phased program's
buffers concatenate.  ``halt`` is the halt predicate evaluated on the
round's resulting state (1.0 once converged); the probes are the
program's declared ``probe_names``/``probe`` extras (frontier size,
residual, changed count).

The JAX package computes the series on the device, inside its loop.
The port's loop already holds every halt scalar and probe value as a
host number (each is a ``psum_scalar`` result or a global a finish
delivered, which the loop reads anyway), so the row is written on the
host: no device buffer, no extra ``Tensor.item``, nothing to read back.

**Wire record** — every exchange of ``core/partitioned.py`` adds one
part's payload bytes and one tap to its comm's tallies under ``(phase,
op)``, cumulatively: ``StackedComm``'s, or under ``DistComm`` each
rank's, which counts its own part's bytes, so rank 0's record is the one
``StackedComm`` gives for the same program and parts.  A telemetry call
measures the difference of those tallies across the call
(:meth:`WireRecord.measure`):
the one-shot ``init`` / ``outputs`` cells whole, the loop's ``round``
cells as per-round figures (bytes and taps over rounds, integer
division), and the loop's measured total as ``loop_bytes``.

The JAX package counts one trace of its loop body instead, and a
``lax.cond`` traces both branches, so where an exchange sits under one
(bfs/fast's adaptive push/pull, pagerank/fast's compression switch,
pagerank/async's refresh at staleness > 1) its per-round figure is an
upper bound.  The port counts what was shipped: where every round ships
the same bytes the two agree; elsewhere the port's per-round figure is
the average and its ``wire_bytes_total`` is exact.

The byte figure is one part's payload entering the exchange; bit-packed
frontiers report their packed n/8 size.  ``RunTelemetry`` bundles a
run's series, wire snapshot and wall time into the summary dict the
launcher prints.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Fixed leading columns of a series row, before the per-program probes.
SERIES_FIXED_COLS = ("done", "halt")


def tally_delta(before: dict, after: dict) -> dict:
    """``{(phase, op): (bytes, taps)}`` shipped between two cumulative
    tallies (``comm.tally()``); cells with no tap are left out."""
    out = {}
    for key, (b1, t1) in after.items():
        b0, t0 = before.get(key, (0, 0))
        if t1 > t0:
            out[key] = (b1 - b0, t1 - t0)
    return out


class WireRecord:
    """Wire-byte accounting: (phase, op) -> [bytes, taps], the ``round``
    cells per round, the others whole; ``loop_bytes`` is the measured
    total of the ``round`` cells (None until measured)."""

    def __init__(self):
        self.cells: dict[tuple[str, str], list[int]] = {}
        self.loop_bytes: int | None = None

    def clear(self) -> None:
        self.cells.clear()
        self.loop_bytes = None

    def add(self, phase: str, op: str, nbytes: int, taps: int = 1) -> None:
        cell = self.cells.setdefault((phase, op), [0, 0])
        cell[0] += int(nbytes)
        cell[1] += int(taps)

    def measure(self, shipped: dict, rounds: int) -> "WireRecord":
        """Refill from ``shipped`` = ``{(phase, op): (bytes, taps)}`` of
        one run of ``rounds`` rounds (see :func:`tally_delta`)."""
        self.clear()
        loop = 0
        for (phase, op), (nbytes, taps) in sorted(shipped.items()):
            if phase == "round":
                loop += nbytes
                if rounds:
                    self.add(phase, op, nbytes // rounds, taps // rounds)
            else:
                self.add(phase, op, nbytes, taps)
        self.loop_bytes = loop
        return self

    def bytes_by_op(self) -> dict[str, int]:
        """Bytes summed over phases, keyed by op."""
        out: dict[str, int] = {}
        for (_, op), (nbytes, _) in self.cells.items():
            out[op] = out.get(op, 0) + nbytes
        return out

    def bytes_per_round(self) -> int:
        return sum(nbytes for nbytes, _ in self.cells.values())

    def snapshot(self) -> dict:
        """JSON-friendly: {"phase/op": {"bytes": b, "taps": c}}."""
        return {f"{phase}/{op}": {"bytes": b, "taps": c}
                for (phase, op), (b, c) in sorted(self.cells.items())}


@dataclass(frozen=True)
class PhaseSeries:
    """Host-side view of a series buffer: valid rows only (``done``
    column > 0.5), fixed cols then probes."""

    probe_names: tuple
    rows: np.ndarray  # (rounds, 2 + K) float32

    @classmethod
    def from_array(cls, arr, probe_names=()) -> "PhaseSeries":
        arr = np.asarray(arr, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != len(SERIES_FIXED_COLS) + len(
                probe_names):
            raise ValueError(
                f"series shape {arr.shape} does not match probes "
                f"{probe_names!r}")
        return cls(tuple(probe_names), arr[arr[:, 0] > 0.5])

    @property
    def rounds(self) -> int:
        return int(self.rows.shape[0])

    def halt(self) -> np.ndarray:
        return self.rows[:, 1]

    def probe(self, name: str) -> np.ndarray:
        return self.rows[:, len(SERIES_FIXED_COLS)
                         + self.probe_names.index(name)]

    def summary(self) -> dict:
        out = {"rounds": self.rounds}
        if self.rounds:
            out["halt_first"] = float(self.rows[0, 1])
            out["halt_last"] = float(self.rows[-1, 1])
        for name in self.probe_names:
            vals = self.probe(name)
            if len(vals):
                out[f"{name}_mean"] = float(vals.mean())
                out[f"{name}_max"] = float(vals.max())
        return out


@dataclass
class RunTelemetry:
    """Everything one telemetry run yields: the parsed per-round series,
    the wire snapshot, the wall time, and the measured loop bytes."""

    series: PhaseSeries
    wire: dict = field(default_factory=dict)   # WireRecord.snapshot()
    wall_s: float = 0.0
    loop_bytes: int | None = None              # WireRecord.loop_bytes

    def wire_bytes_by_op(self, loop_only: bool = True) -> dict[str, int]:
        """Per-round bytes by op.  The loops label taps by phase
        ("init" / "round" / "outputs"); only "round" taps repeat per
        superstep, so the default drops the one-shot ones."""
        out: dict[str, int] = {}
        for key, cell in self.wire.items():
            tap_phase, op = key.rsplit("/", 1)
            if loop_only and tap_phase != "round":
                continue
            out[op] = out.get(op, 0) + cell["bytes"]
        return out

    def summary(self) -> dict:
        """The JSON block the launcher prints.

        ``wire_bytes_total`` is the measured loop bytes plus the one-shot
        init/outputs cells; without a measured loop total (a record built
        by hand) it is per-round bytes x rounds plus the one-shot cells,
        as the JAX package computes it."""
        by_op = self.wire_bytes_by_op()
        per_round = sum(by_op.values())
        oneshot = sum(cell["bytes"] for key, cell in self.wire.items()
                      if key.rsplit("/", 1)[0] != "round")
        loop = self.loop_bytes if self.loop_bytes is not None \
            else per_round * self.series.rounds
        out = self.series.summary()
        out["wire_bytes_per_round"] = {op: int(b)
                                       for op, b in sorted(by_op.items())}
        out["wire_bytes_total"] = int(loop + oneshot)
        if self.wall_s:
            out["wall_ms"] = round(self.wall_s * 1e3, 3)
            if self.series.rounds:
                out["round_ms_mean"] = round(
                    self.wall_s * 1e3 / self.series.rounds, 3)
        return out
