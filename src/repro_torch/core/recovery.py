"""Checkpointed, fault-recovering runs of superstep programs.

``core/superstep.py`` supplies the chunked substrate (``init_carry`` /
``run_chunk`` / ``carry_outputs``); this module owns the host loop that
turns it into fault tolerance:

  * every ``checkpoint_every`` rounds the loop carry (state, in-flight
    async handle, round counter, verdict) is copied to host memory
    (:class:`Checkpoint`);
  * each chunk runs guarded: the program's per-round check and the
    transport stamps (``core/faults``) stop it on the first bad round;
  * on a detection the runner restores the last checkpoint and replays
    the chunk with the schedule DISARMED: the transient-fault model, in
    which a fault belongs to one execution of those rounds, not to the
    rounds.  Later chunks run armed again, so later events still fire
    and are recovered in turn.  A violation that survives the clean
    replay is a real fault of the program or its guard and raises
    :class:`RecoveryError`;
  * ``run(..., resume_from=checkpoint)`` restarts from any snapshot.

Over ``DistComm`` (one part a rank) every rank runs the same loop on
its own part: it snapshots and restores its part's carry, and the
verdict that drives detection and rollback is the one every rank
already agrees on (``superstep._round_ok`` ANDs over the ranks, and a
transport stamp depends only on the schedule and the round).  An async
program's carry holds the exchange in flight, a ``Pending``: a
snapshot finishes it into host rows and a restore rebuilds it as a
finished handle on the device, so a replay never reads a handle that
was already waited on.  A resume checks over the control plane that
every rank resumes the same ``(phase, rounds)`` from its own part's
checkpoint.

Chunking does not change a round's arithmetic, and the host copies are
exact, so a checkpointed, resumed or recovered run gives the bits of an
uninterrupted one.

Each phase's ``prepare`` runs once a run and its result serves every
chunk (k-core's degrees, triangles' adjacency bitmap).

``telemetry=True`` carries the per-round series as carry[4]: it is
snapshotted and restored with the carry, so a recovered run's series
has no rows of discarded chunks, and ``RunReport.telemetry`` is its
summary, with the wire the committed chunks shipped.  ``obs=`` takes a
``SpanRecorder``: a ``chunk`` span per chunk and ``checkpoint``,
``fault_detection`` and ``rollback`` events on the ``recovery`` track.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.core import faults as faults_mod
from repro_torch.core import localops, registry
from repro_torch.core.partitioned import Pending
from repro_torch.core.superstep import PhasedProgram, carry_outputs, \
    init_carry, run_chunk
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.spans import NULL_RECORDER


class RecoveryError(RuntimeError):
    """A guard violation that checkpoint rollback cannot clear."""


def _copy(tree, device):
    """Every tensor of ``tree`` copied to ``device`` and every host array
    copied (never aliased: on a CPU engine ``.to("cpu")`` would return
    the live tensor, and the loop writes the telemetry series in
    place).  An exchange in flight is finished first, and copied as a
    finished handle holding its received rows."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    if isinstance(tree, Pending):
        return Pending.finished(tree.wait(), device)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    if isinstance(tree, (tuple, list)):
        return type(tree)(_copy(x, device) for x in tree)
    return tree


@dataclass(frozen=True)
class Checkpoint:
    """A host-memory snapshot of one phase's loop carry: every tensor
    copied to the CPU, host numbers as they are.  Restoring copies the
    tensors back to the engine's device, bit for bit.  ``part`` is the
    first part the carry holds: 0 for every part stacked, the rank's
    part over ``DistComm``."""

    phase: int
    rounds: int
    carry: Any
    part: int = 0


@dataclass
class RunReport:
    """What a checkpointed run did, beyond its outputs.

    ``outputs`` are what a direct call returns: vertex fields as
    ``(P, n_local)`` tensors on the engine's device, ``(1, n_local)``
    on a rank (``engine.gather_vertex_field`` applies), scalars as host
    numbers.
    ``detections`` lists the round counter at each detection (the first
    tainted round + 1, or 0 for an init); ``recoveries`` counts the
    rollback replays that cleared one.  ``telemetry`` is the
    ``RunTelemetry.summary()`` of a telemetry run, else None.
    """

    outputs: tuple
    rounds: int
    recoveries: int = 0
    detections: tuple = ()
    checkpoints: int = 0
    history: tuple = ()
    telemetry: dict | None = None


class CheckpointRunner:
    """Run one registered program with superstep checkpoints, fault
    injection and rollback recovery.

        runner = CheckpointRunner(engine, "bfs", "fast",
                                  checkpoint_every=2,
                                  faults="corrupt@r3p1:sum seed=7")
        report = runner.run(engine.device_graph(), root)

    ``faults=None`` runs plain checkpointed execution; a
    :class:`~repro_torch.core.faults.FaultSchedule` (or its string form)
    is armed for every chunk but the recovery replays.
    ``keep_history=True`` keeps every checkpoint in the report (to
    resume from one).  The local-ops mode active at construction is the
    one the runs take.  ``telemetry=True`` fills ``RunReport.telemetry``;
    ``obs`` is a ``SpanRecorder`` for the chunk spans and events
    (``NULL_RECORDER``, off, by default).
    """

    def __init__(self, engine, algo: str, variant: str | None = None, *,
                 checkpoint_every: int = 2, faults=None,
                 max_recoveries: int = 16, keep_history: bool = False,
                 telemetry: bool = False, obs=None, **params):
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        self.engine = engine
        self.spec = registry.get_spec(algo, variant)
        self.schedule = faults_mod.as_schedule(faults)
        self.checkpoint_every = int(checkpoint_every)
        self.max_recoveries = int(max_recoveries)
        self.keep_history = bool(keep_history)
        self.telemetry = bool(telemetry)
        self.obs = obs if obs is not None else NULL_RECORDER
        self.mode = localops.get_mode()
        self.program = self.spec.build(engine.g, engine.comm, **params)
        self.phases = self.program.phases \
            if isinstance(self.program, PhasedProgram) else (self.program,)

    def _armed(self, faulty: bool):
        return faults_mod.active(self.schedule if faulty else None,
                                 detect=True)

    def _snapshot(self, pi: int, carry) -> Checkpoint:
        return Checkpoint(phase=pi, rounds=carry[2],
                          carry=_copy(carry, "cpu"),
                          part=self.engine.comm.first_part)

    def _restore(self, ck: Checkpoint):
        return _copy(ck.carry, self.engine.device)

    def _check_resume(self, ck: Checkpoint) -> None:
        """Every rank resumes the same ``(phase, rounds)``, each from its
        own part's checkpoint, or every rank raises."""
        comm = self.engine.comm
        said = comm.gather_objects((ck.phase, ck.rounds, ck.part,
                                    comm.first_part))
        if len({(ph, r) for ph, r, _, _ in said}) > 1 or any(
                part != own for _, _, part, own in said):
            raise ValueError(
                f"{self.spec.key}: resume checkpoints disagree across "
                "ranks: (phase, rounds, checkpoint part, rank part) = "
                f"{said}")

    def _bump(self, stats: dict) -> None:
        stats["recoveries"] += 1
        if stats["recoveries"] > self.max_recoveries:
            raise RecoveryError(
                f"{self.spec.key}: exceeded max_recoveries="
                f"{self.max_recoveries}")

    def _keep(self, ck: Checkpoint, stats: dict) -> None:
        stats["checkpoints"] += 1
        self.obs.event("checkpoint", "recovery", phase=ck.phase,
                       rounds=ck.rounds)
        if self.keep_history:
            stats["history"].append(ck)

    def _detected(self, pi: int, rounds: int, to_rounds: int,
                  stats: dict) -> None:
        stats["detections"].append(rounds)
        self.obs.event("fault_detection", "recovery", phase=pi,
                       round=rounds)
        self._bump(stats)
        self.obs.event("rollback", "recovery", phase=pi,
                       to_rounds=to_rounds)

    def _chunk(self, prog, g: dict, carry, faulty: bool, stats: dict):
        """One chunk; under telemetry its rounds and wire count toward
        the run's if it is kept (``ok``)."""
        comm = self.engine.comm
        before = comm.tally() if self.telemetry else None
        with self._armed(faulty):
            nxt, halted = run_chunk(prog, g, carry, self.checkpoint_every)
        if before is not None and nxt[3]:
            stats["loop_rounds"] += nxt[2] - carry[2]
            for key, (b, t) in obs_telemetry.tally_delta(
                    before, comm.tally()).items():
                cell = stats["wire"].setdefault(key, [0, 0])
                cell[0] += b
                cell[1] += t
        return nxt, halted

    def _run_phase(self, pi: int, prog, g: dict, inputs, stats: dict,
                   resume: Checkpoint | None):
        if resume is not None:
            carry = self._restore(resume)
        else:
            with self._armed(True):
                carry = init_carry(prog, g, *inputs,
                                   telemetry=self.telemetry)
            if not carry[3]:
                self._detected(pi, carry[2], 0, stats)
                with self._armed(False):
                    carry = init_carry(prog, g, *inputs,
                                       telemetry=self.telemetry)
                if not carry[3]:
                    raise RecoveryError(
                        f"{self.spec.key} phase {pi}: clean re-init still "
                        f"violates guards")
        ck = self._snapshot(pi, carry)
        self._keep(ck, stats)
        while True:
            r0 = carry[2]
            with self.obs.span("chunk", "recovery", phase=pi,
                               from_round=r0) as span:
                nxt, halted = self._chunk(prog, g, carry, True, stats)
                if not nxt[3]:
                    self._detected(pi, nxt[2], ck.rounds, stats)
                    nxt, halted = self._chunk(prog, g, self._restore(ck),
                                              False, stats)
                    if not nxt[3]:
                        raise RecoveryError(
                            f"{self.spec.key} phase {pi}: guard violation "
                            f"at round {nxt[2]} persists on clean replay "
                            f"from the round-{ck.rounds} checkpoint")
                carry = nxt
                span.args["to_round"] = carry[2]
            ck = self._snapshot(pi, carry)
            self._keep(ck, stats)
            if halted or carry[2] == r0:
                return carry

    def run(self, garr: dict, *inputs,
            resume_from: Checkpoint | None = None) -> RunReport:
        """Run (or resume) the program; returns a :class:`RunReport`.

        ``garr`` is ``engine.device_graph()``; ``inputs`` follow the
        spec's inputs as in a direct call.  ``resume_from`` restarts from
        a snapshot: the phases before it are folded into its carry, later
        phases run from their inits.  Over ``DistComm`` each rank passes
        its own part's checkpoint, and every rank raises ``ValueError``
        unless all of them resume the same ``(phase, rounds)``.
        """
        if resume_from is not None:
            self._check_resume(resume_from)
        stats = {"recoveries": 0, "detections": [], "checkpoints": 0,
                 "history": [], "wire": {}, "loop_rounds": 0}
        start = resume_from.phase if resume_from is not None else 0
        total, chained, carry, prog, g = 0, inputs, None, None, None
        series = []
        with localops.using(self.mode):
            for pi in range(start, len(self.phases)):
                prog = self.phases[pi]
                g = prog.prepare(garr)
                resume = resume_from if pi == start else None
                carry = self._run_phase(pi, prog, g, chained, stats, resume)
                total += carry[2]
                if self.telemetry:
                    series.append(carry[4])
                if pi + 1 < len(self.phases):
                    chained = carry_outputs(prog, g, carry)
            outs = carry_outputs(prog, g, carry)
        telemetry = None
        if self.telemetry:
            wire = obs_telemetry.WireRecord().measure(
                stats["wire"], stats["loop_rounds"])
            telemetry = obs_telemetry.RunTelemetry(
                series=obs_telemetry.PhaseSeries.from_array(
                    np.concatenate(series), self.program.probe_names),
                wire=wire.snapshot(), loop_bytes=wire.loop_bytes).summary()
        return RunReport(
            outputs=tuple(outs), rounds=total,
            recoveries=stats["recoveries"],
            detections=tuple(stats["detections"]),
            checkpoints=stats["checkpoints"],
            history=tuple(stats["history"]), telemetry=telemetry)
