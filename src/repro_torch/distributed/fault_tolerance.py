"""Fault tolerance and elasticity for training runs (host-side only).

Layers:
  1. Checkpoint/restart (``repro_torch.checkpoint``): atomic, in the JAX
     package's format; the stateless token pipeline resumes from the
     step counter alone.
  2. Elastic remesh planning: on the loss of devices, ``plan_remesh``
     picks the largest healthy (pod, data, model) layout that keeps the
     model axis, and says how far to raise gradient accumulation to keep
     the global batch.  ``launch/train.py --simulate-failure`` prints the
     plan, restores the last checkpoint and replays; on one card nothing
     is re-laid out.
  3. Straggler detection: a step-time watchdog flags slow steps.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class RemeshPlan:
    mesh_shape: tuple
    axis_names: tuple
    devices_used: int
    batch_scale: float       # multiply grad_accum by 1/this to keep tokens
    note: str = ""


def plan_remesh(total_devices: int, failed_devices: int,
                model_parallel: int = 16) -> RemeshPlan:
    """Largest (pod, data, model) mesh on the surviving devices.

    The model axis is preserved (parameter layout unchanged, so restoring
    a checkpoint moves data only along the data axis); the data axis
    shrinks to the largest power of two that fits, and grad accumulation
    rises so the global batch and the optimizer trajectory stay the
    same.
    """
    alive = total_devices - failed_devices
    data = 1
    while data * 2 * model_parallel <= alive:
        data *= 2
    used = data * model_parallel
    if used >= 2 * model_parallel * 16:
        pods = used // (model_parallel * 16)
        shape = (pods, 16, model_parallel)
        names = ("pod", "data", "model")
    else:
        shape = (data, model_parallel)
        names = ("data", "model")
    return RemeshPlan(
        mesh_shape=shape, axis_names=names, devices_used=used,
        batch_scale=used / total_devices,
        note=f"{failed_devices} devices lost; data axis {data}, "
             f"raise grad_accum x{total_devices // used} to keep global batch")


@dataclass
class StepWatchdog:
    """Flags straggler steps: step time > factor * trailing median."""

    factor: float = 2.0
    window: int = 32
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)
    _t0: float = 0.0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, step: int) -> bool:
        dt = time.perf_counter() - self._t0
        hist = sorted(self.times[-self.window:])
        median = hist[len(hist) // 2] if hist else dt
        slow = len(hist) >= 8 and dt > self.factor * median
        self.times.append(dt)
        if slow:
            self.flagged.append((step, dt, median))
        return slow
