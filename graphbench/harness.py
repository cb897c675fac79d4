"""One run of one cell: set-up, the measured window, the check, the
result line.

``run_cell`` makes the graph from the seed on the device, hands its
edges to the port's ``partition_graph``, builds the program through
``GraphEngine.program``, warms it, and then drives it in a closed loop
of one client for ``seconds`` (``trace=False``) or for the traffic's
``trace_calls`` calls under ``torch.profiler`` (``trace=True``).  Once
the window has closed it reads the peak memory, frees the program, and
holds a sample of the window's answers, drawn from the seed, against
the plain reference.  The metrics are read by the files that
``BENCHMARK.json`` names.
"""

from __future__ import annotations

import gc
import json
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from graphbench import costs, generate, manifest, trace as trace_mod

OUT = manifest.HERE / "out"
# top-level module names that may not be loaded once the window closes
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Record:
    """What the readers in ``metrics/`` read."""
    program: str
    traced: bool
    setup_s: float
    partition_s: float
    durations_s: list[float]
    window_s: float
    work: list[int]
    least_bytes: list[int]
    wire_bytes: list[int] = field(default_factory=list)
    trace: trace_mod.Summary | None = None
    hbm_bytes_per_s: float | None = None


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Reservoir:
    """A uniform sample of ``k`` of a stream's answers, drawn from the
    seed, holding references only (no copy in the window)."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, random.Random(seed), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def _wire_total(tally: dict) -> int:
    return sum(b for b, _ in tally.values())


def _window(session, device, seconds: float, sample: Reservoir):
    """The untraced window: calls until ``seconds`` have passed."""
    durations, work, failed = [], [], 0
    t_start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        try:
            outs = session.call(i)
            _sync(device)
        except Exception as exc:  # an answer that never comes
            failed += 1
            print(f"call {i} failed: {exc!r}", file=sys.stderr)
            outs = None
        t1 = time.perf_counter()
        if outs is not None:
            durations.append(t1 - t0)
            work.append(session.work(outs))
            sample.offer(session.answer(i, outs))
        i += 1
        if t1 - t_start >= seconds:
            break
    return durations, work, t1 - t_start, i, failed


def _traced(session, device, calls: int, sample: Reservoir, path: Path):
    """The traced window: ``calls`` calls under the profiler, each with
    the comm's tally around it."""
    from torch.profiler import ProfilerActivity, profile, record_function
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    durations, work, wire, failed = [], [], [], 0
    comm = session.engine.comm
    with profile(activities=activities) as prof:
        t_start = time.perf_counter()
        for i in range(calls):
            before = _wire_total(comm.tally())
            t0 = time.perf_counter()
            with record_function(trace_mod.CALL):
                try:
                    with record_function(trace_mod.PROGRAM):
                        outs = session.call(i)
                    _sync(device)
                except Exception as exc:
                    failed += 1
                    print(f"call {i} failed: {exc!r}", file=sys.stderr)
                    outs = None
            t1 = time.perf_counter()
            if outs is not None:
                durations.append(t1 - t0)
                wire.append(_wire_total(comm.tally()) - before)
                work.append(session.work(outs))
                sample.offer(session.answer(i, outs))
        window = time.perf_counter() - t_start
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return durations, work, wire, window, calls, failed


def judge(values: dict, limits: dict) -> tuple[bool, dict]:
    """The check's one rule: every number the cell's limits name is
    there and no larger than its limit.  ``(ok, checks)``, the checks
    each a number beside its limit."""
    out, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        good = v is not None and v <= lim["limit"]
        ok &= good
        out[name] = {"value": v, "limit": lim["limit"]}
    return ok, out


@dataclass
class Setup:
    """A cell's graph, made from the seed and partitioned, and its
    program's session bound to the engine."""
    session: object
    engine: object
    edges_host: object
    partition_s: float


def prepare(cell: manifest.Cell, seed: int, device,
            params: dict | None = None) -> Setup:
    """Set-up: the graph from the seed on the device, its edges handed to
    the port's ``partition_graph``, the engine and the program built.
    ``params`` overrides the traffic's program parameters (the control's
    path of the program)."""
    from repro_torch.core.api import GraphEngine
    from repro_torch.core.graph import partition_graph

    cfg, traffic = cell.config, cell.traffic
    driver = manifest.program(traffic["program"])
    n, _ = generate.sizes(cfg)

    edges = generate.make_edges(cfg, seed, device)
    out_degree = torch.bincount(edges[:, 0], minlength=n)
    session = driver.Session(cell, seed, n, int(edges.shape[0]), out_degree)
    edges_host = edges.cpu().numpy()
    del edges, out_degree
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)

    t0 = time.perf_counter()
    shards = partition_graph(edges_host, n, int(cfg["parts"]))
    partition_s = time.perf_counter() - t0
    engine = GraphEngine(shards, device=device)
    del shards
    session.bind(engine, {**traffic.get("params", {}), **(params or {})})
    return Setup(session, engine, edges_host, partition_s)


def check(setup: Setup, answers: list, limits: dict, device
          ) -> tuple[bool, dict, dict]:
    """The reference's readings of ``answers``, judged against
    ``limits``: ``(ok, checks, values)``."""
    edges = torch.from_numpy(setup.edges_host).to(device)
    values = setup.session.check(answers, edges)
    ok, checks = judge(values, limits)
    return ok, checks, values


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_process: float | None = None,
             params: dict | None = None, trace_path: Path | None = None
             ) -> dict:
    """One run; returns the result object (``checks`` last).
    ``params`` overrides the traffic's program parameters."""
    t_process = time.perf_counter() if t_process is None else t_process
    device = torch.device(device)
    traffic = cell.traffic
    setup = prepare(cell, seed, device, params)
    session = setup.session
    # the warm calls' answers are held together, as the sample holds
    # the window's, so the allocator has grown its pool before the window
    warm = [session.call(-1 - k) for k in range(int(traffic["warm_calls"]))]
    _sync(device)
    del warm
    setup_s = time.perf_counter() - t_process

    sample = Reservoir(int(traffic["check_sample"]), seed)
    if trace:
        path = trace_path or OUT / f"trace-{cell.name}.json"
        durations, work_dev, wire, window, attempted, failed = _traced(
            session, device, int(traffic["trace_calls"]), sample, path)
    else:
        durations, work_dev, window, attempted, failed = _window(
            session, device, seconds, sample)
        wire = []
    work = session.work_values(work_dev)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    name = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"

    summary = None
    if trace and device.type == "cuda":
        summary = trace_mod.summarize_file(path)
    session.release()
    setup.engine = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    answers = sample.items
    ok, checks, _ = check(setup, answers, cell.limits, device)
    correct = bool(ok and answers and failed == 0)

    record = Record(
        program=traffic["program"], traced=trace, setup_s=setup_s,
        partition_s=setup.partition_s, durations_s=durations,
        window_s=window, work=work,
        least_bytes=[session.least_bytes(w) for w in work],
        wire_bytes=wire, trace=summary,
        hbm_bytes_per_s=costs.peak(name, "hbm_bytes_per_s"))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = manifest.reader(m["name"])(record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": name, "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    """The check's numbers as the last lines of standard error, then the
    result as the last line of standard output."""
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
