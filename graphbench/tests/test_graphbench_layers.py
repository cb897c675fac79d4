"""The layer-span reader on hand-made Chrome traces, and its metrics on
an untraced run and on a CPU run's own trace."""

import dataclasses
import json

import pytest
from pytest import approx

from graphbench import harness, layers, manifest, trace
from graphbench.tests.helpers import SEED, one_thread, tiny_cell  # noqa: F401

P = layers.PREFIX


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 7,
         "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launch(ts, corr):
    return ev("cuda_runtime", "cudaLaunchKernel", ts, 1, corr)


# two calls, [0, 100] and [100, 200]; kernels [start, end] by the span
# that launched them
BASE = [
    ev("user_annotation", trace.CALL, 0, 100),
    ev("user_annotation", trace.PROGRAM, 0, 90),
    ev("user_annotation", trace.CALL, 100, 100),
    ev("user_annotation", trace.PROGRAM, 100, 90),
    ev("cuda_runtime", "cudaStreamSynchronize", 80, 5),
    ev("cpu_op", "aten::gather", 11, 3),
    launch(12, 1), ev("kernel", "gather_k", 20, 10, corr=1, tid=9),
    launch(32, 2), ev("kernel", "any_k", 30, 10, corr=2, tid=9),
    launch(41, 3), ev("kernel", "bfs_pull", 40, 5, corr=3, tid=9),
    launch(52, 4), ev("gpu_memcpy", "Memcpy DtoD", 50, 4, corr=4, tid=9),
    launch(60, 5), ev("kernel", "late_k", 60, 6, corr=5, tid=9),
    launch(120, 6), ev("kernel", "spmv_ell", 120, 30, corr=6, tid=9),
    launch(195, 7), ev("kernel", "after_k", 196, 3, corr=7, tid=9),
    # launched after the last call (`Session.work`'s sum): no call's
    launch(205, 8), ev("kernel", "work_k", 206, 2, corr=8, tid=9),
]
# record_function's ranges are user annotations, torch's C++ range's
# host ops: both are port spans
PORT = [
    ev("user_annotation", P + "engine.call", 1, 88),
    ev("user_annotation", P + "engine.round", 10, 45),
    ev("user_annotation", P + "bfs.push", 10, 40),
    ev("user_annotation", P + "localops.scatter_combine", 30, 10),
    ev("user_annotation", P + "localops.frontier_pull", 40, 5),
    ev("user_annotation", P + "comm.exchange_or", 50, 5),
    ev("cpu_op", P + "engine.call", 101, 88),
    ev("cpu_op", P + "engine.round", 110, 40),
    ev("cpu_op", P + "localops.scatter_combine", 115, 30),
    # a span on another thread does not own the main thread's launches
    ev("user_annotation", P + "comm.psum_scalar", 190, 9, tid=2),
]


def test_kernels_go_to_the_innermost_span_that_launched_them():
    s = layers.summarize(BASE + PORT)
    assert s.calls == 2 and s.window_s == approx(200e-6)
    assert s.device_s == approx({
        P + "bfs.push": 10e-6,                   # gather_k
        P + "localops.scatter_combine": 40e-6,   # any_k, spmv_ell
        P + "localops.frontier_pull": 5e-6,      # bfs_pull
        P + "comm.exchange_or": 4e-6,            # the copy
        P + "engine.call": 6e-6,                 # late_k
    })
    assert s.count == {
        P + "engine.call": 2, P + "engine.round": 2, P + "bfs.push": 1,
        P + "localops.scatter_combine": 2, P + "localops.frontier_pull": 1,
        P + "comm.exchange_or": 1, P + "comm.psum_scalar": 1}
    # self time: less the port spans directly inside
    assert s.host_self_s[P + "engine.call"] == approx(
        (88 - 45 + 88 - 40) * 1e-6)
    assert s.host_self_s[P + "engine.round"] == approx(
        (45 - 40 - 5 + 40 - 30) * 1e-6)
    assert s.host_self_s[P + "bfs.push"] == approx((40 - 10 - 5) * 1e-6)
    # launched in a call outside any port span: after_k, in call 2
    assert s.outside_s == approx([0.0, 3e-6])


def test_port_spans_leave_the_trace_summary_as_it_was():
    plain, spanned = trace.summarize(BASE), trace.summarize(BASE + PORT)
    for name in ("window_s", "busy_s", "call_busy_s", "syncs", "calls",
                 "device_ops"):
        assert getattr(spanned, name) == getattr(plain, name), name


def test_a_trace_without_port_spans_reads_none():
    assert layers.summarize(BASE) is None
    with pytest.raises(ValueError):
        layers.summarize(PORT)


NEW = [m["name"] for m in manifest.load()["per_layer"]
       if m["source"] == "program_span"]


def _record(program, traced, summary=None):
    return harness.Record(
        program=program, traced=traced, setup_s=1.0, partition_s=0.5,
        durations_s=[0.01, 0.02], window_s=0.05, work=[1, 1],
        least_bytes=[1, 1], trace=summary)


@pytest.mark.parametrize("name", NEW)
def test_the_new_readers_return_none_on_an_untraced_record(name):
    read = manifest.reader(name)
    program = name.split(".")[-1]
    assert read(_record(program, False)) is None
    assert read(_record(program, True)) is None   # traced on the CPU


def _write(path, events):
    path.write_text(json.dumps({"traceEvents": events}))


def test_the_readers_find_their_runs_trace(tmp_path, monkeypatch):
    """Of the traces in ``out/``, the one with the record's window."""
    monkeypatch.setattr(harness, "OUT", tmp_path)
    _write(tmp_path / "trace-a.json", BASE + PORT)
    shifted = [dict(e, ts=e["ts"] + 1000) for e in BASE + PORT]
    shifted[2]["dur"] = 150                # another window
    _write(tmp_path / "trace-b.json", shifted)
    rec = _record("bfs", True, trace.summarize(BASE + PORT))
    assert manifest.reader("push_levels.bfs")(rec) == 0.5
    assert manifest.reader("combine_ms.bfs")(rec) == approx(40e-3 / 2)
    assert manifest.reader("exchange_ms.bfs")(rec) == approx(4e-3 / 2)
    assert manifest.reader("round_ms.bfs")(rec) == approx(10e-3 / 2)
    assert manifest.reader("combine_ms.pagerank")(rec) is None
    other = _record("bfs", True, trace.summarize(shifted))
    assert layers.of_record(other).window_s == approx(250e-6)
    # the parent's program: the same window, no port spans
    _write(tmp_path / "trace-a.json", BASE)
    assert manifest.reader("push_levels.bfs")(rec) is None


@pytest.mark.parametrize("cell", ["urand22-bfs", "urand22-pagerank"])
def test_a_cpu_runs_trace_reads_its_levels(cell, tmp_path, monkeypatch):
    """A traced tiny run on the CPU: its counts and host times from its
    own trace (the CPU launches no device operation)."""
    monkeypatch.setattr(harness, "OUT", tmp_path)
    c = tiny_cell(cell)
    c = dataclasses.replace(c, traffic={**c.traffic, "trace_calls": 3})
    result = harness.run_cell(c, SEED, 0.1, True, device="cpu")
    assert result["correct"]
    path = tmp_path / f"trace-{cell}.json"
    rec = _record(c.traffic["program"], True, trace.summarize_file(path))
    s = layers.of_record(rec)
    assert s.calls == 3 and s.device_s == {}
    assert s.count[P + "engine.call"] == 3
    if cell == "urand22-bfs":
        levels = manifest.reader("push_levels.bfs")(rec)
        pulls = s.count.get(P + "bfs.pull", 0) / 3
        assert levels + pulls == s.count[P + "engine.round"] / 3
        assert manifest.reader("engine_host_ms.bfs")(rec) > 0
    else:
        assert manifest.reader("rounds.pagerank")(rec) \
            == s.count[P + "localops.scatter_combine"] / 3 > 1
        assert manifest.reader("engine_host_ms.pagerank")(rec) > 0
        assert manifest.reader("round_ms.pagerank")(rec) == 0.0
