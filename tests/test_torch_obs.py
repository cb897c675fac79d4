"""The port's observability package (``repro_torch/obs/``) and its hooks
in the engine, on the CPU:

  * the in-process tests of tests/test_obs.py that need no server: the
    span ring bound and drop counts, the context manager's error stamp,
    the inert ``NULL_RECORDER``; ``PhaseSeries`` trimming and width
    check, ``WireRecord`` phases (measured from ``StackedComm``
    tallies here), ``RunTelemetry.summary``; the Chrome export's
    shapes, the validator's rejections, ``write_trace``'s round trip;
    ``trace_summary``, ``derive_latency_cells``, and the port's span
    table against ``docs/API.md``;
  * the port against the JAX package's ``repro.obs`` on the same
    inputs: the reference's declarations within the port's, Chrome
    trace dicts and summaries equal;
  * the layer sites (``obs.span`` / ``obs.spanned``): spans on against
    off bit for bit for every registered program, no profiler range
    entered when nothing records, the profiler ranges' names and
    counts of bfs/fast and pagerank/fast, and the launcher's
    ``--trace-out`` of measured rounds;
  * the engine (urand N=256, 2048 edges, seed 11, root 3): telemetry on
    against off bit for bit for every registered program at parts {1, 2,
    4}, with the same ``Tensor.item`` count; telemetry as a cache
    dimension and its composition rules; the measured wire against the
    exchanges' tallies; guard with telemetry; phased probe layouts;
  * ``CheckpointRunner(telemetry=True, obs=...)``: checkpoint, detection
    and rollback events matching the report, chunk spans, the run's
    layer spans, and a recovered series equal to the clean run's rows.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from conftest import REPO
from repro import obs as ref_obs
from repro_torch.core import CheckpointRunner, GraphEngine, \
    incremental, partition_graph, registry
from repro_torch.core.recovery import _copy
from repro_torch.core.superstep import PhasedProgram, run_program
from repro_torch.graphs import urand_edges
from repro_torch.obs import (
    COMPONENTS,
    NULL_RECORDER,
    SPAN_KINDS,
    Event,
    PhaseSeries,
    RunTelemetry,
    Span,
    SpanRecorder,
    WireRecord,
    chrome_trace,
    derive_latency_cells,
    recording,
    span,
    spanned,
    spans_markdown_table,
    trace_summary,
    validate_chrome_trace,
    write_trace,
)
from repro_torch.obs import registry as obs_registry
from repro_torch.obs import spans as obs_spans
from repro_torch.obs import telemetry as obs_tel

N, E, ROOT = 256, 2048, 3
PARTS = (1, 2, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    edges = urand_edges(N, E, seed=11)
    return {p: GraphEngine(partition_graph(edges, N, parts=p), device="cpu")
            for p in PARTS}


@pytest.fixture(scope="module")
def eng(engines):
    return engines[1]


def _args(eng, spec):
    if any(k != "scalar" for k in spec.input_kinds):
        (seed_arr,) = incremental.cold_seed(spec, eng.g)
        return (eng.scatter_vertex_field(
            seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]),)
    return (ROOT,) * len(spec.inputs)


class _Items:
    """Counts ``Tensor.item`` calls (the loops' host syncs) while active."""

    def __enter__(self):
        self.count, item = 0, torch.Tensor.item
        self._item = item

        def counted(t):
            self.count += 1
            return item(t)

        torch.Tensor.item = counted
        return self

    def __exit__(self, *exc):
        torch.Tensor.item = self._item


# -- span recorder -------------------------------------------------------


def test_span_recorder_ring_bounds_and_drop_counts():
    rec = SpanRecorder(maxlen=4)
    for i in range(6):
        rec.add_span("admission", "server", float(i), float(i) + 0.5, i=i)
        rec.event("shed", "server", i=i)
    assert len(rec.spans()) == 4 and rec.dropped_spans == 2
    assert len(rec.events()) == 4 and rec.dropped_events == 2
    assert [s.args["i"] for s in rec.spans()] == [2, 3, 4, 5]  # newest win
    rec.clear()
    assert rec.spans() == [] and rec.events() == []
    assert rec.dropped_spans == 0 and rec.dropped_events == 0


def test_span_context_manager_closes_and_stamps_errors():
    rec = SpanRecorder()
    with rec.span("validate", "server", qid=7) as sp:
        sp.args["extra"] = 1
    with pytest.raises(RuntimeError):
        with rec.span("dispatch", "executor"):
            raise RuntimeError("boom")
    s_ok, s_err = rec.spans()
    assert s_ok.kind == "validate" and s_ok.args == {"qid": 7, "extra": 1}
    assert s_ok.t1 >= s_ok.t0 and s_ok.dur >= 0.0
    assert s_err.args["error"] == "RuntimeError"
    assert s_err.seq > s_ok.seq         # recorder-global, in start order


def test_null_recorder_is_inert():
    with NULL_RECORDER.span("admission", "server") as sp:
        sp.args["x"] = 1                # the body still works
    NULL_RECORDER.add_span("query", "server", 0.0, 1.0)
    NULL_RECORDER.event("shed", "server")
    assert not NULL_RECORDER.enabled
    assert NULL_RECORDER.spans() == [] and NULL_RECORDER.events() == []


# -- telemetry series + wire accounting ----------------------------------


def test_phase_series_trims_on_done_column():
    arr = np.zeros((6, 3), np.float32)  # 2 fixed cols + 1 probe
    arr[:4, 0] = 1.0                    # 4 rows actually written
    arr[3, 1] = 1.0                     # halted on the last one
    arr[:4, 2] = [5, 9, 2, 0]
    ps = PhaseSeries.from_array(arr, ("frontier",))
    assert ps.rounds == 4
    assert list(ps.halt()) == [0.0, 0.0, 0.0, 1.0]
    assert list(ps.probe("frontier")) == [5.0, 9.0, 2.0, 0.0]
    summ = ps.summary()
    assert summ["rounds"] == 4 and summ["halt_last"] == 1.0
    assert summ["frontier_max"] == 9.0
    assert summ["frontier_mean"] == pytest.approx(4.0)


def test_phase_series_width_mismatch_raises():
    with pytest.raises(ValueError):
        PhaseSeries.from_array(np.zeros((3, 3), np.float32),
                               ("a", "b"))  # expects 2 + 2 columns
    with pytest.raises(ValueError):
        PhaseSeries.from_array(np.zeros(6, np.float32), ())


def test_wire_record_phases_and_measurement(engines):
    rec = WireRecord()
    rec.add("stale", "junk", 999)       # measure() must clear this
    comm = engines[4].comm
    comm.reset_wire()
    before = comm.tally()
    comm.phase = "init"
    comm.broadcast_global(torch.zeros((4, 8), dtype=torch.float32))
    comm.phase = "round"
    for _ in range(3):                  # three rounds of two exchanges
        comm.exchange_min_int(torch.zeros((4, 16), dtype=torch.int32))
        comm.exchange_min_int(torch.zeros((4, 16), dtype=torch.int32))
    comm.phase = "outputs"
    comm.exchange_sum(torch.zeros((4, 8), dtype=torch.float32))
    comm.phase = "round"
    shipped = obs_tel.tally_delta(before, comm.tally())
    assert rec.measure(shipped, rounds=3) is rec
    # one part's bytes: a (P, 16) int32 proposal ships 16 x 4
    assert rec.snapshot() == {
        "init/bcast": {"bytes": 8 * 4, "taps": 1},
        "outputs/sum": {"bytes": 8 * 4, "taps": 1},
        "round/min": {"bytes": 2 * 16 * 4, "taps": 2},
    }
    assert rec.loop_bytes == 3 * 2 * 16 * 4
    assert rec.bytes_by_op() == {"bcast": 32, "min": 128, "sum": 32}
    assert rec.bytes_per_round() == 32 + 128 + 32
    # the comm's own tallies stay cumulative
    assert comm.wire_by_op() == {"min": 3 * 2 * 16 * 4}
    assert obs_tel.tally_delta(comm.tally(), comm.tally()) == {}
    comm.reset_wire()


def test_run_telemetry_summary_math():
    arr = np.zeros((3, 2), np.float32)
    arr[:, 0] = 1.0
    tel = RunTelemetry(
        series=PhaseSeries.from_array(arr),
        wire={"round/all_to_all": {"bytes": 100, "taps": 2},
              "init/all_gather": {"bytes": 7, "taps": 1}},
        wall_s=0.03)
    assert tel.wire_bytes_by_op() == {"all_to_all": 100}
    assert tel.wire_bytes_by_op(loop_only=False) == {
        "all_to_all": 100, "all_gather": 7}
    summ = tel.summary()
    assert summ["wire_bytes_per_round"] == {"all_to_all": 100}
    assert summ["wire_bytes_total"] == 100 * 3 + 7
    assert summ["round_ms_mean"] == pytest.approx(10.0)
    # a measured loop total is taken as it is, not per round x rounds
    tel.loop_bytes = 290
    assert tel.summary()["wire_bytes_total"] == 290 + 7


# -- Chrome trace export + schema validator ------------------------------


def _spanset(mod=None):
    """admission(validate nested) + overlapping async queries + event."""
    S = mod.Span if mod else Span
    Ev = mod.Event if mod else Event
    spans = [
        S("admission", "server", 0.000, 0.010, 1, {"qid": 0}),
        S("validate", "server", 0.001, 0.002, 2, {}),
        S("query", "server", 0.000, 0.050, 3,
          {"qid": 0, "status": "ok", "latency_s": 0.05}),
        S("query", "server", 0.005, 0.040, 4,
          {"qid": 1, "status": "ok", "latency_s": 0.035}),
        S("device", "device", 0.010, 0.030, 5, {"n": 2}),
        S("chunk", "recovery", 0.011, 0.019, 7, {"phase": 0}),
    ]
    events = [Ev("shed", "server", 0.020, 6, {"qid": 2}),
              Ev("rollback", "recovery", 0.015, 8, {"to_rounds": 2})]
    return spans, events


def test_chrome_trace_export_shapes():
    spans, events = _spanset()
    trace = chrome_trace(spans, events)
    counts = validate_chrome_trace(trace)
    # 3 complete spans, 3 async spans (query x2 overlap + device), 2 inst
    assert counts["X"] == 3
    assert counts["b"] == counts["e"] == 3
    assert counts["i"] == 2
    assert counts["M"] >= 1
    evs = trace["traceEvents"]
    assert all(e["ts"] >= 0 for e in evs)   # relative to earliest stamp
    b_ids = {e["id"] for e in evs if e["ph"] == "b"}
    assert b_ids == {3, 4, 5}               # async pairs keyed by seq


def test_validator_rejects_malformed_traces():
    def bad(evs):
        with pytest.raises(ValueError):
            validate_chrome_trace({"traceEvents": evs})

    bad([{"ph": "X", "pid": 1, "tid": 0, "name": "a", "dur": 1.0}])
    bad([{"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0.0}])
    # partial overlap on one track (nesting would be fine)
    bad([{"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0.0,
          "dur": 10.0},
         {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 5.0,
          "dur": 10.0}])
    # unmatched / inverted async pairs
    bad([{"ph": "b", "pid": 1, "tid": 0, "name": "q", "cat": "server",
          "id": 1, "ts": 0.0}])
    bad([{"ph": "e", "pid": 1, "tid": 0, "name": "q", "cat": "server",
          "id": 1, "ts": 0.0}])
    # decreasing timestamps on one track
    bad([{"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 10.0,
          "dur": 1.0},
         {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 5.0,
          "dur": 1.0}])
    with pytest.raises(ValueError):
        validate_chrome_trace({"nope": []})
    # proper nesting on one track is NOT an error
    validate_chrome_trace({"traceEvents": [
        {"ph": "X", "pid": 1, "tid": 0, "name": "a", "ts": 0.0,
         "dur": 10.0},
        {"ph": "X", "pid": 1, "tid": 0, "name": "b", "ts": 2.0,
         "dur": 3.0}]})


def test_write_trace_round_trip(tmp_path):
    spans, events = _spanset()
    rec = SpanRecorder()
    with recording(rec), span("call", "engine"):
        for _ in range(2):
            with span("round", "engine"), span("exchange_or", "comm"):
                pass
    trace = chrome_trace(spans + rec.spans(), events)
    path = tmp_path / "sub" / "trace.json"
    counts = write_trace(path, trace)
    assert counts == validate_chrome_trace(trace)
    on_disk = json.loads(path.read_text())
    assert on_disk == json.loads(json.dumps(trace))
    assert len(on_disk["traceEvents"]) == sum(counts.values())


# -- report: trace_summary + latency cells -------------------------------


def test_trace_summary_counts_and_ranking():
    rec = SpanRecorder()
    rec.add_span("admission", "server", 0.0, 0.001)
    rec.add_span("admission", "server", 0.0, 0.002)
    rec.add_span("device", "device", 0.0, 0.5)
    rec.event("shed", "server")
    summ = trace_summary(rec, top=2)
    assert summ["spans_total"] == 3 and summ["events_total"] == 1
    assert summ["spans_per_kind"] == {"admission": 2, "device": 1}
    assert summ["spans_per_component"] == {"device": 1, "server": 2}
    assert summ["events_per_kind"] == {"shed": 1}
    assert summ["top_p99_ms"][0]["kind"] == "device"
    assert summ["top_p99_ms"][0]["p99_ms"] == pytest.approx(500.0)
    assert summ["dropped_spans"] == 0


def test_derive_latency_cells_counts_only_ok_queries():
    rec = SpanRecorder()
    rec.add_span("query", "server", 0.0, 0.1, label="bfs_fast", bucket=4,
                 status="ok", latency_s=0.125)
    rec.add_span("query", "server", 0.0, 0.1, label="bfs_fast", bucket=4,
                 status="timed_out", latency_s=9.0)
    rec.add_span("query", "server", 0.0, 0.1, label="pagerank_fast",
                 bucket=0, status="ok", latency_s=0.5)
    rec.add_span("admission", "server", 0.0, 0.1)
    assert derive_latency_cells(rec) == {
        ("bfs_fast", 4): [0.125],
        ("pagerank_fast", 0): [0.5],
    }


# -- docs drift: the registry tables in docs/API.md ----------------------


@pytest.mark.parametrize("table", [spans_markdown_table])
def test_docs_observability_tables_are_current(table):
    content = open(os.path.join(REPO, "docs", "API.md")).read()
    assert table() in content, (
        f"docs/API.md drifted from repro_torch.obs.registry: "
        f"{table.__name__}() is not in it")


# -- the port against repro.obs on the same inputs -----------------------


# what the port declares beyond the reference: the analytics path's
# layer spans (the reference's splayed ``engine_round`` is gone)
PORT_COMPONENTS = ("bfs", "localops", "comm")
PORT_KINDS = {
    "engine": ("call", "init", "round", "outputs"),
    "bfs": ("push", "pull"),
    "localops": ("scatter_combine", "frontier_pull", "spmv_pull",
                 "pull_min_eq"),
    "comm": ("exchange_sum", "exchange_or", "exchange_min_int",
             "broadcast_global", "shift", "psum_scalar", "sum_parts",
             "all_parts", "max_scalar", "gather_parts",
             "exchange_min_start", "exchange_min_finish",
             "exchange_sum_start", "exchange_sum_finish",
             "exchange_or_start", "exchange_or_finish"),
}


def test_registry_declarations_equal_reference():
    ref = ref_obs.registry
    # the reference's components first, in its tid order, with its
    # descriptions but the engine's (measured layer spans, not telemetry)
    assert list(COMPONENTS) == list(ref.COMPONENTS) + list(PORT_COMPONENTS)
    assert {k: v for k, v in COMPONENTS.items()
            if k in ref.COMPONENTS and k != "engine"} \
        == {k: v for k, v in ref.COMPONENTS.items() if k != "engine"}
    ref_kinds = {k: v for k, v in ref.SPAN_KINDS.items()
                 if k != "engine_round"}
    assert {k: SPAN_KINDS[k] for k in ref_kinds} == ref_kinds
    port_only = {k: v[0] for k, v in SPAN_KINDS.items()
                 if k not in ref.SPAN_KINDS}
    assert port_only == {k: comp for comp, kinds in PORT_KINDS.items()
                         for k in kinds}
    assert "engine_round" not in SPAN_KINDS
    assert obs_registry.EVENT_KINDS == ref.EVENT_KINDS
    assert obs_tel.SERIES_FIXED_COLS == ref_obs.telemetry.SERIES_FIXED_COLS
    import repro_torch.obs as port_obs
    removed = {"INSTRUMENTS", "Registry", "instruments_markdown_table",
               "rollup"}
    added = {"recording", "span", "spanned"}
    assert set(port_obs.__all__) \
        == (set(ref_obs.__all__) - removed) | added


def test_chrome_trace_equals_reference():
    """The same spans and events export to the reference's events; the
    metadata differs only by the process's name and the port's own
    components' tracks."""
    spans, events = _spanset()
    rspans, revents = _spanset(ref_obs)
    got, want = chrome_trace(spans, events), ref_obs.chrome_trace(
        rspans, revents)

    def body(trace):
        return [e for e in trace["traceEvents"] if e["ph"] != "M"
                or e["args"]["name"] in ref_obs.registry.COMPONENTS]

    assert body(got) == body(want)
    assert [e["args"]["name"] for e in got["traceEvents"]
            if e["name"] == "process_name"] == ["repro_torch"]
    counts, rcounts = validate_chrome_trace(got), \
        ref_obs.validate_chrome_trace(want)
    assert counts["M"] == rcounts["M"] + len(PORT_COMPONENTS)
    assert {**counts, "M": 0} == {**rcounts, "M": 0}


def test_summaries_and_rollup_equal_reference():
    recs = (SpanRecorder(), ref_obs.SpanRecorder())
    for rec in recs:
        for i in range(5):
            rec.add_span("admission", "server", 0.0, 0.001 * (i + 1))
            rec.add_span("query", "server", 0.0, 0.1, label="bfs",
                         bucket=4, status="ok" if i % 2 else "shed",
                         latency_s=0.01 * i)
        rec.add_span("chunk", "recovery", 0.0, 0.25, phase=0)
        rec.event("rollback", "recovery", phase=0)
    assert trace_summary(recs[0]) == ref_obs.trace_summary(recs[1])
    assert derive_latency_cells(recs[0]) \
        == ref_obs.derive_latency_cells(recs[1])
    arr = np.zeros((5, 3), np.float32)
    arr[:4, 0] = 1.0
    arr[3, 1] = 1.0
    arr[:4, 2] = [3e-1, 2e-2, 1e-4, 0.0]
    wire = {"round/sum": {"bytes": 64, "taps": 1},
            "init/bcast": {"bytes": 16, "taps": 1}}
    got = RunTelemetry(PhaseSeries.from_array(arr, ("err",)), wire, 0.02)
    want = ref_obs.RunTelemetry(
        ref_obs.PhaseSeries.from_array(arr, ("err",)), wire, 0.02)
    assert got.summary() == want.summary()


# -- engine telemetry end to end -----------------------------------------


@pytest.mark.parametrize("algo,variant", registry.available())
def test_telemetry_on_is_bit_identical_to_off(engines, algo, variant):
    spec = registry.get_spec(algo, variant)
    for parts, eng in engines.items():
        what = f"{algo}/{variant} parts={parts}"
        garr = eng.device_graph()
        args = _args(eng, spec)
        off = eng.program(algo, variant)
        on = eng.program(algo, variant, telemetry=True)
        with _Items() as s_off:
            *outs, rounds = off(garr, *args)
        with _Items() as s_on:
            res = on(garr, *args)
        assert len(res) == len(outs) + 2, what    # trailing series
        *touts, trounds, series = res
        assert trounds == rounds, what
        for a, b in zip(outs, touts):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), what
            else:
                assert a == b, what
        assert s_on.count == s_off.count, what   # no extra host sync
        assert isinstance(series, np.ndarray) \
            and series.dtype == np.float32, what
        tel = on.run_telemetry(series)
        assert tel.series.rounds == rounds, what
        assert tel.series.probe_names == on.program.probe_names
        assert on.last_wall_s > 0.0 and tel.wall_s == on.last_wall_s
        summ = tel.summary()
        assert summ["rounds"] == rounds and "wall_ms" in summ, what
        if parts > 1 and algo != "triangles" and rounds:
            assert sum(tel.wire_bytes_by_op().values()) > 0, what


def test_telemetry_series_of_bfs_fast(eng):
    garr = eng.device_graph()
    on = eng.program("bfs", "fast", telemetry=True)
    *_, rounds, series = on(garr, ROOT)
    tel = on.run_telemetry(series)
    assert tel.series.rounds == rounds > 0
    assert tel.series.halt()[-1] == 1.0      # converged, not round-capped
    assert np.all(tel.series.halt()[:-1] == 0.0)
    assert tel.series.probe_names == ("frontier",)
    assert tel.series.probe("frontier")[0] >= 1.0
    assert tel.series.probe("frontier")[-1] == 0.0
    assert np.all(series[rounds:] == 0.0)    # unwritten rows stay zero


def test_measured_wire_is_the_calls_tally(engines):
    """The telemetry build's record is the difference of the engine's
    cumulative tallies across the call: exact totals, per-round cells,
    and the tallies themselves stay cumulative."""
    eng = engines[4]
    garr = eng.device_graph()
    for algo, variant, args in (("bfs", "fast", (ROOT,)),
                                ("pagerank", "fast", ()),
                                ("betweenness", "default", (ROOT,))):
        on = eng.program(algo, variant, telemetry=True)
        eng.comm.reset_wire()
        *_, rounds, series = on(garr, *args)
        first = dict(eng.comm.wire)
        on(garr, *args)
        assert eng.comm.wire == {k: 2 * b for k, b in first.items()}
        tel = on.run_telemetry(series)
        loop = sum(b for (ph, _), b in first.items() if ph == "round")
        assert tel.loop_bytes == on.wire.loop_bytes == loop
        assert tel.wire_bytes_by_op() == {
            op: b // rounds for (ph, op), b in first.items()
            if ph == "round"}
        oneshot = sum(b for (ph, _), b in first.items() if ph != "round")
        assert tel.summary()["wire_bytes_total"] == loop + oneshot
    eng.comm.reset_wire()


def test_telemetry_is_a_cache_dimension(eng):
    off = eng.program("bfs", "fast")
    on = eng.program("bfs", "fast", telemetry=True)
    assert on is not off and on.telemetry and not off.telemetry
    assert eng.program("bfs", "fast", telemetry=True) is on
    assert eng.program("bfs", "fast") is off
    assert eng.program("bfs", "fast", telemetry=True, guard=True) \
        is not on


def test_telemetry_composition_rules(eng):
    with pytest.raises(ValueError):
        eng.program("pagerank", "bsp", telemetry=True, static_iters=4)
    with pytest.raises(ValueError):
        eng.program("bfs", "fast", telemetry=True, batch=4)
    with pytest.raises(ValueError):
        eng.program("bfs", "fast").run_telemetry(None)
    prog = eng.program("bfs", "fast").program
    with pytest.raises(ValueError):
        run_program(prog, eng.device_graph(), ROOT, static_iters=3,
                    telemetry=True)


@pytest.mark.parametrize("algo,variant,args", [
    ("bfs", "fast", (ROOT,)), ("pagerank", "async", ()),
    ("betweenness", "default", (ROOT,))])
def test_guard_with_telemetry(engines, algo, variant, args):
    """A guarded telemetry build: ``(*outputs, rounds, ok, series)``, the
    plain telemetry build's bits and rows, ok 1."""
    eng = engines[2]
    garr = eng.device_graph()
    *outs, rounds, series = eng.program(algo, variant, telemetry=True)(
        garr, *args)
    *gouts, grounds, ok, gseries = eng.program(
        algo, variant, telemetry=True, guard=True)(garr, *args)
    assert ok == 1 and grounds == rounds
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(outs, gouts))
    np.testing.assert_array_equal(gseries, series)


def test_phased_probe_names_must_agree(eng):
    prog = eng.program("betweenness").program
    assert isinstance(prog, PhasedProgram) and prog.probe_names == ()
    fwd, bwd = prog.phases
    bad = dataclasses.replace(prog, phases=(
        fwd, dataclasses.replace(bwd, probe_names=("x",),
                                 probe=lambda s: (0,))))
    with pytest.raises(ValueError, match="probe_names"):
        bad.probe_names
    with pytest.raises(ValueError, match="probe_names"):
        run_program(bad, eng.device_graph(), ROOT, telemetry=True)
    wrong = dataclasses.replace(fwd, probe_names=("a", "b"),
                                probe=lambda s: (1,))
    with pytest.raises(ValueError, match="probe"):
        run_program(wrong, eng.device_graph(), ROOT, telemetry=True)
    # a probe must hand over a host number, never a tensor to read
    synced = dataclasses.replace(fwd, probe_names=("a",),
                                 probe=lambda s: (s[0].sum(),))
    with pytest.raises(TypeError, match="host numbers"):
        run_program(synced, eng.device_graph(), ROOT, telemetry=True)


def test_snapshot_copies_the_series():
    series = np.zeros((4, 3), np.float32)
    carry = (torch.zeros(3), (), 2, True, series)
    snap = _copy(carry, "cpu")
    series[0] = 1.0
    assert snap[4] is not series and not snap[4].any()
    back = _copy(snap, "cpu")
    back[4][1] = 2.0
    assert not snap[4].any()


# -- CheckpointRunner with telemetry and spans ---------------------------


@pytest.mark.parametrize("algo,variant,args,sched", [
    ("bfs", "fast", (ROOT,), "corrupt@r2p0:min seed=7"),
    ("pagerank", "fast", (), "drop@r1p0 corrupt@r2p1 stall@r3p0x2 seed=7"),
    ("betweenness", "default", (ROOT,),
     "drop@r1p0 corrupt@r2p1 stall@r3p0x2 seed=7"),
    ("bfs", "async", (ROOT,), "drop@r1p0 corrupt@r2p1 stall@r3p0x2 seed=7"),
])
def test_checkpoint_runner_obs_events_and_telemetry(engines, algo, variant,
                                                    args, sched):
    eng = engines[2]
    garr = eng.device_graph()
    tprog = eng.program(algo, variant, telemetry=True)
    *outs, rounds, series = tprog(garr, *args)
    clean = tprog.run_telemetry(series)
    rec = SpanRecorder()
    runner = CheckpointRunner(eng, algo, variant, checkpoint_every=2,
                              faults=sched, telemetry=True, obs=rec)
    with recording(rec):
        rep = runner.run(garr, *args)
    assert rep.recoveries >= 1
    events = rec.events()
    kinds = [e.kind for e in events]
    assert kinds.count("fault_detection") == len(rep.detections)
    assert kinds.count("rollback") == rep.recoveries
    assert kinds.count("checkpoint") == rep.checkpoints
    assert [e.args["round"] for e in events
            if e.kind == "fault_detection"] == list(rep.detections)
    assert all(e.component == "recovery" for e in events)
    chunks = [s for s in rec.spans() if s.kind == "chunk"]
    assert chunks and all(s.component == "recovery" for s in chunks)
    assert all(s.args["to_round"] >= s.args["from_round"] for s in chunks)
    # the series rolled back with the carry: the clean run's rows, no
    # rows of discarded chunks, and the recovered outputs are the clean
    # bits
    assert rep.telemetry is not None
    assert rep.telemetry["rounds"] == rep.rounds == rounds
    summ = clean.summary()
    for key in summ:
        if key not in ("wall_ms", "round_ms_mean", "wire_bytes_total"):
            assert rep.telemetry[key] == summ[key], key
    assert all(torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
               for a, b in zip(rep.outputs, outs))
    # the run's measured rounds: at least the clean run's (rolled-back
    # rounds run again), each inside a chunk
    rounds_run = [s for s in rec.spans() if s.kind == "round"]
    assert len(rounds_run) >= rounds
    assert all(any(c.t0 <= s.t0 and s.t1 <= c.t1 for c in chunks)
               for s in rounds_run)
    validate_chrome_trace(chrome_trace(rec.spans(), rec.events()))


def test_checkpoint_runner_series_equals_clean_rows(engines):
    """The recovered series, row for row, against the clean run's, with
    the rows' host numbers those of the plain run's states."""
    eng = engines[4]
    garr = eng.device_graph()
    tprog = eng.program("pagerank", "fast", telemetry=True)
    *_, rounds, series = tprog(garr)
    runner = CheckpointRunner(eng, "pagerank", "fast", checkpoint_every=2,
                              faults="drop@r1p0 corrupt@r2p1 seed=7",
                              telemetry=True, keep_history=True)
    rep = runner.run(garr)
    assert rep.recoveries >= 1
    got = rep.history[-1].carry[4]
    np.testing.assert_array_equal(got, series)
    # a snapshot's series is its own copy: the next chunk's rows are not
    # in it
    mid = rep.history[1]
    assert mid.rounds > 0 and (mid.carry[4][:mid.rounds, 0] == 1.0).all()
    assert not mid.carry[4][mid.rounds:].any()
    assert rounds == rep.rounds


def test_checkpoint_runner_untraced_records_nothing(eng):
    runner = CheckpointRunner(eng, "bfs", "fast", checkpoint_every=2)
    assert runner.obs is NULL_RECORDER
    rep = runner.run(eng.device_graph(), ROOT)
    assert rep.telemetry is None
    assert NULL_RECORDER.spans() == [] and NULL_RECORDER.events() == []


# -- layer spans: the analytics path's sites -----------------------------


def test_recording_nests_and_restores():
    outer, inner = SpanRecorder(), SpanRecorder()
    with recording(outer):
        with span("call", "engine"):
            with recording(inner), span("round", "engine"):
                pass
        with span("outputs", "engine"):
            pass
    with span("init", "engine"):        # nothing current: not recorded
        pass
    assert [s.kind for s in outer.spans()] == ["call", "outputs"]
    assert [(s.kind, s.component) for s in inner.spans()] == [
        ("round", "engine")]
    assert obs_spans._recorder is NULL_RECORDER


def test_spanned_wraps_the_function():
    @spanned("exchange_or", "comm")
    def exchange(x, *, words=False):
        """doc"""
        if x is None:
            raise ZeroDivisionError
        return x + 1, words

    rec = SpanRecorder()
    assert exchange(1, words=True) == (2, True)
    with recording(rec):
        assert exchange(2) == (3, False)
        with pytest.raises(ZeroDivisionError):
            exchange(None)
    assert exchange.__name__ == "exchange" and exchange.__doc__ == "doc"
    ok, failed = rec.spans()
    assert (ok.kind, ok.component) == ("exchange_or", "comm")
    assert ok.args == {} and failed.args == {"error": "ZeroDivisionError"}


@pytest.mark.parametrize("algo,variant", registry.available())
def test_spans_on_are_bit_identical_to_off(engines, algo, variant):
    """A call with a recorder on gives the off call's outputs and rounds
    bit for bit, with the same ``Tensor.item`` count, and records one
    ``call`` span and a ``round`` span a round."""
    spec = registry.get_spec(algo, variant)
    for parts, eng in engines.items():
        what = f"{algo}/{variant} parts={parts}"
        garr = eng.device_graph()
        args = _args(eng, spec)
        prog = eng.program(algo, variant)
        with _Items() as s_off:
            *outs, rounds = prog(garr, *args)
        rec = SpanRecorder()
        with _Items() as s_on, recording(rec):
            *touts, trounds = prog(garr, *args)
        assert trounds == rounds, what
        for a, b in zip(outs, touts):
            if isinstance(a, torch.Tensor):
                assert a.dtype == b.dtype and torch.equal(a, b), what
            else:
                assert a == b, what
        assert s_on.count == s_off.count, what
        kinds = [s.kind for s in rec.spans()]
        assert kinds.count("call") == 1, what
        assert kinds.count("round") == rounds, what
        assert set(kinds) <= set(SPAN_KINDS), what
        assert rec.dropped_spans == 0, what


class _Ranges:
    """Counts the profiler ranges entered while active, through the hook
    the sites call and torch's own ``record_function``."""

    def __enter__(self):
        self.names, self._prev = [], obs_spans._open_range
        self._rf = torch.profiler.record_function
        prev = self._prev

        def counted(name):
            self.names.append(name)
            return prev(name)

        def counted_rf(name, *a, **k):
            self.names.append(name)
            return self._rf(name, *a, **k)

        obs_spans._open_range = counted
        torch.profiler.record_function = counted_rf
        torch.autograd.profiler.record_function = counted_rf
        return self

    def __exit__(self, *exc):
        obs_spans._open_range = self._prev
        torch.profiler.record_function = self._rf
        torch.autograd.profiler.record_function = self._rf


def test_sites_enter_no_profiler_range_when_off(engines):
    """With no recorder and no profiler, a call enters no profiler range:
    the sites read their flags and return."""
    eng = engines[4]
    garr = eng.device_graph()
    for algo, args in (("bfs", (ROOT,)), ("pagerank", ())):
        prog = eng.program(algo, "fast")
        with _Ranges() as off:
            prog(garr, *args)
        assert off.names == [], algo
        with _Ranges() as on, torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            prog(garr, *args)
        assert "repro_torch.engine.call" in on.names, algo


@pytest.mark.parametrize("algo,kinds", [
    ("bfs", {"engine.call", "engine.init", "engine.round",
             "engine.outputs", "bfs.push", "bfs.pull",
             "localops.scatter_combine", "localops.frontier_pull",
             "comm.exchange_or", "comm.broadcast_global",
             "comm.psum_scalar"}),
    ("pagerank", {"engine.call", "engine.init", "engine.round",
                  "engine.outputs", "localops.scatter_combine",
                  "comm.exchange_sum", "comm.psum_scalar"})])
def test_profiler_ranges_of_the_fast_programs(engines, algo, kinds):
    """Under ``torch.profiler`` on the CPU, bfs/fast and pagerank/fast
    name their layers ``repro_torch.<component>.<kind>``: one
    ``engine.round`` a round, and in BFS a push or a pull level each."""
    from collections import Counter
    eng = engines[4]
    garr = eng.device_graph()
    prog = eng.program(algo, "fast", direction="adaptive") \
        if algo == "bfs" else eng.program(algo, "fast")
    args = (ROOT,) if algo == "bfs" else ()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        *_, rounds = prog(garr, *args)
    names = Counter(e.name[len("repro_torch."):] for e in prof.events()
                    if e.name.startswith("repro_torch."))
    assert set(names) == kinds
    assert names["engine.call"] == names["engine.init"] \
        == names["engine.outputs"] == 1
    assert names["engine.round"] == rounds > 0
    if algo == "bfs":
        assert names["bfs.push"] + names["bfs.pull"] == rounds
        assert names["bfs.push"] >= 1 and names["bfs.pull"] >= 1


def test_launcher_trace_out_measures_rounds(tmp_path, capsys):
    """``--trace-out``: the telemetry runs' measured layer spans, a
    ``round`` span a round of every program, validated on disk."""
    from repro_torch.launch import graph_analytics
    path = tmp_path / "engine.json"
    results = graph_analytics.run("urand12", 2, device="cpu", pr_iters=20,
                                  verify=False, trace_out=str(path))
    out = capsys.readouterr().out
    trace = json.loads(path.read_text())
    counts = validate_chrome_trace(trace)
    evs = trace["traceEvents"]
    rounds = [e for e in evs if e["ph"] == "X" and e["name"] == "round"]
    calls = [e for e in evs if e["ph"] == "X" and e["name"] == "call"]
    assert len(calls) == len(results) > 0
    assert len(rounds) == sum(r[0][-1] for r in results.values())
    # measured, not splayed: the rounds of a call are not all one length
    assert len({e["dur"] for e in rounds}) > 1
    assert all(e["tid"] == list(COMPONENTS).index("engine") for e in rounds)
    assert "engine_round" not in {e.get("name") for e in evs}
    assert f"wrote {path}" in out and counts["X"] == sum(
        e["ph"] == "X" for e in evs)

