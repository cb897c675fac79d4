"""The serving tests of tests/test_obs.py against the port: percentile
semantics of ``serve/metrics.py``, a traced serve session whose spans
reconcile exactly with ``ServeMetrics`` (parts 1 and, as the
reference's multi-device acceptance drill, parts 2 with the answers held
to the NumPy oracle), each with a mutation recording its span, the
durability spans (``wal_append``, ``snapshot``) and the recovery span,
and the untraced server recording nothing."""

import numpy as np
import pytest
import torch

import oracle
from repro_torch.core import GraphEngine, partition_graph
from repro_torch.graphs import urand_edges
from repro_torch.obs import NULL_RECORDER, SpanRecorder, chrome_trace, \
    derive_latency_cells, trace_summary, validate_chrome_trace
from repro_torch.serve import GraphServer
from repro_torch.serve.metrics import ServeMetrics, percentiles

N, E = 256, 2048
STAGES = {"admission", "validate", "coalesce_wait", "dispatch", "device",
          "demux", "query"}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def eng():
    edges = urand_edges(N, E, seed=11)
    return GraphEngine(partition_graph(edges, N, parts=1), device="cpu")


# -- percentile semantics (serve/metrics.py) -----------------------------


def test_percentiles_empty_cell_is_zero_not_nan():
    assert percentiles([]) == (0.0, 0.0, 0.0)


def test_percentiles_single_sample_is_that_sample():
    assert percentiles([0.25]) == (0.25, 0.25, 0.25)


def test_percentiles_two_samples_interpolate():
    p50, p95, p99 = percentiles([0.1, 0.3])
    assert p50 == pytest.approx(0.2)        # midpoint, by construction
    assert p95 == pytest.approx(0.1 + 0.95 * 0.2)
    assert p99 == pytest.approx(0.1 + 0.99 * 0.2)
    assert p50 < p95 < p99 <= 0.3


def test_metrics_rows_small_sample_cells():
    m = ServeMetrics()
    assert m.rows() == []                   # no cells -> no rows
    m.record("bfs_fast", 4, 0.010)
    (row,) = m.rows()
    assert row["count"] == 1
    assert row["p50_ms"] == row["p95_ms"] == row["p99_ms"] == 10.0
    m.record("bfs_fast", 4, 0.030)
    (row,) = m.rows()
    assert row["count"] == 2 and row["p50_ms"] == 20.0
    assert row["p50_ms"] < row["p95_ms"] < row["p99_ms"] <= 30.0


# -- traced serving path --------------------------------------------------


def _traced_session(eng, roots, bucket):
    rec = SpanRecorder()
    server = GraphServer(eng, buckets=(bucket,), obs=rec)
    qids = [server.submit("bfs", root=r) for r in roots]
    qids.append(server.submit("pagerank"))
    server.drain()
    results = [server.results.pop(q) for q in qids]
    assert all(r.status == "ok" for r in results), \
        [r.status for r in results]
    spans = rec.spans()
    assert STAGES <= {s.kind for s in spans}
    # one query span per resolved query, one admission per submit
    assert sum(s.kind == "query" for s in spans) == len(qids)
    assert sum(s.kind == "admission" for s in spans) == len(qids)
    # THE reconciliation contract: latency cells derived from query
    # spans equal ServeMetrics' cells exactly (same floats, same order)
    assert derive_latency_cells(rec) == server.metrics.latencies()
    return rec, server, results


def test_traced_serve_spans_reconcile_with_metrics():
    # its own engine: the mutation below writes the graph's mirrors
    eng = GraphEngine(partition_graph(urand_edges(N, E, seed=11), N,
                                      parts=1), device="cpu")
    rec, server, results = _traced_session(eng, range(5), 4)
    # a mutation records its span with the new epoch
    dels = server.dynamic_graph().sample_deletable(
        8, np.random.default_rng(0))
    stats = server.mutate(deletes=dels)
    (msp,) = [s for s in rec.spans() if s.kind == "mutation"]
    assert msp.args["epoch"] == server.epoch == 1
    assert msp.args["n_delete"] == stats.n_delete >= 1
    # a rejected admission leaves an event, not a span
    with pytest.raises(ValueError):
        server.submit("bfs", root=10 ** 9)
    assert any(e.kind == "rejected" for e in rec.events())
    # the recorder exports to a schema-valid trace
    trace = chrome_trace(rec.spans(), rec.events())
    counts = validate_chrome_trace(trace)
    assert counts["b"] == counts["e"] >= len(results)
    summ = trace_summary(rec)
    assert summ["spans_per_kind"]["query"] == len(results)
    assert summ["dropped_spans"] == 0 and summ["dropped_events"] == 0
    assert summ["top_p99_ms"]


def test_untraced_server_records_nothing(eng):
    server = GraphServer(eng, buckets=(4,))
    assert server.obs is NULL_RECORDER
    qid = server.submit("bfs", root=1)
    server.drain()
    assert server.results.pop(qid).status == "ok"
    assert NULL_RECORDER.spans() == [] and NULL_RECORDER.events() == []


def test_traced_serve_acceptance_parts2():
    """The reference's parts=2 traced serve drill: answers stay
    oracle-correct under tracing, every pipeline stage and a mutation
    leave spans, the latency cells reconcile exactly, and the Chrome
    export passes the schema validator."""
    n, parts = 384, 2
    edges = urand_edges(n, 8 * n, seed=5)       # oracle's urand family
    eng2 = GraphEngine(partition_graph(edges, n, parts), device="cpu")
    rec, server, results = _traced_session(eng2, range(12), 8)
    oracle.check_conformance("bfs", "fast", dict(results[0].fields),
                             edges, n, 0)
    oracle.check_conformance("pagerank", "fast", dict(results[-1].fields),
                             edges, n, 0)
    # mutation under tracing
    server.mutate(deletes=server.dynamic_graph().sample_deletable(
        8, np.random.default_rng(1)))
    assert "mutation" in {s.kind for s in rec.spans()}
    assert derive_latency_cells(rec) == server.metrics.latencies()
    counts = validate_chrome_trace(chrome_trace(rec.spans(), rec.events()))
    assert counts["b"] == counts["e"] >= len(results)
    summ = trace_summary(rec)
    assert summ["spans_per_kind"]["query"] == len(results)
    assert summ["dropped_spans"] == 0
    np.testing.assert_array_equal(
        [r.bucket for r in results], [8] * 12 + [0])


def test_durability_and_recovery_spans(tmp_path):
    eng2 = GraphEngine(partition_graph(urand_edges(128, 512, seed=3), 128,
                                       parts=1), device="cpu")
    rec = SpanRecorder()
    server = GraphServer(eng2, buckets=(4,), persistence=str(tmp_path),
                         obs=rec)
    dels = server.dynamic_graph().sample_deletable(
        4, np.random.default_rng(2))
    server.mutate(deletes=dels)
    server.durability.snapshot_now(server)
    kinds = {s.kind for s in rec.spans()}
    assert {"mutation", "wal_append", "snapshot"} <= kinds
    (wsp,) = [s for s in rec.spans() if s.kind == "wal_append"]
    assert wsp.component == "durability" and wsp.args["epoch"] == 1

    rec2 = SpanRecorder()
    srv2 = GraphServer.recover(tmp_path, device="cpu", buckets=(4,),
                               obs=rec2)
    (rsp,) = [s for s in rec2.spans() if s.kind == "recovery"]
    assert rsp.args["epoch"] == srv2.epoch == 1
    # the recovered server's durability path stays instrumented
    dels2 = srv2.dynamic_graph().sample_deletable(
        4, np.random.default_rng(3))
    srv2.mutate(deletes=dels2)
    assert any(s.kind == "wal_append" for s in rec2.spans())
