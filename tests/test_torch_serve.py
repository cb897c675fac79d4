"""The port's query server (``repro_torch.serve``) and its launcher.

  * Ports of tests/test_serve.py (its mutation test is in
    test_torch_dynamic.py): coalescer and executor units, the cache identity the
    bucket ladder relies on, served-equals-direct bit for bit for every
    registered pair, resilience (validation, deadlines, shedding,
    retry/quarantine); the executor's failure tests patch the port's
    ``_block`` where the reference's patch ``jax.block_until_ready``.
  * Against the JAX package's server: one fixed query list covering all
    sixteen pairs plus the three seeded programs from warm seeds, at
    parts 1 and 2 on the reference fixture's graph (urand 768 x 6144,
    seed 13, buckets (4,)), the reference in one multi-device
    subprocess.  Statuses, buckets, epochs and rounds are equal, integer
    fields bit-identical, float fields within FLOAT_TOL (the tolerances
    of the port's program-parity tests for those programs).  The
    workload generator's traces equal the reference's; GraphEngine's
    thin wrappers give the reference's outputs.
  * The batched runner's duplicate lanes (one run per distinct root),
    and the launcher's CLI: its --json payload, and a replay under a
    mutation stream with a WAL directory then a --recover run, against
    the JAX package's launcher on the same arguments.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import oracle
from conftest import REPO, SRC, run_with_devices
from repro.serve import workload as ref_workload
import repro_torch.serve.executor as executor_mod
from repro_torch.core import GraphEngine, incremental, partition_graph, \
    registry, superstep
from repro_torch.graphs import urand_edges
from repro_torch.serve import (
    BucketLadder,
    Coalescer,
    DoubleBufferedExecutor,
    GraphServer,
    Query,
    ServeMetrics,
    make_key,
    parse_mix,
    query,
    synthetic_trace,
    validate_query,
    zipf_root_sampler,
)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ALL_PAIRS = sorted(registry.available())
N, E, SEED = 768, 6144, 13

# float fields against the reference: (algo, variant, field) -> (rtol,
# atol) of the port's program-parity tests.  pagerank ranks: 1e-5
# relative to the largest (test_torch_programs) but 1e-4 where bf16
# compression is on by default (pagerank/fast) and for the async and
# warm programs (oracle.ASYNC_PR_REL_TOL, test_torch_incremental);
# pagerank's err: float32 sums in torch's order against XLA's
# (test_torch_obs_parity's ERR_RTOL); betweenness sigma and bc
# (test_torch_bsp_suite).  Every other field is compared bit for bit.
RANK_REL = {"bsp": 1e-5, "fast": 1e-4, "async": oracle.ASYNC_PR_REL_TOL,
            "warm": 1e-4}
FLOAT_TOL = {("pagerank", v, "err"): (1e-6, 0.0) for v in RANK_REL}
FLOAT_TOL[("betweenness", "default", "sigma")] = (1e-6, 0.0)
FLOAT_TOL[("betweenness", "default", "bc")] = (1e-4, 1e-4)

SEEDED = [p for p in ALL_PAIRS
          if registry.get_spec(*p).incremental is not None]
# the fixed query list, served in two calls: every pair (rooted pairs at
# roots 7 and 300, coalesced into one padded bucket-4 launch; seeded
# pairs from explicit cold seeds), then the seeded pairs from the warm
# seeds the first call's refreshes left in the seed store
CALLS = (
    [(a, v, root, "cold" if (a, v) in SEEDED else None)
     for a, v in ALL_PAIRS
     for root in ((7, 300) if registry.get_spec(a, v).inputs
                  and (a, v) not in SEEDED else (None,))],
    [(a, v, None, "warm") for a, v in SEEDED],
)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the
    test workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _engine(parts):
    edges = urand_edges(N, E, seed=SEED)
    return GraphEngine(partition_graph(edges, N, parts), device="cpu")


@pytest.fixture(scope="module")
def served():
    eng = _engine(1)
    server = GraphServer(eng, buckets=(4,))
    return N, eng, eng.device_graph(), server


def _direct(eng, garr, prog, *args) -> tuple[dict, int]:
    """A direct call's fields as the server demuxes them."""
    *outs, rounds = prog(garr, *args)
    p = prog.program
    return {name: (eng.gather_vertex_field(o) if isv
                   else np.asarray(o)[()])
            for name, isv, o in zip(p.output_names, p.output_is_vertex,
                                    outs)}, rounds


# -- coalescer -----------------------------------------------------------


def test_bucket_ladder_pick():
    ladder = BucketLadder((1, 8, 32, 128))
    assert [ladder.pick(k) for k in (1, 2, 8, 9, 32, 129, 500)] == \
        [1, 8, 8, 32, 32, 128, 128]
    with pytest.raises(ValueError):
        BucketLadder(())
    with pytest.raises(ValueError):
        BucketLadder((0, 8))


def test_coalescer_packs_and_pads():
    co = Coalescer(BucketLadder((1, 4)))
    for root in (5, 6, 7):
        co.admit(Query(make_key("bfs"), root))
    co.admit(Query(make_key("pagerank")))
    co.admit(Query(make_key("pagerank")))
    assert co.pending_count() == 5
    b1 = co.next_batch()                   # bfs queries are oldest
    assert b1.key.label == "bfs_fast" and b1.bucket == 4
    assert b1.n_real == 3 and b1.roots == [5, 6, 7, 7]   # dup-root padding
    b2 = co.next_batch()                   # both refreshes share one launch
    assert b2.key.label == "pagerank_fast" and b2.bucket == 0
    assert b2.n_real == 2 and b2.roots == []
    assert co.next_batch() is None and not co.has_pending()


def test_coalescer_overflow_chunks_at_top_bucket():
    co = Coalescer(BucketLadder((1, 4)))
    for root in range(11):
        co.admit(Query(make_key("sssp"), root))
    sizes = []
    while co.has_pending():
        b = co.next_batch()
        sizes.append((b.bucket, b.n_real))
    assert sizes == [(4, 4), (4, 4), (4, 3)]


def test_query_validation():
    with pytest.raises(ValueError, match="needs root"):
        query("bfs")
    with pytest.raises(ValueError, match="no per-query inputs"):
        query("pagerank", root=3)
    with pytest.raises(KeyError, match="registered programs"):
        query("nope", root=3)
    with pytest.raises(TypeError, match="unknown params"):
        query("bfs", root=3, bogus=1)


# -- executor ------------------------------------------------------------


def test_executor_depth_and_order():
    ex = DoubleBufferedExecutor(depth=2)
    assert ex.push("a", torch.zeros(4)) == []
    assert ex.push("b", torch.zeros(4)) == []        # 2 in flight: no block
    done = ex.push("c", torch.zeros(4))              # full: retires oldest
    assert [l.payload for l in done] == ["a"]
    assert [l.payload for l in ex.drain()] == ["b", "c"]
    assert len(ex) == 0 and ex.complete_one() is None
    with pytest.raises(ValueError):
        DoubleBufferedExecutor(depth=0)


def test_executor_depth_one_is_synchronous():
    """depth=1 degenerates to a one-slot pipeline: every push retires
    the previous launch, drain retires exactly the last one, and no
    launch is ever dangling."""
    ex = DoubleBufferedExecutor(depth=1)
    assert ex.push("a", torch.zeros(2)) == []        # first fills the slot
    assert [l.payload for l in ex.push("b", torch.zeros(2))] == ["a"]
    assert [l.payload for l in ex.push("c", torch.zeros(2))] == ["b"]
    assert len(ex) == 1
    assert [l.payload for l in ex.drain()] == ["c"]
    assert len(ex) == 0 and ex.drain() == []


def test_executor_records_no_event_for_host_outputs():
    """CPU outputs are computed when the dispatch returns: the launch
    carries no CUDA event and completing it waits on nothing."""
    ex = DoubleBufferedExecutor(depth=2)
    ex.push("a", (torch.zeros(3), [1, 2], 4))
    (launch,) = ex.drain()
    assert launch.event is None and launch.error is None
    assert launch.t_done >= launch.t_dispatch and launch.seq == 0


def test_pump_on_empty_queue_is_a_noop(served):
    """pump() with nothing admitted must not launch, block, or record."""
    _, eng, _, _ = served
    server = GraphServer(eng, buckets=(4,))
    assert server.pump() == []
    assert not server.results and len(server.executor) == 0
    assert server.metrics.rows() == []


def test_drain_after_mixed_submit_pump_interleave(served):
    """Interleaved submit/pump/submit/drain resolves every qid in
    submission order with no in-flight launch left behind."""
    _, eng, _, _ = served
    server = GraphServer(eng, buckets=(4,), depth=2)
    q1 = server.submit("bfs", root=1)
    q2 = server.submit("cc")
    server.pump()                          # launches something
    q3 = server.submit("sssp", root=2)
    q4 = server.submit("bfs", root=5)
    server.drain()
    assert sorted(server.results) == sorted([q1, q2, q3, q4])
    assert len(server.executor) == 0, "dangling in-flight launch"
    assert not server.coalescer.has_pending()
    assert server.results[q1].key.label == "bfs_fast"
    assert server.results[q3].key.label == "sssp"
    for qid in (q1, q2, q3, q4):
        server.results.pop(qid)


def test_metrics_window_opens_at_admission(served):
    """The qps window includes the first query's queue wait: submit
    (admission) opens the window."""
    _, eng, _, _ = served
    server = GraphServer(eng, buckets=(4,))
    server.submit("cc")
    time.sleep(0.05)                       # queued, nothing launched yet
    server.drain()
    assert server.metrics.window_s >= 0.05, \
        "metrics window missed the pre-launch queue wait"
    server.results.clear()
    m = ServeMetrics()                     # a bare record() self-opens
    m.record("x", 0, 0.001)
    assert 0 < m.window_s < 10


# -- the program cache the ladder relies on ------------------------------


def test_batch_defaults_pin_pull(served):
    """Batched builds merge ProgramSpec.batch_defaults (bfs/fast pins
    direction='pull'); an explicit caller param resolves to the SAME
    cache entry, and overriding it back to adaptive is a distinct one
    with bit-identical parents."""
    _, eng, garr, _ = served
    auto = eng.program("bfs", "fast", batch=4)
    assert eng.program("bfs", "fast", batch=4, direction="pull") is auto
    adaptive = eng.program("bfs", "fast", batch=4, direction="adaptive")
    assert adaptive is not auto
    roots = [1, 5, 9, 700]
    assert torch.equal(auto(garr, roots)[0], adaptive(garr, roots)[0])
    single = eng.program("bfs", "fast")
    assert single is eng.program("bfs", "fast", direction="adaptive")


def test_bucket_ladder_no_rebuild(served):
    """Every ladder rung resolves to the SAME cached CompiledProgram on
    every launch, and launching builds nothing new: the property that
    makes coalesced serving free of per-launch builds."""
    _, eng, garr, _ = served
    progs = {b: eng.program("bfs", "fast", batch=b) for b in (1, 4, 8)}
    size = len(eng._cache)
    for bucket, prog in progs.items():
        roots = list(range(bucket))
        prog(garr, roots)
        prog(garr, [r + 1 for r in roots])     # fresh operands
        assert eng.program("bfs", "fast", batch=bucket) is prog
    assert len(eng._cache) == size, "launching built a program"


# -- end-to-end conformance ----------------------------------------------


@pytest.mark.parametrize("algo,variant", ALL_PAIRS)
def test_served_matches_direct(served, algo, variant):
    """A served query's fields are bit-identical to a direct
    engine.program() call, for every registered pair.  Source queries
    ride a padded batch=4 launch (batched bfs/fast compares with a
    direction='pull' run, what its batch build pins); refresh and
    seeded queries ride unbatched bucket-0 launches, the seeded ones
    from an EXPLICIT cold seed."""
    _, eng, garr, server = served
    spec = registry.get_spec(algo, variant)
    key = make_key(f"{algo}/{variant}")
    params = {}
    if key.seeded:
        (seed_arr,) = incremental.cold_seed(spec, eng.g)
        q = Query(key, seed=(seed_arr,))
        extra = (eng.scatter_vertex_field(
            seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]),)
    else:
        root = 7 if spec.inputs else None
        q = Query(key, root)
        extra = (root,) if spec.inputs else ()
        if key.rooted:
            params = spec.batch_defaults
    res = server.serve([q])[0]
    assert res.ok and res.epoch == 0
    assert res.bucket == (4 if key.rooted else 0)
    assert res.rounds > 0
    prog = eng.program(algo, variant, **params)
    want, rounds = _direct(eng, garr, prog, *extra)
    assert res.rounds == rounds
    assert set(res.fields) == set(want)
    for name, w in want.items():
        np.testing.assert_array_equal(
            res[name], w,
            err_msg=f"{algo}/{variant} field {name!r}: served != direct")


def test_refresh_queries_share_one_launch(served):
    """Concurrent refresh queries of one key are deduplicated into a
    single launch whose result every query shares."""
    _, _, _, server = served
    a, b = server.serve([query("cc"), query("cc")])
    assert a.bucket == b.bucket == 0
    assert a.fields is b.fields            # same launch, shared demux


def test_resubmitting_a_stamped_query_is_rejected(served):
    """submit stamps the Query object in place; submitting the same
    object twice would re-stamp it and orphan the first result."""
    _, _, _, server = served
    q = query("bfs", root=2)
    with pytest.raises(ValueError, match="already admitted"):
        server.serve([q, q])
    server.drain()                         # flush the first admission
    server.results.pop(q.qid, None)


def test_serve_collects_results_from_mailbox(served):
    """serve() pops what it returns: a long-running server must not
    accumulate every (n_orig,)-field result forever."""
    _, _, _, server = served
    res = server.serve([query("bfs", root=2), query("cc")])
    assert all(r.qid not in server.results for r in res)


def test_warmup_mid_traffic_demuxes_inflight(served):
    """Warming a new program while real launches are in flight must
    demux the launches it retires, not drop them."""
    _, eng, _, _ = served
    server = GraphServer(eng, buckets=(4,), depth=1)
    qid = server.submit("bfs", root=3)
    server.pump()                          # real launch now in flight
    server.warmup(["kcore"])               # retires it to free the slot
    assert qid in server.results, "in-flight result dropped by warmup"
    assert server.results.pop(qid).key.label == "bfs_fast"


def test_mixed_stream_all_answered(served):
    """A mixed closed-loop stream resolves every qid, in submission
    order, and per-(algo, bucket) metrics cover the traffic."""
    _, _, _, server = served
    qs = [query("bfs", root=1), query("sssp", root=2), query("cc"),
          query("bfs", root=3), query("bfs", root=9), query("sssp", root=4)]
    results = server.serve(qs)
    assert [r.qid for r in results] == [q.qid for q in qs]
    assert all(r.latency_s > 0 for r in results)
    cells = {(r["algo"], r["bucket"]) for r in server.metrics.rows()}
    assert ("bfs_fast", 4) in cells and ("cc", 0) in cells


def test_async_served_matches_direct_depth2(served):
    """Async programs under the serving stack: rooted async queries
    coalesce onto the padded batch launch, async refreshes ride bucket
    0, two launches ride the executor together at depth=2, and every
    served field is bit-identical to the direct async call."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,), depth=2)
    qs = [query("bfs/async", root=5), query("cc/async"),
          query("sssp/async", root=9), query("pagerank/async"),
          query("bfs/async", root=31)]
    results = server.serve(qs)
    assert [r.qid for r in results] == [q.qid for q in qs]
    assert [r.bucket for r in results] == [4, 0, 4, 0, 4]
    for q, r in zip(qs, results):
        prog = eng.program(r.key.algo, r.key.variant)
        assert prog.spec.exec_mode == "async"
        extra = (q.root,) if q.root is not None else ()
        want, rounds = _direct(eng, garr, prog, *extra)
        assert r.rounds == rounds
        for name, w in want.items():
            np.testing.assert_array_equal(
                r[name], w,
                err_msg=f"{r.key.label} field {name!r}: served != direct")


def test_warm_seed_resolves_from_served_refresh(served):
    """A seeded query without a seed takes the stored output of its
    algo's last served refresh (warm), and answers what a direct call
    from that seed answers."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,))
    key = make_key("cc/incremental")
    assert server.resolve_seed(key)[1] is False     # empty store: cold
    (cc,) = server.serve([query("cc")])
    (seed,), warm = server.resolve_seed(key)
    assert warm and seed is cc["labels"]
    (res,) = server.serve([Query(key)])
    want, rounds = _direct(eng, garr, eng.program("cc", "incremental"),
                           eng.scatter_vertex_field(seed, np.int32))
    assert res.rounds == rounds
    np.testing.assert_array_equal(res["labels"], want["labels"])


def test_served_parity_multi_partition():
    """Served equals direct at parts=2 too (the server demuxes
    (P, B, n_local) outputs across real partitions)."""
    n = 1024
    eng = GraphEngine(partition_graph(urand_edges(n, 8192, seed=5), n, 2),
                      device="cpu")
    garr = eng.device_graph()
    server = GraphServer(eng, buckets=(1, 4))
    res = server.serve([query("bfs", root=3), query("bfs", root=700),
                        query("sssp", root=3), query("pagerank")])
    p, _ = eng.program("bfs", "fast", direction="pull")(garr, 700)
    np.testing.assert_array_equal(res[1]["parents"],
                                  eng.gather_vertex_field(p))
    d, _ = eng.program("sssp")(garr, 3)
    np.testing.assert_array_equal(res[2]["dist"], eng.gather_vertex_field(d))
    r, _, _ = eng.program("pagerank")(garr)
    np.testing.assert_array_equal(res[3]["rank"], eng.gather_vertex_field(r))


# -- workload generator --------------------------------------------------


def test_workload_generator():
    mix = parse_mix("bfs:8, sssp:4 ,cc:1")
    assert [(k.label, w) for k, w in mix] == \
        [("bfs_fast", 8.0), ("sssp", 4.0), ("cc", 1.0)]
    trace = synthetic_trace(1 << 10, "bfs:8,sssp:4,cc:1", rate=500,
                            duration=1.0, seed=3)
    assert trace and all(0 <= t < 1.0 for t, _ in trace)
    assert [t for t, _ in trace] == sorted(t for t, _ in trace)
    for _, q in trace:
        assert (q.root is not None) == q.key.rooted
        if q.root is not None:
            assert 0 <= q.root < (1 << 10)
    trace2 = synthetic_trace(1 << 10, "bfs:8,sssp:4,cc:1", rate=500,
                             duration=1.0, seed=3)
    assert [(t, q.key, q.root) for t, q in trace] == \
        [(t, q.key, q.root) for t, q in trace2]
    sample = zipf_root_sampler(1 << 16, s=1.1, seed=0)
    roots = sample(size=4096)
    top_share = np.bincount(roots).max() / 4096
    assert top_share > 0.01                # a hot vertex exists


@pytest.mark.parametrize("seed", [0, 42])
def test_workload_matches_reference(seed):
    """parse_mix, zipf_root_sampler and synthetic_trace draw the
    reference's numbers: the same keys, weights, roots and times."""
    mix = "bfs:8,sssp/default:4,cc:1,pagerank/warm,betweenness:2"
    got, want = parse_mix(mix), ref_workload.parse_mix(mix)
    assert [(k.algo, k.variant, k.params, w) for k, w in got] == \
        [(k.algo, k.variant, k.params, w) for k, w in want]
    s_got = zipf_root_sampler(1 << 12, s=1.05, seed=seed)
    s_want = ref_workload.zipf_root_sampler(1 << 12, s=1.05, seed=seed)
    np.testing.assert_array_equal(s_got(size=512), s_want(size=512))
    assert [s_got() for _ in range(8)] == [s_want() for _ in range(8)]
    t_got = synthetic_trace(1 << 12, mix, rate=200, duration=2.0,
                            zipf_s=1.05, seed=seed)
    t_want = ref_workload.synthetic_trace(1 << 12, mix, rate=200,
                                          duration=2.0, zipf_s=1.05,
                                          seed=seed)
    assert len(t_got) == len(t_want) > 100
    assert [(t, q.key.algo, q.key.variant, q.key.params, q.root)
            for t, q in t_got] == \
        [(t, q.key.algo, q.key.variant, q.key.params, q.root)
         for t, q in t_want]


# -- resilience: validation, deadlines, shedding, retry/quarantine -------


def test_validate_query_rejects_bad_inputs(served):
    """Admission-time validation: out-of-range roots, non-finite float
    params, malformed seed vectors and non-positive deadlines are all
    rejected before they can reach a program."""
    n, _, _, _ = served
    validate_query(query("bfs", root=5), n)              # clean passes
    with pytest.raises(ValueError, match="root"):
        validate_query(query("bfs", root=n), n)
    with pytest.raises(ValueError, match="root"):
        validate_query(query("bfs", root=-1), n)
    with pytest.raises(ValueError, match="finite"):
        validate_query(
            query("sssp", root=1, weight_scale=float("inf")), n)
    bad_rank = np.full(n, 1.0 / n, np.float32)
    bad_rank[7] = np.nan
    with pytest.raises(ValueError, match="finite"):
        validate_query(query("pagerank", "warm", seed=(bad_rank,)), n)
    bad_labels = np.arange(n, dtype=np.int32)
    bad_labels[3] = n                                    # out of range
    with pytest.raises(ValueError, match="outside"):
        validate_query(query("cc", "incremental", seed=(bad_labels,)), n)
    with pytest.raises(ValueError, match="shape"):
        validate_query(
            query("cc", "incremental",
                  seed=(np.zeros(n - 1, np.int32),)), n)
    with pytest.raises(ValueError, match="deadline"):
        validate_query(query("bfs", root=1, deadline_s=0.0), n)


def test_server_rejects_invalid_at_admission(served):
    """submit() raises on an invalid query, counts it, and leaves the
    admission queue untouched (no poison enters the pipeline)."""
    n, eng, _, _ = served
    server = GraphServer(eng, buckets=(4,))
    with pytest.raises(ValueError, match="root"):
        server.submit("bfs", root=n + 7)
    assert server.metrics.counts["rejected"] == 1
    assert not server.coalescer.has_pending()
    assert server.pump() == []


def test_deadline_expired_in_queue_times_out(served):
    """A query whose deadline lapses while queued gets a typed
    ``timed_out`` result and is dropped from the batch pre-launch; its
    live batchmates are still answered, bit-identical to direct."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,))
    qid_live = server.submit("bfs", root=5)
    qid_dead = server.submit("bfs", root=6, deadline_s=1e-6)
    time.sleep(0.01)                       # lapse the tiny deadline
    res = {r.qid: r for r in server.drain()}
    dead = res[qid_dead]
    assert dead.status == "timed_out" and not dead.ok
    assert dead.fields == {} and dead.rounds == -1
    with pytest.raises(KeyError, match="timed_out"):
        dead["parents"]
    live = res[qid_live]
    assert live.ok and live.status == "ok"
    p, _ = eng.program("bfs", "fast")(garr, 5)
    np.testing.assert_array_equal(live["parents"],
                                  eng.gather_vertex_field(p))
    assert server.metrics.counts["timed_out"] == 1


def test_default_deadline_is_inherited(served):
    """``default_deadline_s`` applies to queries submitted without an
    explicit deadline."""
    _, eng, _, _ = served
    server = GraphServer(eng, buckets=(4,), default_deadline_s=1e-6)
    qid = server.submit("cc")
    time.sleep(0.01)
    res = server.drain()
    assert [r.status for r in res] == ["timed_out"]
    assert server.results[qid].status == "timed_out"


def test_load_shedding_evicts_oldest_deadline_first(served):
    """With ``max_queued=2`` the coalescer sheds on overflow, evicting
    the pending query with the soonest deadline; shed queries resolve
    as ``shed`` and the survivors are still answered."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,), max_queued=2)
    q1 = server.submit("bfs", root=1, deadline_s=0.5)
    q2 = server.submit("bfs", root=2, deadline_s=30.0)
    q3 = server.submit("bfs", root=3)              # sheds q1 (soonest)
    q4 = server.submit("bfs", root=4, deadline_s=5.0)   # sheds q4 itself
    assert server.results[q1].status == "shed"
    assert server.results[q4].status == "shed"
    res = {r.qid: r for r in server.drain()}
    assert sorted(res) == sorted([q1, q2, q3, q4])  # shed results surface
    assert res[q1].status == "shed" and res[q4].status == "shed"
    assert res[q2].ok and res[q3].ok
    p, _ = eng.program("bfs", "fast")(garr, 2)
    np.testing.assert_array_equal(res[q2]["parents"],
                                  eng.gather_vertex_field(p))
    assert server.metrics.counts["shed"] == 2


def test_transient_launch_failure_is_retried(served, monkeypatch):
    """A dispatch that fails once then succeeds yields an ok answer
    after one backoff retry."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,), retry_backoff_s=0.0)
    orig = server._dispatch
    calls = {"n": 0}

    def flaky(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient launch failure")
        return orig(batch)

    monkeypatch.setattr(server, "_dispatch", flaky)
    res = server.serve([query("bfs", root=7)])
    assert [r.status for r in res] == ["ok"]
    assert server.metrics.counts["retries"] == 1
    p, _ = eng.program("bfs", "fast")(garr, 7)
    np.testing.assert_array_equal(res[0]["parents"],
                                  eng.gather_vertex_field(p))


def test_poison_query_is_bisected_and_quarantined(served, monkeypatch):
    """A poison query that makes every containing launch raise is
    isolated by bisection: its batchmates are answered bit-identical,
    the poison member exhausts its retries, lands in
    ``server.quarantined`` with the causal error, and the server stays
    usable."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,), max_retries=1,
                         retry_backoff_s=0.0)
    orig = server._dispatch

    def poisoned(batch):
        if any(q.root == 13 for q in batch.queries):
            raise RuntimeError("poison root")
        return orig(batch)

    monkeypatch.setattr(server, "_dispatch", poisoned)
    res = server.serve([query("bfs", root=5), query("bfs", root=13),
                        query("bfs", root=9)])
    assert [r.status for r in res] == ["ok", "failed", "ok"]
    bad = res[1]
    assert isinstance(bad.error, RuntimeError) and not bad.ok
    assert [r.qid for r in server.quarantined] == [bad.qid]
    assert server.metrics.counts["quarantined"] == 1
    assert server.metrics.counts["retries"] == 1    # singleton retried once
    prog = eng.program("bfs", "fast")
    for r, root in ((res[0], 5), (res[2], 9)):
        p, _ = prog(garr, root)
        np.testing.assert_array_equal(r["parents"],
                                      eng.gather_vertex_field(p))
    after = server.serve([query("bfs", root=2)])    # still healthy
    assert after[0].ok


def test_executor_failed_block_is_contained(monkeypatch):
    """A launch whose wait raises is returned with ``error`` set; its
    in-flight peer is untouched, drain returns every remaining launch,
    and the executor stays usable."""
    ex = DoubleBufferedExecutor(depth=2)
    orig = executor_mod._block

    def boom(launch):
        if isinstance(launch.out, str):
            raise RuntimeError("device error")
        return orig(launch)

    monkeypatch.setattr(executor_mod, "_block", boom)
    ex.push("a", "BOOM")
    ex.push("b", torch.zeros(2))
    done = ex.drain()                               # never raises
    assert [l.payload for l in done] == ["a", "b"]
    assert isinstance(done[0].error, RuntimeError)
    assert done[1].error is None
    assert len(ex) == 0
    assert [l.payload for l in ex.drain()] == []    # not wedged
    ex.push("c", torch.zeros(2))
    done = ex.drain()
    assert [l.payload for l in done] == ["c"] and done[0].error is None


def test_async_launch_failure_does_not_orphan_peers(served, monkeypatch):
    """A failure surfacing at the executor's wait with depth=2 in flight
    routes through the retry path without orphaning the concurrent
    launch — both queries end ok."""
    _, eng, garr, _ = served
    server = GraphServer(eng, buckets=(4,), depth=2, retry_backoff_s=0.0)
    poison_ids = set()
    armed = {"on": True}
    orig_dispatch = server._dispatch

    def marked(batch):
        out = orig_dispatch(batch)
        if armed["on"] and any(q.root == 13 for q in batch.queries):
            armed["on"] = False                     # fail only the first
            poison_ids.add(id(out))
        return out

    orig_block = executor_mod._block

    def boom(launch):
        if id(launch.out) in poison_ids:
            poison_ids.discard(id(launch.out))
            raise RuntimeError("device failure surfaced at the wait")
        return orig_block(launch)

    monkeypatch.setattr(server, "_dispatch", marked)
    monkeypatch.setattr(executor_mod, "_block", boom)
    res = server.serve([query("bfs", root=13), query("sssp", root=7)])
    assert [r.status for r in res] == ["ok", "ok"]
    assert server.metrics.counts["retries"] == 1
    assert len(server.executor) == 0
    p, _ = eng.program("bfs", "fast")(garr, 13)
    np.testing.assert_array_equal(res[0]["parents"],
                                  eng.gather_vertex_field(p))
    d, _ = eng.program("sssp")(garr, 7)
    np.testing.assert_array_equal(res[1]["dist"],
                                  eng.gather_vertex_field(d))


def test_overload_sheds_but_never_corrupts(served, monkeypatch):
    """A trace far beyond capacity through a bounded queue sheds/times
    out part of the load, but every ok answer is bit-identical to a
    direct program() call, and recorded latency (ok answers only)
    respects the deadline."""
    n, eng, garr, _ = served
    server = GraphServer(eng, buckets=(1, 4), max_queued=8,
                         default_deadline_s=2.0)
    server.serve([query("bfs", root=0)])            # warm the programs
    orig = server._dispatch

    def slow(batch):                # pin capacity below the trace rate
        time.sleep(0.005)
        return orig(batch)

    monkeypatch.setattr(server, "_dispatch", slow)
    trace = synthetic_trace(n, "bfs", rate=2000, duration=0.2, seed=4)
    res = server.serve_trace(trace)
    assert len(res) == len(trace)
    assert "ok" in {r.status for r in res}
    shed = server.metrics.counts["shed"]
    timed_out = server.metrics.counts["timed_out"]
    assert shed + timed_out > 0                     # overload was real
    prog = eng.program("bfs", "fast")
    by_qid = {q.qid: q for _, q in trace}
    checked = 0
    for r in res:
        if not r.ok or checked >= 8:
            continue
        p, _ = prog(garr, by_qid[r.qid].root)
        np.testing.assert_array_equal(r["parents"],
                                      eng.gather_vertex_field(p))
        checked += 1
    assert checked > 0
    for row in server.metrics.rows():
        assert row["p99_ms"] <= 2.0 * 1e3


# -- the batched runner's duplicate lanes --------------------------------


@pytest.mark.parametrize("algo,variant,roots", [
    ("bfs", "fast", [3, 9, 9, 9]),          # a batch padded to its rung
    ("sssp", "default", [0, 0, 0, 0]),      # warmup's all-zero lanes
    ("betweenness", "default", [5, 2, 5, 2]),
])
def test_batched_duplicate_lanes_run_once(served, monkeypatch, algo,
                                          variant, roots):
    """Duplicate lanes equal per-lane single runs bit for bit, and the
    runner runs each distinct root once."""
    _, eng, garr, _ = served
    calls, depth = [], [0]
    orig = superstep.run_program

    def counting(prog, g, *inputs, **kw):
        if not depth[0]:                   # a query's run, not a phase's
            calls.append(inputs[0])
        depth[0] += 1
        try:
            return orig(prog, g, *inputs, **kw)
        finally:
            depth[0] -= 1

    monkeypatch.setattr(superstep, "run_program", counting)
    bprog = eng.program(algo, variant, batch=len(roots))
    *outs, rounds = bprog(garr, roots)
    assert sorted(calls) == sorted(set(roots))
    monkeypatch.setattr(superstep, "run_program", orig)
    single = eng.program(algo, variant,
                         **registry.get_spec(algo, variant).batch_defaults)
    for lane, root in enumerate(roots):
        *want, r = single(garr, root)
        assert rounds[lane] == r
        for o, w, isv in zip(outs, want, bprog.program.output_is_vertex):
            assert isv and torch.equal(o[:, lane], w), (algo, lane)


# -- against the JAX package's server --------------------------------------

_REFERENCE = """
import json, sys
import numpy as np
import jax.numpy as jnp
from repro.core import GraphEngine, incremental, partition_graph, registry
from repro.graphs import urand_edges
from repro.launch.mesh import make_graph_mesh
from repro.serve import GraphServer, Query, make_key

n, calls = {n}, {calls!r}
edges = urand_edges(n, {e}, seed={seed})
meta, arrays = {{}}, {{}}
for parts in (1, 2):
    g = partition_graph(edges, n, parts)
    eng = GraphEngine(g, make_graph_mesh(parts))
    server = GraphServer(eng, buckets=(4,))
    i = 0
    for call in calls:
        qs, warm = [], []
        for algo, variant, root, seed in call:
            key = make_key(algo + "/" + variant)
            if seed == "cold":
                qs.append(Query(key, seed=incremental.cold_seed(key.spec, g)))
            else:
                qs.append(Query(key, root))
            if seed == "warm":
                warm.append(server.resolve_seed(key)[1])
        assert all(warm), warm
        for res in server.serve(qs):
            meta[f"{{parts}}/{{i}}"] = {{
                "status": res.status, "bucket": res.bucket,
                "epoch": res.epoch, "rounds": res.rounds,
                "fields": sorted(res.fields)}}
            for name, value in res.fields.items():
                arrays[f"{{parts}}/{{i}}/{{name}}"] = np.asarray(value)
            i += 1
    if parts == 1:
        garr = eng.device_graph()
        for name, prog, args in (
                ("bfs", eng.bfs(), (jnp.int32(7),)),
                ("bfs_bsp", eng.bfs("bsp"), (jnp.int32(7),)),
                ("pagerank", eng.pagerank(), ()),
                ("pagerank_bsp", eng.pagerank("bsp", iters=30), ()),
                ("sssp", eng.sssp(), (jnp.int32(7),)),
                ("cc", eng.cc(), ())):
            out = prog(garr, *args)
            meta["wrapper/" + name] = int(out[-1])
            arrays["wrapper/" + name] = eng.gather_vertex_field(out[0])
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("serve_ref") / "ref")
    log = run_with_devices(_REFERENCE.format(
        n=N, e=E, seed=SEED, calls=CALLS, out=out), devices=2, timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out + ".json")), np.load(out + ".npz")


def _same_field(algo, variant, name, got, want, what):
    if name == "rank":
        rel = np.abs(got - want).max() / np.abs(want).max()
        assert got.dtype == want.dtype and rel < RANK_REL[variant], \
            f"{what}: rank rel diff {rel:.2e}"
    elif (algo, variant, name) in FLOAT_TOL:
        rtol, atol = FLOAT_TOL[(algo, variant, name)]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)
    elif got.ndim:
        assert got.dtype == want.dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        assert got == want, what            # integer scalars: the value


@pytest.mark.parametrize("parts", [1, 2])
def test_served_matches_reference(reference, parts):
    """The fixed query list through the port's server and the JAX
    package's: equal statuses, buckets, epochs and rounds, integer
    fields bit for bit, float fields within FLOAT_TOL."""
    meta, arrays = reference
    eng = _engine(parts)
    server = GraphServer(eng, buckets=(4,))
    results = []
    for call in CALLS:
        qs = []
        for algo, variant, root, seed in call:
            key = make_key(f"{algo}/{variant}")
            if seed == "cold":
                qs.append(Query(key, seed=incremental.cold_seed(key.spec,
                                                                eng.g)))
            else:
                qs.append(Query(key, root))
            if seed == "warm":
                assert server.resolve_seed(key)[1], key
        results += server.serve(qs)
    flat = [q for call in CALLS for q in call]
    assert len(results) == len(flat)
    for i, ((algo, variant, root, _), res) in enumerate(zip(flat, results)):
        want = meta[f"{parts}/{i}"]
        what = f"parts={parts} #{i} {algo}/{variant} root={root}"
        assert (res.status, res.bucket, res.epoch, res.rounds) == \
            (want["status"], want["bucket"], want["epoch"],
             want["rounds"]), what
        assert sorted(res.fields) == want["fields"], what
        for name, got in res.fields.items():
            _same_field(algo, variant, name, np.asarray(got),
                        arrays[f"{parts}/{i}/{name}"], f"{what} {name}")


def test_engine_wrappers_match_reference(reference):
    """GraphEngine's thin wrappers return the cache entry of the
    equivalent program() call and the reference wrappers' outputs."""
    meta, arrays = reference
    eng = _engine(1)
    garr = eng.device_graph()
    assert eng.bfs() is eng.program("bfs", "fast")
    assert eng.bfs("bsp") is eng.program("bfs", "bsp")
    assert eng.pagerank() is eng.program("pagerank")
    assert eng.pagerank("bsp", iters=30) is \
        eng.program("pagerank", "bsp", iters=30)
    assert eng.sssp() is eng.program("sssp")
    assert eng.cc() is eng.program("cc")
    for name, prog, args in (
            ("bfs", eng.bfs(), (7,)), ("bfs_bsp", eng.bfs("bsp"), (7,)),
            ("pagerank", eng.pagerank(), ()),
            ("pagerank_bsp", eng.pagerank("bsp", iters=30), ()),
            ("sssp", eng.sssp(), (7,)), ("cc", eng.cc(), ())):
        out = prog(garr, *args)
        got, want = eng.gather_vertex_field(out[0]), arrays[f"wrapper/{name}"]
        assert out[-1] == meta[f"wrapper/{name}"], name
        if name.startswith("pagerank"):
            rel = np.abs(got - want).max() / want.max()
            assert rel < RANK_REL["fast" if name == "pagerank" else "bsp"], \
                name
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


# -- the launcher ------------------------------------------------------------

# the reference launcher's --json payload (src/repro/launch/graph_serve.py):
# its top-level keys, and its meta keys but the runtime fingerprint's
REF_PAYLOAD_KEYS = {"meta", "rows", "counts", "epoch", "recoveries",
                    "wal_records"}
REF_META_KEYS = {"graph", "parts", "mix", "rate", "duration", "buckets",
                 "depth", "zipf_s", "layout", "localops", "mutate_every",
                 "mutate_size", "mutations", "final_epoch", "wal_dir",
                 "recovered", "device"}


def test_graph_serve_cli_writes_reference_payload(tmp_path):
    path = tmp_path / "serve.json"
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.graph_serve",
         "--graph", "urand12", "--device", "cpu", "--duration", "2",
         "--rate", "16", "--json", str(path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    payload = json.loads(path.read_text())
    assert set(payload) == REF_PAYLOAD_KEYS
    meta = payload["meta"]
    assert REF_META_KEYS <= set(meta)
    assert (meta["mutations"], meta["final_epoch"], meta["wal_dir"],
            meta["recovered"], meta["device"]) == (0, 0, None, False, "cpu")
    assert meta["torch"] == torch.__version__
    assert payload["counts"] == {"shed": 0, "timed_out": 0, "retries": 0,
                                 "quarantined": 0, "rejected": 0}
    assert payload["rows"] and sum(r["count"] for r in payload["rows"]) > 0
    assert {r["algo"] for r in payload["rows"]} <= {"bfs_fast", "sssp", "cc"}


_CLI = ("--graph", "urand12", "--parts", "1", "--duration", "2", "--rate",
        "16", "--json", "-")


def _serve_json(module, *args, device=()):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", module, *_CLI, *device, *args], env=env,
        capture_output=True, text=True, timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    line = next(x for x in r.stdout.splitlines()
                if x.startswith("SERVE_JSON "))
    return json.loads(line[len("SERVE_JSON "):]), r.stdout


def test_graph_serve_cli_mutate_and_recover_match_reference(tmp_path):
    """``--mutate-every 0.5 --mutate-size 16 --wal-dir`` then
    ``--recover``: the payloads' keys, the mutation and durability
    fields and the final epoch equal the JAX package's launcher's on the
    same arguments, and the two WAL files are byte-identical."""
    runs = {}
    for name, module, device in (
            ("port", "repro_torch.launch.graph_serve", ("--device", "cpu")),
            ("ref", "repro.launch.graph_serve", ())):
        wal = str(tmp_path / name)
        first, _ = _serve_json(module, "--mutate-every", "0.5",
                               "--mutate-size", "16", "--wal-dir", wal,
                               device=device)
        second, log = _serve_json(module, "--recover", "--wal-dir", wal,
                                  device=device)
        runs[name] = (first, second, open(os.path.join(wal, "wal.log"),
                                          "rb").read())
        assert "recovered" in log
    fields = ("mutate_every", "mutate_size", "mutations", "final_epoch",
              "recovered")
    for i, want_recovered in ((0, False), (1, True)):
        got, want = runs["port"][i], runs["ref"][i]
        assert set(got) == set(want) == REF_PAYLOAD_KEYS
        assert REF_META_KEYS <= set(got["meta"])
        assert {k: got["meta"][k] for k in fields} == \
            {k: want["meta"][k] for k in fields}
        assert got["meta"]["recovered"] is want_recovered
        assert got["meta"]["wal_dir"] == str(tmp_path / "port")
        assert [got[k] for k in ("epoch", "recoveries", "wal_records",
                                 "counts")] == \
            [want[k] for k in ("epoch", "recoveries", "wal_records",
                               "counts")]
    first, second, _ = runs["port"]
    assert first["meta"]["final_epoch"] == first["epoch"] == 3 \
        == second["meta"]["final_epoch"]
    assert (first["recoveries"], second["recoveries"]) == (0, 1)
    assert first["wal_records"] == second["wal_records"] == 3
    assert runs["port"][2] == runs["ref"][2], "wal.log bytes differ"
