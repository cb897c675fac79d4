"""The port's dynamic graphs (``repro_torch.serve.dynamic``) and the
server's ``mutate``.

  * Ports of tests/test_dynamic.py and of
    test_serve.py::test_async_epoch_snapshot_isolation on the port:
    in-place patching with no re-partition and no re-upload, epoch
    isolation, pending queries flushed before a mutation, the rebuild
    fallback, validation, mid-batch rollback, warm-seed resolution and
    its round win, mutation streams and mutation events in a trace, and
    the served post-mutation conformance sweep against the NumPy oracle
    at parts {1, 2, 4} x {urand, rmat}.
  * Against the JAX package's ``DynamicGraph``: a fixed stream
    (``_STREAM``: deletes, a mixed batch with a re-inserted and a
    duplicated edge, a batch rolled back mid-apply then applied, an
    overflow into the rebuild path, then deletes and inserts on the
    rebuilt layout) at parts {1, 2, 4} x {urand, rmat}, the reference in
    one multi-device subprocess per family.  After every step the
    samples, every host mirror and every device array are byte-identical
    and ``MutationStats`` equal but ``apply_s``; a planner restored from
    the port's ``planner_state`` after the mixed batch replays the rest
    into the same slots; on urand at parts 1 and 2 served answers after
    the mixed batch and after the rebuilt layout's inserts equal the
    reference server's (integer fields bit for bit, floats within
    test_torch_serve's FLOAT_TOL).
"""

import copy
import json
import os
import pickle
from collections import Counter

import numpy as np
import pytest
import torch

import oracle
from conftest import run_with_devices
from test_torch_serve import _same_field
import repro_torch.serve.dynamic.mutation as mutation_mod
from repro_torch.core import GraphEngine, partition_graph
from repro_torch.graphs import urand_edges
from repro_torch.serve import GraphServer, MutationBatch, Query, \
    make_key, mutation_stream, query

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
COO_KEYS = ("out_src_local", "out_dst_global", "in_src_global",
            "in_dst_local", "out_degree", "in_degree")
STREAM_N, STREAM_SEED = 384, 11
STREAM_PARTS = (1, 2, 4)
SERVED_PARTS = (1, 2)            # urand only: see the module docstring


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread a worker: the workers share the cores."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _edge_counter(edges):
    return Counter(map(tuple, np.asarray(edges, np.int64).tolist()))


def _apply_host(edges, inserts=None, deletes=None):
    """The referee's own edge-list mutation (multiset semantics)."""
    edges = np.asarray(edges, np.int64)
    if deletes is not None and len(deletes):
        cd = Counter(map(tuple, np.asarray(deletes, np.int64).tolist()))
        keep = np.ones(len(edges), bool)
        for i, uv in enumerate(map(tuple, edges.tolist())):
            if cd.get(uv, 0):
                cd[uv] -= 1
                keep[i] = False
        assert not +cd, f"deletes not present in edge list: {+cd}"
        edges = edges[keep]
    if inserts is not None and len(inserts):
        edges = np.concatenate([edges, np.asarray(inserts, np.int64)])
    return edges


@pytest.fixture()
def slack_server():
    n, e = 512, 6100
    edges = urand_edges(n, e, seed=7)
    eng = GraphEngine(partition_graph(edges, n, parts=1), device="cpu")
    return n, edges, eng, GraphServer(eng, buckets=(4,))


# -- in-place patching ---------------------------------------------------


def test_patch_applies_in_place_without_rebuild(slack_server, monkeypatch):
    """A fitting batch never re-partitions or re-uploads: partition_graph
    is rigged to fail, the cached programs stay the SAME objects, and
    the patched device tensors equal the host mirrors exactly."""
    n, edges, eng, server = slack_server
    server.serve([query("cc")])
    prog_before = eng.program("cc")
    garr_ids = {k: id(v) for k, v in server.garr.items()}
    monkeypatch.setattr(
        mutation_mod, "partition_graph",
        lambda *a, **k: pytest.fail("in-place path called partition_graph"))

    dyn = server.dynamic_graph()
    rng = np.random.default_rng(0)
    dels = dyn.sample_deletable(30, rng)
    ins = dyn.sample_insertable(30, rng)
    stats = server.mutate(inserts=ins, deletes=dels)
    assert not stats.rebuild
    assert stats.epoch == 1 and server.epoch == 1
    assert stats.slots_patched > 0 and stats.arrays_patched > 0
    assert eng.program("cc") is prog_before
    changed = {k for k, v in server.garr.items() if id(v) != garr_ids[k]}
    assert changed and changed != set(garr_ids), \
        "either nothing was patched or everything was re-uploaded"
    for k in COO_KEYS:
        np.testing.assert_array_equal(server.garr[k].numpy(),
                                      getattr(eng.g, k), err_msg=k)
    for k, arr in eng.g.ell_arrays.items():
        np.testing.assert_array_equal(server.garr[k].numpy(), arr,
                                      err_msg=k)
    edges1 = _apply_host(edges, inserts=ins, deletes=dels)
    assert _edge_counter(dyn.current_edges()) == _edge_counter(edges1)
    res = server.serve([query("cc")])[0]
    np.testing.assert_array_equal(res["labels"], oracle.cc_labels(edges1, n))
    assert res.epoch == 1


def test_patch_is_functional_and_checks_slots():
    """The patcher copies: the input tensor keeps its values, and a slot
    outside the tensor raises on the host instead of being dropped."""
    patch = mutation_mod.make_scatter_patch()
    arr = torch.arange(12, dtype=torch.int32).reshape(2, 6)
    out = patch(arr, np.array([1, 7]), np.array([-1, -2], np.int32))
    assert arr.tolist() == [list(range(6)), list(range(6, 12))]
    assert out.tolist() == [[0, -1, 2, 3, 4, 5], [6, -2, 8, 9, 10, 11]]
    assert out.dtype == torch.int32 and out.shape == arr.shape
    for bad in ([12], [-1]):
        with pytest.raises(IndexError, match="out of range"):
            patch(arr, np.array(bad), np.array([0], np.int32))


def test_epoch_snapshot_isolation(slack_server):
    """A launch in flight when mutate() runs answers for ITS epoch."""
    n, edges, eng, server = slack_server
    q_old = query("cc")
    server.submit_query(q_old)
    server.pump()                          # epoch-0 launch now in flight
    dyn = server.dynamic_graph()
    dels = dyn.sample_deletable(40, np.random.default_rng(1))
    server.mutate(deletes=dels)
    res_new = server.serve([query("cc")])[0]
    server.drain()
    res_old = server.results.pop(q_old.qid)
    assert res_old.epoch == 0 and res_new.epoch == 1
    np.testing.assert_array_equal(
        res_old["labels"], oracle.cc_labels(edges, n),
        err_msg="in-flight launch must answer for the pre-mutation epoch")
    np.testing.assert_array_equal(
        res_new["labels"],
        oracle.cc_labels(_apply_host(edges, deletes=dels), n))


def test_async_epoch_snapshot_isolation(slack_server):
    """The same for an async program's launch (test_serve.py's test)."""
    n, edges, eng, server = slack_server
    q_old = query("cc/async")
    server.submit_query(q_old)
    server.pump()
    dyn = server.dynamic_graph()
    dels = dyn.sample_deletable(40, np.random.default_rng(1))
    server.mutate(deletes=dels)
    res_new = server.serve([query("cc/async")])[0]
    server.drain()
    res_old = server.results.pop(q_old.qid)
    assert res_old.epoch == 0 and res_new.epoch == 1
    np.testing.assert_array_equal(
        res_old["labels"], oracle.cc_labels(edges, n),
        err_msg="in-flight async launch must answer pre-mutation epoch")
    np.testing.assert_array_equal(
        res_new["labels"],
        oracle.cc_labels(_apply_host(edges, deletes=dels), n))


def test_pending_queries_flush_before_mutation(slack_server):
    n, edges, eng, server = slack_server
    q_old = query("cc")
    server.submit_query(q_old)             # queued, not pumped
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(25, np.random.default_rng(2)))
    server.drain()
    res = server.results.pop(q_old.qid)
    assert res.epoch == 0
    np.testing.assert_array_equal(res["labels"], oracle.cc_labels(edges, n))


def test_mutation_epochs_never_coalesce(slack_server):
    _, _, _, server = slack_server
    a = query("cc")
    server.submit_query(a)
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(5, np.random.default_rng(3)))
    ra = server.serve([query("cc")])[0]
    server.drain()
    res_a = server.results.pop(a.qid)
    assert res_a.epoch == 0 and ra.epoch == 1
    assert res_a.fields is not ra.fields


# -- overflow / rebuild fallback -----------------------------------------


def test_overflow_falls_back_to_rebuild(slack_server):
    n, edges, eng, server = slack_server
    server.serve([query("cc")])
    ins = np.tile([[9, 11]], (300, 1))
    stats = server.mutate(inserts=ins)
    assert stats.rebuild and server.epoch == 1
    assert server.mutation_log[-1]["rebuild"]
    edges1 = _apply_host(edges, inserts=ins)
    dyn = server.dynamic_graph()
    assert _edge_counter(dyn.current_edges()) == _edge_counter(edges1)
    res = server.serve([query("cc"), query("kcore")])
    np.testing.assert_array_equal(res[0]["labels"],
                                  oracle.cc_labels(edges1, n))
    np.testing.assert_array_equal(res[1]["core"],
                                  oracle.core_numbers(edges1, n))
    assert all(r.epoch == 1 for r in res)


def test_rebuild_drops_first_instances_in_edge_order():
    """The vectorised delete of the rebuild path drops, for each deleted
    (u, v) named c times, its first c instances in edge order — the JAX
    package's loop, kept here as the reference."""
    rng = np.random.default_rng(4)
    edges = rng.integers(0, 6, size=(200, 2))
    dels = np.concatenate([edges[rng.choice(200, 40, replace=False)],
                           edges[:3]])
    cd = Counter(map(tuple, dels.tolist()))
    keep = np.ones(len(edges), bool)
    for i, uv in enumerate(map(tuple, edges.tolist())):
        if cd.get(uv, 0):
            cd[uv] -= 1
            keep[i] = False
    np.testing.assert_array_equal(
        mutation_mod.drop_first_instances(edges, dels, 6), edges[keep])
    assert mutation_mod.drop_first_instances(
        edges, np.zeros((0, 2), np.int64), 6) is edges


def test_mutation_validation(slack_server):
    _, _, _, server = slack_server
    with pytest.raises(ValueError, match="delete"):
        server.mutate(deletes=np.array([[0, 600]]))   # out of range
    with pytest.raises(ValueError, match=r"\(k, 2\)"):
        server.mutate(inserts=np.array([1, 2, 3]))
    with pytest.raises(KeyError):                     # not a live instance
        server.mutate(deletes=np.array([[0, 0]] * 8))


def test_apply_rolls_back_on_midbatch_failure(slack_server, monkeypatch):
    """Failure atomicity: a planner that raises mid-batch leaves the free
    stacks, position index, mirrors, occupancy and device graph at the
    pre-batch epoch, and the SAME batch then applies cleanly."""
    n, edges, eng, server = slack_server
    server.serve([query("cc")])
    dyn = server.dynamic_graph()
    ins = dyn.sample_insertable(6, np.random.default_rng(3))
    g = eng.g
    ell0 = {k: v.copy() for k, v in g.ell_arrays.items()}
    coo0 = {k: getattr(g, k).copy() for k in COO_KEYS}
    occ0 = {nm: occ.copy() for nm, occ in dyn._occ.items()}
    free0 = ([list(s) for s in dyn._free_out],
             [list(s) for s in dyn._free_in])
    touched0 = copy.deepcopy((dyn._pos_out, dyn._pos_in))
    lists0 = {(u, v): (dyn.positions("out", u // g.n_local, u, v),
                       dyn.positions("in", v // g.n_local, u, v))
              for u, v in ins.tolist()}
    garr0 = dict(dyn.garr)
    edges0 = _edge_counter(dyn.current_edges())

    orig_fill = dyn._ell_fill
    calls = {"n": 0}

    def failing(name, p, row, value, touched):
        calls["n"] += 1                 # 4 fills per insert: call 10 is
        if calls["n"] == 10:            # mid-batch, 2 edges committed
            raise RuntimeError("simulated planner crash")
        return orig_fill(name, p, row, value, touched)

    monkeypatch.setattr(dyn, "_ell_fill", failing)
    with pytest.raises(RuntimeError, match="planner crash"):
        dyn.apply(inserts=ins)
    assert dyn.epoch == 0
    for k in ell0:
        np.testing.assert_array_equal(g.ell_arrays[k], ell0[k], err_msg=k)
    for k in COO_KEYS:
        np.testing.assert_array_equal(getattr(g, k), coo0[k], err_msg=k)
    for nm in occ0:
        np.testing.assert_array_equal(dyn._occ[nm], occ0[nm], err_msg=nm)
    assert ([list(s) for s in dyn._free_out],
            [list(s) for s in dyn._free_in]) == free0
    assert (dyn._pos_out, dyn._pos_in) == touched0
    for (u, v), want in lists0.items():
        assert (dyn.positions("out", u // g.n_local, u, v),
                dyn.positions("in", v // g.n_local, u, v)) == want
    assert all(dyn.garr[k] is garr0[k] for k in garr0), \
        "device graph must return to the pre-batch tensors"
    assert _edge_counter(dyn.current_edges()) == edges0

    stats = server.mutate(inserts=ins)
    assert not stats.rebuild and dyn.epoch == 1
    edges1 = _apply_host(edges, inserts=ins)
    assert _edge_counter(dyn.current_edges()) == _edge_counter(edges1)
    res = server.serve([query("cc")])[0]
    np.testing.assert_array_equal(res["labels"], oracle.cc_labels(edges1, n))


# -- warm seeds ----------------------------------------------------------


def test_seed_resolution_follows_mutation_kinds(slack_server):
    _, _, _, server = slack_server
    server.serve([query("cc"), query("kcore"), query("pagerank")])
    assert all(isinstance(arr, np.ndarray)
               for _, arr in server._seeds.values())
    dyn = server.dynamic_graph()
    rng = np.random.default_rng(4)
    server.mutate(deletes=dyn.sample_deletable(20, rng))
    assert not server.resolve_seed(query("cc", "incremental").key)[1]
    assert server.resolve_seed(query("kcore", "incremental").key)[1]
    assert server.resolve_seed(query("pagerank", "warm").key)[1]
    server.serve([query("cc", "incremental"), query("kcore", "incremental")])
    server.mutate(inserts=dyn.sample_insertable(20, rng))
    assert server.resolve_seed(query("cc", "incremental").key)[1]
    assert not server.resolve_seed(query("kcore", "incremental").key)[1]
    assert server.resolve_seed(query("pagerank", "warm").key)[1]


def test_warm_restart_beats_cold_rounds(slack_server):
    n, edges, eng, server = slack_server
    server.serve([query("pagerank", iters=300, tol=1e-6)])
    dyn = server.dynamic_graph()
    server.mutate(deletes=dyn.sample_deletable(15, np.random.default_rng(5)))
    warm = server.serve([query("pagerank", "warm", iters=300, tol=1e-6)])[0]
    cold = server.serve([query("pagerank", iters=300, tol=1e-6)])[0]
    assert 0 < warm.rounds < cold.rounds, (warm.rounds, cold.rounds)


# -- mutation streams ----------------------------------------------------


def test_mutation_stream_shape():
    edges = urand_edges(128, 1000, seed=0)
    ev = mutation_stream(edges, every=0.5, size=10, duration=2.1, seed=1)
    assert [t for t, _ in ev] == [0.5, 1.0, 1.5, 2.0]
    assert ev[0][1].deletes is not None and ev[1][1].inserts is not None
    for _, mb in ev:
        arr = mb.deletes if mb.deletes is not None else mb.inserts
        assert arr.shape == (10, 2)
    dels = np.concatenate([mb.deletes for _, mb in ev
                           if mb.deletes is not None])
    assert not +(_edge_counter(dels) - _edge_counter(edges))
    assert mutation_stream(edges, every=0, size=4, duration=1) == []


def test_mutation_stream_matches_reference():
    from repro.serve.dynamic import mutation_stream as ref_stream
    edges = urand_edges(256, 2048, seed=3)
    got = mutation_stream(edges, every=0.25, size=12, duration=3.0, seed=42)
    want = ref_stream(edges, every=0.25, size=12, duration=3.0, seed=42)
    assert [t for t, _ in got] == [t for t, _ in want]
    for (_, a), (_, b) in zip(got, want):
        for x, y in ((a.inserts, b.inserts), (a.deletes, b.deletes)):
            assert (x is None) == (y is None)
            if x is not None:
                np.testing.assert_array_equal(x, y)


def test_serve_trace_applies_mutation_events(slack_server):
    n, edges, eng, server = slack_server
    dyn = server.dynamic_graph()
    dels = dyn.sample_deletable(20, np.random.default_rng(6))
    trace = [(0.0, query("cc")),
             (0.01, MutationBatch(deletes=dels)),
             (0.02, query("cc"))]
    results = server.serve_trace(trace)
    by_epoch = {r.epoch: r for r in results}
    assert set(by_epoch) == {0, 1}
    np.testing.assert_array_equal(by_epoch[0]["labels"],
                                  oracle.cc_labels(edges, n))
    np.testing.assert_array_equal(
        by_epoch[1]["labels"],
        oracle.cc_labels(_apply_host(edges, deletes=dels), n))
    assert server.mutation_log[-1]["n_delete"] == 20


# -- the served post-mutation conformance sweep --------------------------

_INCREMENTAL_PAIRS = (("cc", "incremental"), ("kcore", "incremental"),
                      ("pagerank", "warm"))


@pytest.mark.parametrize("parts", (1, 2, 4))
@pytest.mark.parametrize("family", ("urand", "rmat"))
def test_served_mutation_conformance(family, parts):
    """Served results after a delete batch and after an insert batch
    equal the NumPy oracle on the post-mutation edge list for every
    incremental program (warm where the mutation kinds allow)."""
    edges0, n = oracle.family_edges(family, 384, 11)
    eng = GraphEngine(partition_graph(edges0, n, parts), device="cpu")
    server = GraphServer(eng, buckets=(4,))
    server.serve([query("cc"), query("kcore"), query("pagerank")])
    dyn = server.dynamic_graph()
    rng = np.random.default_rng(11 + parts)

    dels = dyn.sample_deletable(48, rng)
    server.mutate(deletes=dels)
    edges1 = _apply_host(edges0, deletes=dels)
    assert _edge_counter(dyn.current_edges()) == _edge_counter(edges1)
    assert server.resolve_seed(query("kcore", "incremental").key)[1]
    assert not server.resolve_seed(query("cc", "incremental").key)[1]
    for algo, variant in _INCREMENTAL_PAIRS:
        params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {})
        res = server.serve([query(algo, variant, **params)])[0]
        assert res.epoch == 1, (algo, variant, res.epoch)
        oracle.check_conformance(algo, variant, dict(res.fields),
                                 edges1, n, 0)

    ins = dyn.sample_insertable(48, rng)
    stats = server.mutate(inserts=ins)
    assert not stats.rebuild, "insert batch was sampled to fit"
    edges2 = _apply_host(edges1, inserts=ins)
    assert _edge_counter(dyn.current_edges()) == _edge_counter(edges2)
    assert server.resolve_seed(query("cc", "incremental").key)[1]
    assert not server.resolve_seed(query("kcore", "incremental").key)[1]
    for algo, variant in _INCREMENTAL_PAIRS:
        params = oracle.CONFORMANCE_PARAMS.get((algo, variant), {})
        res = server.serve([query(algo, variant, **params)])[0]
        assert res.epoch == 2, (algo, variant, res.epoch)
        oracle.check_conformance(algo, variant, dict(res.fields),
                                 edges2, n, 0)
    res = server.serve([query("cc"), query("kcore")])
    oracle.check_conformance("cc", "default", dict(res[0].fields),
                             edges2, n, 0)
    oracle.check_conformance("kcore", "default", dict(res[1].fields),
                             edges2, n, 0)


# -- against the JAX package ---------------------------------------------

# The fixed stream, run by both packages: each step samples from the
# planner's state after the previous one.  "rollback" first fails at its
# tenth ELL fill (mid-batch), then applies.
_STREAM = '''
def batches(dyn, rng):
    yield "delete", None, dyn.sample_deletable(24, rng)
    dels = dyn.sample_deletable(8, rng)
    ins = np.concatenate([dyn.sample_insertable(12, rng), dels[:1]])
    for e in dyn.current_edges()[:64]:      # a second live instance
        if not dyn.plan(np.concatenate([ins, e[None]]), dels)[2]:
            ins = np.concatenate([ins, e[None]])
            break
    yield "mixed", ins, dels
    yield "rollback", dyn.sample_insertable(6, rng), None
    u, v = (int(x) for x in dyn.current_edges()[0])
    k = 1                                   # just past the free pools
    while not dyn.plan(np.tile([[u, v]], (k, 1)))[2]:
        k += 1
    yield "overflow", np.tile([[u, v]], (k, 1)), None
    yield "delete2", None, dyn.sample_deletable(16, rng)
    yield "insert2", dyn.sample_insertable(12, rng), None


def drive(server, rng, record):
    """Run the stream through ``server.mutate``; ``record(step, stats,
    inserts, deletes)`` after each step ("rollback/failed": the state
    the failed attempt left)."""
    dyn = server.dynamic_graph()
    for name, ins, dels in batches(dyn, rng):
        if name == "rollback":
            orig, calls = dyn._ell_fill, [0]

            def failing(*args):
                calls[0] += 1
                if calls[0] == 10:
                    raise RuntimeError("simulated planner crash")
                return orig(*args)

            dyn._ell_fill = failing
            try:
                server.mutate(inserts=ins, deletes=dels)
                raise AssertionError("the failing batch applied")
            except RuntimeError as e:
                assert "planner crash" in str(e), e
            del dyn._ell_fill
            record(name + "/failed", None, ins, dels)
        stats = server.mutate(inserts=ins, deletes=dels)
        record(name, stats, ins, dels)
'''
STEPS = ("delete", "mixed", "rollback/failed", "rollback", "overflow",
         "delete2", "insert2")
SERVE_AFTER = ("mixed", "insert2")
# served after SERVE_AFTER: rooted pairs at root 3, refreshes, and the
# seeded pairs from the store's seeds (epoch 0 serves their sources)
SERVED = (("bfs", "fast", 3), ("sssp", "default", 3),
          ("betweenness", "default", 3), ("cc", "default", None),
          ("kcore", "default", None), ("pagerank", "fast", None),
          ("pagerank", "bsp", None), ("cc", "incremental", None),
          ("kcore", "incremental", None), ("pagerank", "warm", None))

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import oracle
from repro.core import GraphEngine, partition_graph
from repro.launch.mesh import make_graph_mesh
from repro.serve import GraphServer, Query, make_key
{stream}
edges, n = oracle.family_edges({family!r}, {n}, {seed})
meta, arrays = {{}}, {{}}
for parts in {parts!r}:
    eng = GraphEngine(partition_graph(edges, n, parts),
                      make_graph_mesh(parts))
    server = GraphServer(eng, buckets=(4,))
    serve = parts in {served_parts!r}
    if serve:
        server.serve([Query(make_key(a)) for a in ("cc", "kcore",
                                                   "pagerank")])

    def record(step, stats, ins, dels):
        pre = f"{{parts}}/{{step}}"
        g, dyn = eng.g, server.dynamic_graph()
        meta[pre] = None if stats is None else {{
            k: v for k, v in vars(stats).items() if k != "apply_s"}}
        for name, a in ((("ins", ins), ("dels", dels))):
            arrays[f"{{pre}}/sample/{{name}}"] = \\
                np.zeros((0, 2), np.int64) if a is None else np.asarray(a)
        # copies: the planner writes the mirrors in place
        for k in {coo!r}:
            arrays[f"{{pre}}/host/{{k}}"] = getattr(g, k).copy()
        for k, a in g.ell_arrays.items():
            arrays[f"{{pre}}/host/{{k}}"] = a.copy()
        for k, a in dyn.garr.items():
            arrays[f"{{pre}}/dev/{{k}}"] = np.array(a)
        if serve and step in {serve_after!r}:
            for i, (algo, variant, root) in enumerate({served!r}):
                (res,) = server.serve([Query(make_key(algo + "/" + variant),
                                             root)])
                meta[f"{{pre}}/served/{{i}}"] = {{
                    "status": res.status, "epoch": res.epoch,
                    "rounds": res.rounds, "fields": sorted(res.fields)}}
                for name, value in res.fields.items():
                    arrays[f"{{pre}}/served/{{i}}/{{name}}"] = \\
                        np.asarray(value)

    drive(server, np.random.default_rng({seed} + parts), record)
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module", params=("urand", "rmat"))
def reference(request, tmp_path_factory):
    family = request.param
    out = str(tmp_path_factory.mktemp(f"dyn_{family}") / "ref")
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, stream=_STREAM, family=family, n=STREAM_N,
        seed=STREAM_SEED, parts=STREAM_PARTS,
        served_parts=SERVED_PARTS if family == "urand" else (),
        coo=COO_KEYS, serve_after=SERVE_AFTER, served=SERVED, out=out),
        devices=max(STREAM_PARTS), timeout=900)
    assert "REFERENCE-OK" in log
    return family, json.load(open(out + ".json")), np.load(out + ".npz")


_ns: dict = {"np": np}
exec(_STREAM, _ns)


def _state(eng, dyn) -> dict:
    g = eng.g
    host = {k: getattr(g, k) for k in COO_KEYS}
    host.update(g.ell_arrays)
    return {"host": host, "dev": {k: t.numpy() for k, t in dyn.garr.items()}}


def _same_state(got: dict, arrays, pre: str) -> None:
    for kind in ("host", "dev"):
        want = {k.rsplit("/", 1)[1] for k in arrays.files
                if k.startswith(f"{pre}/{kind}/")}
        assert set(got[kind]) == want, (pre, kind)
        for k, a in got[kind].items():
            b = arrays[f"{pre}/{kind}/{k}"]
            assert a.dtype == b.dtype and a.shape == b.shape \
                and a.tobytes() == b.tobytes(), f"{pre} {kind} {k}"


@pytest.mark.parametrize("parts", STREAM_PARTS)
def test_stream_matches_reference(reference, parts):
    """After every step of the fixed stream: equal samples, equal stats
    but apply_s, every host mirror and device array byte-identical; a
    planner restored after "mixed" replays the rest into the same
    slots."""
    family, meta, arrays = reference
    edges, n = oracle.family_edges(family, STREAM_N, STREAM_SEED)
    eng = GraphEngine(partition_graph(edges, n, parts), device="cpu")
    server = GraphServer(eng, buckets=(4,))
    serve = family == "urand" and parts in SERVED_PARTS
    if serve:
        server.serve([Query(make_key(a)) for a in ("cc", "kcore",
                                                   "pagerank")])
    steps, saved = [], {}

    def record(step, stats, ins, dels):
        pre = f"{parts}/{step}"
        steps.append(step)
        for name, a in (("ins", ins), ("dels", dels)):
            want = arrays[f"{pre}/sample/{name}"]
            got = np.zeros((0, 2), np.int64) if a is None else np.asarray(a)
            np.testing.assert_array_equal(got, want, err_msg=pre + name)
        got = None if stats is None else {
            k: v for k, v in vars(stats).items() if k != "apply_s"}
        assert got == meta[pre], pre
        dyn = server.dynamic_graph()
        if step == "mixed":              # the stream covers duplicates
            live = saved["live"] - set(map(tuple, dels.tolist()))
            assert any(tuple(e) in live for e in ins.tolist()), \
                "no second instance of a live edge in the mixed batch"
        saved["live"] = set(map(tuple, dyn.current_edges().tolist()))
        _same_state(_state(eng, dyn), arrays, pre)
        if step == "mixed":
            saved["restore"] = pickle.dumps((dyn.planner_state(),
                                             copy.deepcopy(eng.g)))
        if serve and step in SERVE_AFTER:
            for i, (algo, variant, root) in enumerate(SERVED):
                (res,) = server.serve([Query(make_key(f"{algo}/{variant}"),
                                             root)])
                want = meta[f"{pre}/served/{i}"]
                what = f"{pre} {algo}/{variant}"
                assert (res.status, res.epoch, res.rounds) == (
                    want["status"], want["epoch"], want["rounds"]), what
                assert sorted(res.fields) == want["fields"], what
                for name, value in res.fields.items():
                    _same_field(algo, variant, name, np.asarray(value),
                                arrays[f"{pre}/served/{i}/{name}"],
                                f"{what} {name}")

    _ns["drive"](server, np.random.default_rng(STREAM_SEED + parts), record)
    assert tuple(steps) == STEPS
    assert [m["rebuild"] for m in server.mutation_log] == \
        [False, False, False, True, False, False]

    # a planner restored from its picklable state replays into the same
    # slots: the rest of the stream from "mixed"'s state
    state, g = pickle.loads(saved["restore"])
    eng2 = GraphEngine(g, device="cpu")
    dyn2 = mutation_mod.DynamicGraph(eng2, planner_state=state)
    assert dyn2.epoch == 2
    for step in STEPS[3:]:
        pre = f"{parts}/{step}"
        dyn2.apply(arrays[f"{pre}/sample/ins"], arrays[f"{pre}/sample/dels"])
        _same_state(_state(eng2, dyn2), arrays, pre)
