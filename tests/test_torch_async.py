"""The async programs of the port against the JAX package's: bfs/async,
sssp/async, cc/async and pagerank/async at parts {1, 2, 4} x {urand,
smallworld, rmat}, N=384, seed 5, root 2, with the conformance
parameters (pagerank/async at staleness 2):

  * every port run passes the NumPy oracle (tests/oracle.py);
  * bfs, sssp and cc give outputs bit-identical to the reference's and
    EQUAL rounds; pagerank/async gives equal rounds and ``max_age`` and a
    rank within ``oracle.ASYNC_PR_REL_TOL`` of the reference's, except
    that on rmat its rounds may differ: the reference's row sums over
    ELL rows wider than 32 slots are not added left to right
    (``test_rmat_sums_differ_only_on_rows_past_32_slots`` pins that the
    sums differ there and only there), and the halt test reads a
    residual at float32's noise floor;
  * per-round wire bytes per op equal the reference's telemetry report
    for the monotone programs, and for pagerank/async at staleness 1.
    At staleness 2 the reference reports the bytes of one traced round
    body (its refresh branch) while the port counts what it ships, so
    the port's round bytes are the reference's times the refreshes;
  * batched bfs/async and sssp/async (B = 4 roots) equal the reference's
    ``program(..., batch=4)`` outputs and rounds.

Then the contracts of tests/test_async.py against the port's own engine:
the rounds slack, exec_mode resolution, conflicts and the cache key,
static_iters, batched rows against single-source runs, and one host
sync a round.  The reference runs in one multi-device subprocess per
family."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import oracle
from conftest import run_with_devices
from repro.core import superstep as ref_superstep
from repro_torch.core import GraphEngine, partition_graph, registry
from repro_torch.core.superstep import ASYNC_ROUNDS_SLACK_CONST, \
    ASYNC_ROUNDS_SLACK_FACTOR

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PARTS = (1, 2, 4)
N, SEED, ROOT = 384, 5, 2
BATCH_ROOTS = (ROOT, 0, 1, 7)        # root 0 reaches nothing in rmat
ASYNC = ("bfs", "sssp", "cc", "pagerank")
ROOTED = ("bfs", "sssp")
STALENESS = (1, oracle.ASYNC_PR_STALENESS)

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import jax.numpy as jnp
import oracle
from repro.core import GraphEngine, partition_graph
from repro.launch.mesh import make_graph_mesh

edges, n = oracle.family_edges({family!r}, {n}, {seed})
meta, arrays = {{}}, {{}}
for parts in {parts!r}:
    eng = GraphEngine(partition_graph(edges, n, parts),
                      make_graph_mesh(parts))
    garr = eng.device_graph()
    runs = [(algo, "", oracle.CONFORMANCE_PARAMS.get((algo, "async"), {{}}))
            for algo in {algos!r}]
    runs += [("pagerank", f"_s{{s}}",
              {{**oracle.CONFORMANCE_PARAMS[("pagerank", "async")],
                "staleness": s}}) for s in {staleness!r}]
    for algo, tag, params in runs:
        prog = eng.program(algo, "async", telemetry=True, **params)
        args = (garr, jnp.int32({root})) if algo in {rooted!r} else (garr,)
        *outs, rounds, series = prog(*args)
        cell = f"{{algo}}{{tag}}/{{parts}}"
        meta[cell] = {{"rounds": int(rounds),
                      "wire": prog.run_telemetry(series).wire}}
        p = prog.program
        for name, o, is_v in zip(p.output_names, outs, p.output_is_vertex):
            if is_v:
                arrays[f"{{cell}}/{{name}}"] = eng.gather_vertex_field(o)
            else:
                meta[cell][name] = float(o)
    roots = jnp.asarray({batch_roots!r}, jnp.int32)
    for algo in {rooted!r}:
        prog = eng.program(algo, "async", batch=len({batch_roots!r}))
        *outs, rounds = prog(garr, roots)
        cell = f"{{algo}}_x/{{parts}}"
        meta[cell] = {{"rounds": np.asarray(rounds).tolist()}}
        for name, o in zip(prog.program.output_names, outs):
            arrays[f"{{cell}}/{{name}}"] = eng.gather_batched_vertex_field(o)
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


def reference(family, tmp_dir):
    """The reference's async outputs, rounds and wire for ``family``."""
    out = os.path.join(str(tmp_dir), family)
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, family=family, n=N, seed=SEED, parts=PARTS,
        algos=ASYNC, staleness=STALENESS, rooted=ROOTED, root=ROOT,
        batch_roots=BATCH_ROOTS, out=out),
        devices=max(PARTS), timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out + ".json")), dict(np.load(out + ".npz"))


def _ref_wire(wire: dict, phase: str) -> dict:
    out = {}
    for key, cell in wire.items():
        ph, op = key.rsplit("/", 1)
        if ph == phase:
            out[op] = out.get(op, 0) + cell["bytes"]
    return out


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tests run many small tensor ops; one intra-op thread a
    worker keeps the test workers, which share the cores, from
    oversubscribing them (8 threads each thrash under load)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["urand", "smallworld", "rmat"])
def family(request):
    return request.param


@pytest.fixture(scope="module")
def ref(family, tmp_path_factory):
    return reference(family, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port(family):
    edges, n = oracle.family_edges(family, N, SEED)
    return edges, n, {parts: GraphEngine(partition_graph(edges, n, parts),
                                         device="cpu") for parts in PARTS}


def run_async(eng, algo, **params):
    """One async run from a fresh wire count: (fields, rounds)."""
    garr = eng.device_graph()
    eng.comm.reset_wire()
    prog = eng.program(algo, "async", **params)
    *outs, rounds = prog(garr, *([ROOT] if algo in ROOTED else []))
    p = prog.program
    return {nm: (eng.gather_vertex_field(o) if isv else o)
            for nm, o, isv in zip(p.output_names, outs,
                                  p.output_is_vertex)}, rounds


@pytest.mark.parametrize("algo", ASYNC)
def test_async_matches_reference_and_oracle(algo, family, ref, port):
    meta, arrays = ref
    edges, n, engines = port
    params = oracle.CONFORMANCE_PARAMS.get((algo, "async"), {})
    for parts, eng in engines.items():
        cell = f"{algo}/{parts}"
        what = f"{cell} family={family}"
        fields, rounds = run_async(eng, algo, **params)
        oracle.check_conformance(algo, "async", fields, edges, n, ROOT)
        if algo == "pagerank":
            rel = np.abs(fields["rank"] - arrays[f"{cell}/rank"]).max() \
                / arrays[f"{cell}/rank"].max()
            assert rel < oracle.ASYNC_PR_REL_TOL, what
            assert fields["max_age"] == meta[cell]["max_age"], what
            assert fields["max_age"] <= oracle.ASYNC_PR_AGE_BOUND, what
            if family != "rmat":
                assert rounds == meta[cell]["rounds"], what
            continue
        assert rounds == meta[cell]["rounds"], what
        for name, got in fields.items():
            want = arrays[f"{cell}/{name}"]
            assert got.dtype == want.dtype, what
            np.testing.assert_array_equal(got, want, err_msg=what)
        per_round = {op: b // rounds
                     for op, b in eng.comm.wire_by_op().items()}
        assert per_round == _ref_wire(meta[cell]["wire"], "round"), what
        for phase in ("init", "outputs"):
            assert eng.comm.wire_by_op(phase) \
                == _ref_wire(meta[cell]["wire"], phase), what


@pytest.mark.parametrize("staleness", STALENESS)
def test_pagerank_async_staleness_wire(staleness, family, ref, port):
    """Wire per refresh equals the reference's traced round body; at
    staleness 1 every round refreshes, so the port's bytes per round
    equal the reference's report.  ``max_age`` stays within 2s + 1."""
    meta, arrays = ref
    _, _, engines = port
    params = {**oracle.CONFORMANCE_PARAMS[("pagerank", "async")],
              "staleness": staleness}
    for parts, eng in engines.items():
        cell = f"pagerank_s{staleness}/{parts}"
        what = f"{cell} family={family}"
        fields, rounds = run_async(eng, "pagerank", **params)
        if family != "rmat":
            assert rounds == meta[cell]["rounds"], what
        assert fields["max_age"] == meta[cell]["max_age"] \
            <= 2 * staleness + 1, what
        refreshes = -(-rounds // staleness)
        want = {op: b * refreshes
                for op, b in _ref_wire(meta[cell]["wire"], "round").items()}
        assert eng.comm.wire_by_op() == want, what
        if staleness == 1:
            assert {op: b // rounds for op, b in
                    eng.comm.wire_by_op().items()} \
                == _ref_wire(meta[cell]["wire"], "round"), what
        assert eng.comm.wire_by_op("init") \
            == _ref_wire(meta[cell]["wire"], "init"), what


@pytest.mark.parametrize("algo", ROOTED)
def test_async_batched_matches_reference(algo, family, ref, port):
    meta, arrays = ref
    _, _, engines = port
    for parts, eng in engines.items():
        cell = f"{algo}_x/{parts}"
        what = f"{cell} family={family}"
        garr = eng.device_graph()
        prog = eng.program(algo, "async", batch=len(BATCH_ROOTS))
        *outs, rounds = prog(garr, BATCH_ROOTS)
        assert list(rounds) == meta[cell]["rounds"], what
        for name, o in zip(prog.program.output_names, outs):
            np.testing.assert_array_equal(
                eng.gather_batched_vertex_field(o),
                arrays[f"{cell}/{name}"], err_msg=what)


def test_rmat_sums_differ_only_on_rows_past_32_slots():
    """Why pagerank's rounds may differ on rmat: the first round's push
    sum over ``ell_dst`` equals the reference's bit for bit on every row
    of at most 32 slots, and differs (by a few ulps) only on rows of a
    wider ELL bucket, which rmat's hubs make."""
    import jax.numpy as jnp
    from repro.core import localops as ref_localops
    from repro.core import partition_graph as ref_partition
    from repro_torch.core import GraphShards, localops
    edges, n = oracle.family_edges("rmat", N, SEED)
    g = ref_partition(edges, n, 1)
    ours = GraphShards.from_arrays(dataclasses.asdict(g))
    meta = g.ell_meta["ell_dst"]
    deg = g.out_degree[0].astype(np.float32)
    contrib = np.where(deg > 0, np.float32(1.0 / n) / np.maximum(deg, 1),
                       0).astype(np.float32)
    valid = g.out_dst_global[0] < g.n
    vals = np.where(valid, contrib[g.out_src_local[0]], 0) \
        .astype(np.float32)
    want = np.asarray(ref_localops.scatter_combine(
        {k: v[0] for k, v in g.device_arrays().items()}, meta,
        jnp.asarray(vals), "add", identity=jnp.float32(0.0), mode="auto"))
    got = localops.scatter_combine(
        ours.device_arrays("ell", "cpu"), meta,
        torch.from_numpy(vals)[None], "add", identity=0.0)[0].numpy()
    # each row's slot count: the width K of its ELL bucket
    widths = np.repeat([k for _, k in meta.buckets],
                       [rows for rows, _ in meta.buckets])
    slots = widths[g.ell_arrays["ell_dst_inv"][0]]
    differ = got != want
    assert differ.any() and (slots[differ] > 32).all()
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32))
    assert ulps.max() <= 4


# ---------------------------------------------------------------------------
# the contracts of tests/test_async.py, on the port's own engine
# ---------------------------------------------------------------------------

MONOTONE = (("bfs", {"max_levels": 64}), ("cc", {"max_rounds": 64}),
            ("sssp", {"max_rounds": 64}))


@pytest.fixture(scope="module", params=[1, 4], ids=lambda p: f"p{p}")
def engine(request):
    from repro_torch.graphs import urand_edges
    g = partition_graph(urand_edges(512, 2048, seed=11), 512,
                        request.param)
    return GraphEngine(g, device="cpu")


def _mode_run(eng, algo, exec_mode, params, **kw):
    spec = registry.get_spec(algo, registry.mode_variant(algo, exec_mode))
    prog = eng.program(algo, exec_mode=exec_mode, **params, **kw)
    *outs, rounds = prog(eng.device_graph(), *([3] * len(spec.inputs)))
    return [eng.gather_vertex_field(o) for o, isv in
            zip(outs, prog.program.output_is_vertex) if isv], rounds


def test_slack_constants_match_reference():
    assert ASYNC_ROUNDS_SLACK_FACTOR \
        == ref_superstep.ASYNC_ROUNDS_SLACK_FACTOR
    assert ASYNC_ROUNDS_SLACK_CONST == ref_superstep.ASYNC_ROUNDS_SLACK_CONST


@pytest.mark.parametrize("algo,params", MONOTONE)
def test_async_rounds_within_documented_slack(engine, algo, params):
    """Same outputs, bounded extra rounds, at parts 1 and 4."""
    bsp_outs, bsp_rounds = _mode_run(engine, algo, "bsp", params)
    async_outs, async_rounds = _mode_run(engine, algo, "async", params)
    for b, a in zip(bsp_outs, async_outs):
        np.testing.assert_array_equal(b, a)
    cap = ASYNC_ROUNDS_SLACK_FACTOR * bsp_rounds + ASYNC_ROUNDS_SLACK_CONST
    assert async_rounds <= cap, (algo, async_rounds, bsp_rounds)


def test_exec_mode_resolution_and_cache(engine):
    """exec_mode on a bare algo is the mode's variant, the SAME cache
    entry as naming it; bsp and async builds of one algo coexist."""
    via_mode = engine.program("bfs", exec_mode="async")
    assert via_mode is engine.program("bfs", "async")
    assert via_mode.spec.exec_mode == "async"
    bsp = engine.program("bfs", exec_mode="bsp")
    assert bsp.spec.exec_mode == "bsp"
    assert bsp is engine.program("bfs", bsp.spec.variant)
    a = engine.program("cc", exec_mode="async")
    b = engine.program("cc", exec_mode="bsp")
    assert a is not b and a is engine.program("cc", exec_mode="async")
    assert engine.program("pagerank/async", exec_mode="async") \
        is engine.program("pagerank", "async")


def test_exec_mode_conflicts_raise(engine):
    with pytest.raises(ValueError, match="contradicts"):
        engine.program("bfs", "fast", exec_mode="async")
    with pytest.raises(ValueError, match="contradicts"):
        engine.program("pagerank/async", exec_mode="bsp")
    with pytest.raises(ValueError, match="no async variant.*bfs/async"):
        engine.program("triangles", exec_mode="async")
    with pytest.raises(ValueError, match="exec_mode"):
        engine.program("bfs", exec_mode="speculative")


def test_async_static_iters_parity(engine):
    """A fixed trip count runs exactly static_iters rounds and lands on
    the converged outputs."""
    (dist,), rounds = _mode_run(engine, "sssp", "async", {},
                                static_iters=24)
    assert rounds == 24
    (dist_dyn,), _ = _mode_run(engine, "sssp", "async", {})
    np.testing.assert_array_equal(dist, dist_dyn)


@pytest.mark.parametrize("algo", ROOTED)
def test_async_batched_matches_single_source(engine, algo):
    roots = [0, 3, 17, 200]
    prog = engine.program(algo, exec_mode="async", batch=len(roots))
    garr = engine.device_graph()
    field, rounds = prog(garr, roots)
    batched = engine.gather_batched_vertex_field(field)
    single = engine.program(algo, exec_mode="async")
    for i, r in enumerate(roots):
        out, r_rounds = single(garr, r)
        np.testing.assert_array_equal(batched[i],
                                      engine.gather_vertex_field(out))
        assert rounds[i] == r_rounds


def test_one_host_sync_a_round(engine, monkeypatch):
    """A monotone async round reads its delivered count once (no
    ``psum_scalar``); pagerank/async reads its residual once a refresh.
    Syncs are counted as ``Tensor.item`` calls."""
    calls = {"item": 0, "psum": 0}
    item = torch.Tensor.item

    def counted_item(t):
        calls["item"] += 1
        return item(t)

    def no_psum(x):
        calls["psum"] += 1
        raise AssertionError("psum_scalar in an async program")

    garr = engine.device_graph()
    progs = {algo: engine.program(algo, "async") for algo in ASYNC}
    staleness = 2
    progs["pagerank"] = engine.program("pagerank", "async",
                                       staleness=staleness)
    monkeypatch.setattr(torch.Tensor, "item", counted_item)
    monkeypatch.setattr(engine.comm, "psum_scalar", no_psum)
    for algo, prog in progs.items():
        calls["item"] = 0
        rounds = prog(garr, *([3] if algo in ROOTED else []))[-1]
        want = -(-rounds // staleness) if algo == "pagerank" else rounds
        assert calls["item"] == want, (algo, calls, rounds)
    assert calls["psum"] == 0


def test_bad_async_params_raise(engine):
    with pytest.raises(ValueError, match="local_iters"):
        engine.program("sssp", "async", local_iters=0)
    with pytest.raises(ValueError, match="staleness"):
        engine.program("pagerank", "async", staleness=0)
