"""Telemetry of the port against the JAX package's: every registered
program at parts {1, 2, 4} x {urand, smallworld, rmat}, N=384, seed 5,
root 3, with the conformance parameters (``oracle.CONFORMANCE_PARAMS``;
the incremental programs from their cold seeds), plus pagerank/fast with
its default bf16 compression on:

  * the telemetry build's outputs and rounds are bit-identical to the
    plain build's, and the telemetry run passes the NumPy oracle;
  * ``probe_names`` equal the reference's for all sixteen programs;
  * the series rows ``[done, halt, *probes]`` equal the reference's,
    but for pagerank's float32 residual ``err``: the ranks are
    bit-identical on urand and smallworld, yet the port adds a part's
    ``|delta rank|`` in torch's order and XLA's CPU reduce in another,
    so ``err`` agrees within ERR_RTOL there; on rmat the ranks
    themselves differ in the last bits (ROADMAP queue 3) and ``err``
    agrees within ERR_ATOL_RMAT of a unit rank mass.  On rmat,
    pagerank/async's and pagerank/warm's rounds (and so their rows) may
    differ, as tests/test_torch_async.py documents.  Every run that
    converges halts at its last row (at each phase's last row for
    betweenness);
  * wire bytes a round by op equal the reference's on every build whose
    rounds ship the same bytes, and the one-shot init / outputs cells
    equal it everywhere.  Where the reference counts an exchange under
    a ``lax.cond`` on both branches (bfs/fast adaptive, pagerank/fast
    and pagerank/warm with compression, pagerank/async at staleness 2,
    betweenness's phases), the port's measured ``wire_bytes_total`` is
    at most the reference's bound at the port's rounds.

The reference runs in one multi-device subprocess per family."""

import json
import os

import numpy as np
import pytest
import torch

import oracle
from conftest import run_with_devices
from repro_torch.core import GraphEngine, incremental, partition_graph, \
    registry

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PARTS = (1, 2, 4)
N, SEED, ROOT = 384, 5, 3
PR_COMPRESS = {"iters": oracle.CONFORMANCE_PR_ITERS, "tol": 1e-12}


def _builds():
    """label -> (algo, variant, params): the sixteen programs with their
    conformance params, and pagerank/fast with compression."""
    out = {f"{a}/{v}": (a, v, oracle.CONFORMANCE_PARAMS.get((a, v), {}))
           for a, v in registry.available()}
    out["pagerank/fast compress"] = ("pagerank", "fast", PR_COMPRESS)
    return out


BUILDS = _builds()
# builds whose rounds do not all ship the same bytes
UPPER_BOUND = ("bfs/fast", "pagerank/fast compress", "pagerank/warm",
               "pagerank/async", "betweenness/default")
# rmat builds whose rounds may differ from the reference's
RMAT_ROUNDS = ("pagerank/async", "pagerank/warm")
# float32 residual probes, summed in another order than the reference's
ERR_RTOL = 1e-6          # 8 ulp: measured up to 1.8e-7 (urand, smallworld)
ERR_ATOL_RMAT = 1e-6     # measured up to 1.2e-7 absolute (rmat)

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import jax.numpy as jnp
import oracle
from repro.core import GraphEngine, incremental, partition_graph, registry
from repro.launch.mesh import make_graph_mesh

edges, n = oracle.family_edges({family!r}, {n}, {seed})
meta = {{"probe_names": {{}}}}
for algo, variant in registry.available():
    spec = registry.get_spec(algo, variant)
    meta["probe_names"][f"{{algo}}/{{variant}}"] = list(
        spec.build(partition_graph(edges, n, 1), **spec.defaults)
        .probe_names)
for parts in {parts!r}:
    g = partition_graph(edges, n, parts)
    eng = GraphEngine(g, make_graph_mesh(parts))
    garr = eng.device_graph()
    for label, (algo, variant, params) in {builds!r}.items():
        spec = registry.get_spec(algo, variant)
        if any(k != "scalar" for k in spec.input_kinds):
            (seed_arr,) = incremental.cold_seed(spec, g)
            args = (garr, eng.scatter_vertex_field(
                seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]))
        else:
            args = (garr,) + (jnp.int32({root}),) * len(spec.inputs)
        prog = eng.program(algo, variant, telemetry=True, **params)
        *outs, rounds, series = prog(*args)
        tel = prog.run_telemetry(series)
        meta[f"{{label}}/{{parts}}"] = {{
            "rounds": int(rounds), "rows": tel.series.rows.tolist(),
            "wire": tel.wire, "summary": tel.summary()}}
json.dump(meta, open({out!r}, "w"))
print("REFERENCE-OK")
"""


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", params=["urand", "smallworld", "rmat"])
def family(request):
    return request.param


@pytest.fixture(scope="module")
def ref(family, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("obs") / f"{family}.json")
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, family=family, n=N, seed=SEED, parts=PARTS,
        builds=BUILDS, root=ROOT, out=out), devices=max(PARTS),
        timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out))


@pytest.fixture(scope="module")
def port(family):
    edges, n = oracle.family_edges(family, N, SEED)
    return edges, n, {parts: GraphEngine(partition_graph(edges, n, parts),
                                         device="cpu") for parts in PARTS}


def _args(eng, spec):
    if any(k != "scalar" for k in spec.input_kinds):
        (seed_arr,) = incremental.cold_seed(spec, eng.g)
        return (eng.scatter_vertex_field(
            seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]),)
    return (ROOT,) * len(spec.inputs)


def _same(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return a.dtype == b.dtype and torch.equal(a, b)
    return a == b


def _cells(wire: dict, phase: str) -> dict:
    return {key: cell for key, cell in wire.items()
            if key.rsplit("/", 1)[0] == phase}


def _oneshot_bytes(wire: dict) -> int:
    return sum(cell["bytes"] for key, cell in wire.items()
               if key.rsplit("/", 1)[0] != "round")


def test_probe_names_match_reference(ref, port):
    _, _, engines = port
    eng = engines[1]
    for key, names in ref["probe_names"].items():
        algo, variant = key.split("/")
        assert list(eng.program(algo, variant).program.probe_names) \
            == names, key
    assert len(ref["probe_names"]) == 16


@pytest.mark.parametrize("label", sorted(BUILDS))
def test_telemetry_matches_reference(label, family, ref, port):
    edges, n, engines = port
    algo, variant, params = BUILDS[label]
    spec = registry.get_spec(algo, variant)
    for parts, eng in engines.items():
        what = f"{label} parts={parts} family={family}"
        want = ref[f"{label}/{parts}"]
        garr = eng.device_graph()
        args = _args(eng, spec)
        *outs, rounds = eng.program(algo, variant, **params)(garr, *args)
        tprog = eng.program(algo, variant, telemetry=True, **params)
        *touts, trounds, series = tprog(garr, *args)
        # telemetry on == telemetry off, bit for bit
        assert trounds == rounds, what
        assert all(_same(a, b) for a, b in zip(outs, touts)), what
        p = tprog.program
        fields = {nm: (eng.gather_vertex_field(o) if isv else o)
                  for nm, o, isv in zip(p.output_names, touts,
                                        p.output_is_vertex)}
        oracle.check_conformance(algo, variant, fields, edges, n, ROOT)
        tel = tprog.run_telemetry(series)
        summ = tel.summary()
        assert tel.series.rounds == rounds, what
        assert series.shape == (
            sum(ph.max_rounds for ph in getattr(p, "phases", (p,))),
            2 + len(p.probe_names)), what
        halt = tel.series.halt()
        phases = getattr(p, "phases", (p,))
        if rounds < sum(ph.max_rounds for ph in phases):
            assert halt.sum() == len(phases) and halt[-1] == 1.0, what
            if len(phases) == 1:
                assert np.all(halt[:-1] == 0.0), what
        if family != "rmat" or label not in RMAT_ROUNDS:
            assert rounds == want["rounds"], what
            rows = tel.series.rows
            want_rows = np.asarray(want["rows"], np.float32)
            assert rows.shape == want_rows.shape, what
            cols = ("done", "halt") + tuple(p.probe_names)
            exact = [i for i, c in enumerate(cols) if c != "err"]
            np.testing.assert_array_equal(rows[:, exact],
                                          want_rows[:, exact], err_msg=what)
            if "err" in cols:
                i = cols.index("err")
                tol = {"atol": ERR_ATOL_RMAT, "rtol": 0.0} \
                    if family == "rmat" else {"atol": 0.0, "rtol": ERR_RTOL}
                np.testing.assert_allclose(rows[:, i], want_rows[:, i],
                                           err_msg=what, **tol)
        for phase in ("init", "outputs"):
            assert _cells(tel.wire, phase) == _cells(want["wire"], phase), \
                what
        ref_round = _cells(want["wire"], "round")
        if label in UPPER_BOUND:
            per_round = sum(want["summary"]["wire_bytes_per_round"]
                            .values())
            assert summ["wire_bytes_total"] <= per_round * rounds \
                + _oneshot_bytes(want["wire"]), what
        else:
            assert _cells(tel.wire, "round") == ref_round, what
            assert summ["wire_bytes_per_round"] \
                == want["summary"]["wire_bytes_per_round"], what
            if rounds == want["rounds"]:
                assert summ["wire_bytes_total"] \
                    == want["summary"]["wire_bytes_total"], what
