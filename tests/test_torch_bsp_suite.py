"""The rest of the BSP suite in the port against the JAX package's: sssp,
cc, kcore, betweenness and triangles at parts {1, 2, 4} x {urand,
smallworld, rmat}, N=384, seed 5, root 2:

  * every port run passes the NumPy oracle (tests/oracle.py) with the
    conformance parameters;
  * round counts EQUAL the reference's;
  * sssp distances, cc labels, kcore cores and degeneracy, triangle
    counts and total are bit-identical to the reference's; betweenness
    dist is equal and sigma / bc are within the oracle's tolerances of
    the reference's (equal on urand and smallworld; on rmat's hub rows,
    wider than 32 slots, the reference does not add left to right);
  * per-round wire bytes per exchange op equal the reference's telemetry
    wire report, for every program but betweenness (its two phases'
    exchanges differ, and the reference reports them per traced body);
  * batched bfs/fast, sssp and betweenness (B = 4 roots) equal the
    reference's ``program(..., batch=4)`` outputs and rounds, and row 0
    equals the single-source run bit for bit.

The reference runs in one multi-device subprocess per family."""

import json
import os

import numpy as np
import pytest

import oracle
from conftest import run_with_devices
from repro_torch.core import GraphEngine, partition_graph

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
PARTS = (1, 2, 4)
N, SEED, ROOT = 384, 5, 2
BATCH_ROOTS = (ROOT, 0, 1, 7)        # root 0 reaches nothing in rmat
PROGRAMS = ("sssp", "cc", "kcore", "betweenness", "triangles")
BATCHED = (("bfs", "fast"), ("sssp", "default"),
           ("betweenness", "default"))
ROOTED = ("bfs", "sssp", "betweenness")

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
    for algo in {programs!r}:
        params = oracle.CONFORMANCE_PARAMS.get((algo, "default"), {{}})
        prog = eng.program(algo, telemetry=True, **params)
        args = (garr, jnp.int32({root})) if algo in {rooted!r} else (garr,)
        *outs, rounds, series = prog(*args)
        cell = f"{{algo}}/{{parts}}"
        meta[cell] = {{"rounds": int(rounds),
                      "wire": prog.run_telemetry(series).wire}}
        p = prog.program
        for name, o, is_v in zip(p.output_names, outs, p.output_is_vertex):
            if is_v:
                arrays[f"{{cell}}/{{name}}"] = eng.gather_vertex_field(o)
            else:
                meta[cell][name] = int(o)
    roots = jnp.asarray({batch_roots!r}, jnp.int32)
    for algo, variant in {batched!r}:
        prog = eng.program(algo, variant, batch=len({batch_roots!r}))
        *outs, rounds = prog(garr, roots)
        cell = f"{{algo}}_{{variant}}_x/{{parts}}"
        meta[cell] = {{"rounds": np.asarray(rounds).tolist()}}
        for name, o in zip(prog.program.output_names, outs):
            arrays[f"{{cell}}/{{name}}"] = eng.gather_batched_vertex_field(o)
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


def reference(family, tmp_dir):
    """The reference's outputs, rounds and wire for ``family``: (meta
    dict, npz arrays)."""
    out = os.path.join(str(tmp_dir), family)
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, family=family, n=N, seed=SEED, parts=PARTS,
        programs=PROGRAMS, rooted=ROOTED, root=ROOT,
        batch_roots=BATCH_ROOTS, batched=BATCHED, out=out),
        devices=max(PARTS), timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out + ".json")), dict(np.load(out + ".npz"))


def port_engines(family):
    edges, n = oracle.family_edges(family, N, SEED)
    return edges, n, {parts: GraphEngine(partition_graph(edges, n, parts),
                                         device="cpu") for parts in PARTS}


def _ref_wire(wire: dict, phase: str) -> dict:
    out = {}
    for key, cell in wire.items():
        ph, op = key.rsplit("/", 1)
        if ph == phase:
            out[op] = out.get(op, 0) + cell["bytes"]
    return out


def _compare(algo, name, got, want, what):
    """Bit-identical, but betweenness's float32 sigma and bc: within the
    oracle's tolerances (the reference's row sums over ELL rows wider
    than 32 slots are not added left to right, so hub rows of rmat
    differ in the last bits)."""
    if algo == "betweenness" and name == "sigma":
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=what)
    elif algo == "betweenness" and name == "bc":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        assert np.asarray(got).dtype == np.asarray(want).dtype, what
        np.testing.assert_array_equal(got, want, err_msg=what)


def check_program(family, algo, ref, port):
    """One BSP program of the port at every parts count against the
    oracle and the reference's outputs, rounds and wire."""
    meta, arrays = ref
    edges, n, engines = port
    params = oracle.CONFORMANCE_PARAMS.get((algo, "default"), {})
    for parts, eng in engines.items():
        cell = f"{algo}/{parts}"
        what = f"{cell} family={family}"
        garr = eng.device_graph()
        eng.comm.reset_wire()
        prog = eng.program(algo, **params)
        *outs, rounds = prog(garr, *([ROOT] if algo in ROOTED else []))
        p = prog.program
        fields = {nm: (eng.gather_vertex_field(o) if isv else o)
                  for nm, o, isv in zip(p.output_names, outs,
                                        p.output_is_vertex)}
        oracle.check_conformance(algo, "default", fields, edges, n, ROOT)
        assert rounds == meta[cell]["rounds"], what
        for name, got in fields.items():
            _compare(algo, name, got,
                     arrays.get(f"{cell}/{name}", meta[cell].get(name)),
                     what)
        if algo != "betweenness":
            per_round = {op: b // rounds
                         for op, b in eng.comm.wire_by_op().items()}
            assert per_round == _ref_wire(meta[cell]["wire"], "round"), what
            assert eng.comm.wire_by_op("init") \
                == _ref_wire(meta[cell]["wire"], "init"), what


def check_batched(family, algo, variant, ref, port):
    """The batched build at every parts count against the reference's
    batched outputs and rounds; row 0 against the single-source run."""
    meta, arrays = ref
    _, _, engines = port
    for parts, eng in engines.items():
        cell = f"{algo}_{variant}_x/{parts}"
        what = f"{cell} family={family}"
        garr = eng.device_graph()
        prog = eng.program(algo, variant, batch=len(BATCH_ROOTS))
        *outs, rounds = prog(garr, BATCH_ROOTS)
        assert list(rounds) == meta[cell]["rounds"], what
        *single, single_rounds = eng.program(algo, variant)(garr, ROOT)
        assert rounds[0] == single_rounds, what
        for name, o, s in zip(prog.program.output_names, outs, single):
            got = eng.gather_batched_vertex_field(o)
            assert got.shape == (len(BATCH_ROOTS), eng.g.n_orig), what
            np.testing.assert_array_equal(got[0], eng.gather_vertex_field(s),
                                          err_msg=what)
            _compare(algo, name, got, arrays[f"{cell}/{name}"],
                     f"{what} {name}")


@pytest.fixture(scope="module", params=["urand", "smallworld", "rmat"])
def family(request):
    return request.param


@pytest.fixture(scope="module")
def ref(family, tmp_path_factory):
    return reference(family, tmp_path_factory.mktemp("ref"))


@pytest.fixture(scope="module")
def port(family):
    return port_engines(family)


@pytest.mark.parametrize("algo", PROGRAMS)
def test_program_matches_reference_and_oracle(algo, family, ref, port):
    check_program(family, algo, ref, port)


@pytest.mark.parametrize("algo,variant", BATCHED)
def test_batched_matches_reference(algo, variant, family, ref, port):
    check_batched(family, algo, variant, ref, port)
