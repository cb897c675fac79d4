"""The four main-path programs of the port against the JAX package's, at
parts {1, 2, 4} x {urand, smallworld, rmat} (N=384, seed 5, root 3):

  * every port run passes the NumPy oracle (tests/oracle.py) with the
    conformance parameters;
  * BFS parents and every round count EQUAL the reference's;
  * ranks are within 1e-5 relative of the reference's (1e-4 for
    pagerank/fast with its default bf16 compression on);
  * per-round wire bytes per exchange op equal the reference's
    telemetry wire report, for every build whose exchanges do not hang
    on a data-dependent branch (the reference's trace-time report
    counts both branches of a ``lax.cond``; the port counts what it
    ships).

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
N, SEED, ROOT = 384, 5, 3
PR_PARAMS = {"iters": oracle.CONFORMANCE_PR_ITERS, "tol": 1e-12}

# name -> (algo, variant, params, wire comparable)
CONFIGS = {
    "bfs_bsp": ("bfs", "bsp", {}, True),
    "bfs_fast": ("bfs", "fast", {}, False),
    "bfs_fast_pull": ("bfs", "fast", {"direction": "pull"}, True),
    "bfs_fast_push": ("bfs", "fast", {"direction": "push"}, True),
    "pagerank_bsp": ("pagerank", "bsp",
                     oracle.CONFORMANCE_PARAMS[("pagerank", "bsp")], True),
    "pagerank_fast": ("pagerank", "fast",
                      oracle.CONFORMANCE_PARAMS[("pagerank", "fast")], True),
    "pagerank_fast_compress": ("pagerank", "fast", PR_PARAMS, False),
    "pagerank_fast_always": ("pagerank", "fast",
                             {**PR_PARAMS, "compress": "always"}, True),
}

_REFERENCE = """
import json, sys
sys.path.insert(0, {tests_dir!r})
import numpy as np
import jax.numpy as jnp
import oracle
from repro.core import GraphEngine, partition_graph
from repro.launch.mesh import make_graph_mesh

configs = {configs!r}
edges, n = oracle.family_edges({family!r}, {n}, {seed})
meta, arrays = {{}}, {{}}
for parts in {parts!r}:
    eng = GraphEngine(partition_graph(edges, n, parts),
                      make_graph_mesh(parts))
    garr = eng.device_graph()
    for name, (algo, variant, params) in configs.items():
        prog = eng.program(algo, variant, telemetry=True, **params)
        args = (garr, jnp.int32({root})) if algo == "bfs" else (garr,)
        *outs, rounds, series = prog(*args)
        wire = prog.run_telemetry(series).wire
        meta[f"{{name}}/{{parts}}"] = {{"rounds": int(rounds), "wire": wire}}
        arrays[f"{{name}}/{{parts}}"] = eng.gather_vertex_field(outs[0])
np.savez({out!r} + ".npz", **arrays)
json.dump(meta, open({out!r} + ".json", "w"))
print("REFERENCE-OK")
"""


def _reference(family, tmp_path):
    out = str(tmp_path / family)
    configs = {k: v[:3] for k, v in CONFIGS.items()}
    log = run_with_devices(_REFERENCE.format(
        tests_dir=TESTS_DIR, configs=configs, family=family, n=N, seed=SEED,
        parts=PARTS, root=ROOT, out=out), devices=max(PARTS), timeout=900)
    assert "REFERENCE-OK" in log
    return json.load(open(out + ".json")), np.load(out + ".npz")


def _ref_wire(wire: dict, phase: str) -> dict:
    out = {}
    for key, cell in wire.items():
        ph, op = key.rsplit("/", 1)
        if ph == phase:
            out[op] = out.get(op, 0) + cell["bytes"]
    return out


@pytest.mark.parametrize("family", ["urand", "smallworld", "rmat"])
def test_programs_match_reference_and_oracle(family, tmp_path):
    ref_meta, ref_arrays = _reference(family, tmp_path)
    edges, n = oracle.family_edges(family, N, SEED)
    for parts in PARTS:
        eng = GraphEngine(partition_graph(edges, n, parts), device="cpu")
        garr = eng.device_graph()
        for name, (algo, variant, params, wire_ok) in CONFIGS.items():
            cell = f"{name}/{parts} family={family}"
            eng.comm.reset_wire()
            prog = eng.program(algo, variant, **params)
            *outs, rounds = prog(garr, *([ROOT] if algo == "bfs" else []))
            p = prog.program
            fields = {nm: (eng.gather_vertex_field(o) if isv else o)
                      for nm, o, isv in zip(p.output_names, outs,
                                            p.output_is_vertex)}
            ref = ref_meta[f"{name}/{parts}"]
            assert rounds == ref["rounds"], cell
            got, want = fields[p.output_names[0]], \
                ref_arrays[f"{name}/{parts}"]
            if algo == "bfs":
                np.testing.assert_array_equal(got, want, err_msg=cell)
            else:
                tol = 1e-4 if name == "pagerank_fast_compress" else 1e-5
                rel = np.abs(got - want).max() / np.abs(want).max()
                assert rel < tol, f"{cell}: rank rel diff {rel:.2e}"
            if name in ("bfs_bsp", "bfs_fast", "pagerank_bsp",
                        "pagerank_fast"):
                oracle.check_conformance(algo, variant, fields, edges, n,
                                         ROOT)
            if wire_ok:
                per_round = {op: b // rounds
                             for op, b in eng.comm.wire_by_op().items()}
                assert per_round == _ref_wire(ref["wire"], "round"), cell
                assert eng.comm.wire_by_op("init") \
                    == _ref_wire(ref["wire"], "init"), cell
