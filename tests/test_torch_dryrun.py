"""The port's graph dry-run against the JAX package's.

Host code, no devices: ``abstract_graph`` (fields, ELL metas and the
meta tensors of ``abstract_arrays``), the static trip counts, the
parameter overrides and the model FLOPs of all sixteen programs equal
the reference's at 256 and 512 parts on urand22/25/28.  One subprocess
builds the reference's records at parts 8 (``lower_graph_programs``'
steps on an 8-device host mesh; the function itself insists on 256 or
512 devices) for bfs/bsp, bfs/fast, pagerank/bsp and pagerank/fast, and
the port's records are held against them: the same keys plus ``h100``,
the same layout fields and wire bytes per collective.  Two relations
are pinned where the figures cannot be equal:

  * bfs/bsp: the reference has no all-reduce.  Under ``static_iters``
    its frontier count feeds nothing, and XLA drops the psum; the port
    runs it every level (7 bytes a level at 8 parts, 2 (g-1)/g of an
    int32).
  * pagerank/fast: its error psum sits under a ``lax.cond`` that fires
    every ``err_every`` (5) rounds, and the HLO parse prices a
    conditional at its costlier branch every round: the reference
    counts 50 all-reduces, the port the 10 that run.

Every other collective's count, result bytes and wire bytes are equal.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from conftest import REPO, SRC, run_with_devices
from repro.core import dryrun as ref_dryrun
from repro.core import registry as ref_registry
from repro.core.graph import abstract_graph as ref_abstract_graph
from repro.roofline import analysis as ref_analysis
from repro.roofline.jaxpr_cost import count_fn as ref_count_fn

from repro_torch.configs import graph_workloads
from repro_torch.core import GraphEngine, dryrun, partition_graph, registry
from repro_torch.core.graph import abstract_graph
from repro_torch.graphs import urand_edges
from repro_torch.roofline import analysis
from repro_torch.roofline.jaxpr_cost import count_fn

PROGRAMS = ("bfs_bsp", "bfs_fast", "pagerank_bsp", "pagerank_fast")
GRAPH = "urand16"


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Many small tensor ops: one intra-op thread a worker keeps the test
    workers, which share the cores, from oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _metas(g):
    return {name: (m.name, m.n_rows, tuple(map(tuple, m.buckets)), m.slots,
                   m.sentinel, tuple(m.device_suffixes))
            for name, m in g.ell_meta.items()}


@pytest.mark.parametrize("parts", [256, 512])
@pytest.mark.parametrize("graph", ["urand22", "urand25", "urand28"])
def test_abstract_graph_and_model_flops_match_reference(graph, parts):
    cfg = graph_workloads.ALL[graph]
    g = abstract_graph(cfg.num_vertices, cfg.avg_degree, parts)
    r = ref_abstract_graph(cfg.num_vertices, cfg.avg_degree, parts)
    assert (g.n, g.n_orig, g.parts, g.n_local, g.e_max) \
        == (r.n, r.n_orig, r.parts, r.n_local, r.e_max)
    assert _metas(g) == _metas(r)
    assert g.layout_signature() == r.layout_signature()
    assert registry.available() == ref_registry.available()
    for algo, _ in registry.available():
        it = dryrun.STATIC_ITERS.get(algo, dryrun.DEFAULT_STATIC_ITERS)
        it = parts if it == "parts" else it
        assert dryrun._graph_model_flops(g, algo, it) \
            == ref_dryrun._graph_model_flops(r, algo, it), algo


def test_static_iters_and_params_match_reference():
    assert dryrun.STATIC_ITERS == ref_dryrun.STATIC_ITERS
    assert dryrun.DEFAULT_STATIC_ITERS == ref_dryrun.DEFAULT_STATIC_ITERS
    assert dryrun.DRYRUN_PARAMS == ref_dryrun.DRYRUN_PARAMS
    assert (analysis.PEAK_FLOPS_BF16, analysis.HBM_BW,
            analysis.ICI_LINK_BW) == (ref_analysis.PEAK_FLOPS_BF16,
                                      ref_analysis.HBM_BW,
                                      ref_analysis.ICI_LINK_BW)


@pytest.mark.parametrize("layout", ["ell", "coo"])
def test_abstract_arrays_match_reference(layout):
    g = abstract_graph(1 << 16, 16, 8)
    r = ref_abstract_graph(1 << 16, 16, 8)
    got = g.abstract_arrays(layout)
    want = r.abstract_arrays(layout)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        assert t.is_meta and t.dtype == torch.int32, k
        assert tuple(t.shape) == tuple(want[k].shape), k


@pytest.mark.parametrize("op,ref_op", [
    ("sum", "reduce-scatter"), ("or", "all-to-all"), ("min", "all-to-all"),
    ("bcast", "all-gather"), ("perm", "collective-permute"),
    ("psum", "all-reduce")])
@pytest.mark.parametrize("parts", [2, 8, 256])
def test_ring_model_matches_reference(op, ref_op, parts):
    """The tallied bytes of one part, priced as the collective the JAX
    package lowers the exchange to: the same result and wire bytes as its
    ``CollectiveStats.add`` on that collective's result shape."""
    tallied = 4096 * parts
    got = analysis.collective_stats({("round", op): (tallied, 1)}, parts)
    result = {"sum": tallied // parts, "bcast": tallied * parts}.get(
        op, tallied)
    want = ref_analysis.CollectiveStats()
    want.add(ref_op, result, parts)
    assert got["counts"] == want.counts
    assert got["raw_bytes"] == pytest.approx(want.raw_bytes, rel=1e-12)
    assert got["wire_bytes"] == pytest.approx(want.wire_bytes, rel=1e-12)


def test_matmul_flops_match_reference_count():
    """A matmul is 2·M·N·K in both counters (einsum in the port reaches
    bmm, jnp.einsum a dot_general)."""
    x = np.zeros((3, 64, 32), np.float32)
    w = np.zeros((3, 32, 16), np.float32)
    got = count_fn(lambda a, b: torch.einsum("bmk,bkn->bmn", a, b),
                   torch.from_numpy(x), torch.from_numpy(w))
    want = ref_count_fn(lambda a, b: jax.numpy.einsum("bmk,bkn->bmn", a, b),
                        x, w)
    assert got.matmul_flops == want.matmul_flops == 2 * 3 * 64 * 32 * 16


_REF_RECORDS = r"""
import json, sys, time
from repro.configs import graph_workloads
from repro.core import localops, registry
from repro.core.api import GraphEngine
from repro.core.dryrun import (DEFAULT_STATIC_ITERS, DRYRUN_PARAMS,
                               STATIC_ITERS, _graph_model_flops)
from repro.core.graph import abstract_graph
from repro.core.registry import program_label
from repro.launch.mesh import make_graph_mesh
from repro.roofline import analysis as RA
from repro.roofline.jaxpr_cost import count_fn
parts, graph, labels = 8, {graph!r}, {labels!r}
cfg = graph_workloads.ALL[graph]
g = abstract_graph(cfg.num_vertices, cfg.avg_degree, parts)
eng = GraphEngine(g, make_graph_mesh(parts))
out = {{}}
for algo, variant in registry.available():
    label = program_label(algo, variant)
    if label not in labels:
        continue
    it = STATIC_ITERS.get(algo, DEFAULT_STATIC_ITERS)
    prog = eng.program(algo, variant, static_iters=it,
                       **dict(DRYRUN_PARAMS.get((algo, variant), {{}})))
    t0 = time.time()
    compiled = prog.aot()
    mem = compiled.memory_analysis()
    roof = RA.analyze(compiled, arch=f"graph-{{label}}", shape_name=graph,
                      mesh_name="p8", devices=parts,
                      model_flops_total=_graph_model_flops(g, algo, it))
    if (algo, variant) == ("pagerank", "fast"):
        rs = roof.collectives["wire_bytes"].get("reduce-scatter", 0.0)
        roof.collective_wire_bytes -= rs / 2.0
        roof.collectives["wire_bytes"]["reduce-scatter"] = rs / 2.0
        roof.collectives["raw_bytes"]["reduce-scatter"] /= 2.0
        roof.finalize()
    cost = count_fn(prog.fn, *prog.abstract_args)
    roof.flops_per_device = cost.total_flops / parts
    roof.bytes_per_device = cost.bytes_touched / parts / 3.0
    roof.finalize()
    rec = roof.to_json()
    rec["jaxpr_matmul_flops_total"] = cost.matmul_flops
    rec["jaxpr_elementwise_flops_total"] = cost.elementwise_flops
    rec["jaxpr_bytes_unfused_total"] = cost.bytes_touched
    rec.update({{
        "program": label, "exec_mode": prog.spec.exec_mode,
        "lower_compile_s": round(time.time() - t0, 2),
        "arg_bytes_per_device": mem.argument_size_in_bytes,
        "temp_bytes_per_device": mem.temp_size_in_bytes,
        "status": "ok", "n_vertices": g.n, "e_max_per_part": g.e_max,
        "layout": eng.layout,
        "ell_slots_per_part": {{n: m.slots for n, m in g.ell_meta.items()}},
        "localops_impl": localops.resolve()}})
    out[label] = rec
print("RECORDS" + json.dumps(out))
"""


@pytest.fixture(scope="module")
def records():
    """The reference's records at parts 8 (one subprocess; its raw
    reduce-scatter bytes halved with the wire, the f32 promotion the
    reference corrects) and the port's."""
    out = run_with_devices(_REF_RECORDS.format(graph=GRAPH,
                                               labels=PROGRAMS), devices=8)
    ref = json.loads(out.split("RECORDS")[-1])
    port = {r["program"]: r for r in dryrun.lower_graph_programs(
        GRAPH, "p8", algos=PROGRAMS, parts=8)}
    return ref, port


LAYOUT_KEYS = ("program", "exec_mode", "status", "n_vertices",
               "e_max_per_part", "layout", "ell_slots_per_part",
               "localops_impl", "devices", "model_flops_total", "arch",
               "shape")


@pytest.mark.parametrize("label", PROGRAMS)
def test_record_keys_and_layout_match_reference(records, label):
    ref, port = records
    r, p = ref[label], port[label]
    assert set(p) == set(r) | {"h100"}
    for k in LAYOUT_KEYS:
        assert p[k] == r[k], k
    assert set(p["collectives"]) == set(r["collectives"])
    h = p["h100"]
    assert h["bottleneck"] in ("compute", "memory", "collective")
    assert h["memory_s"] == pytest.approx(
        p["bytes_per_device"] / analysis.H100_HBM_BW)


@pytest.mark.parametrize("label", PROGRAMS)
def test_wire_bytes_match_reference(records, label):
    ref, port = records
    rc, pc = ref[label]["collectives"], port[label]["collectives"]
    all_reduce = 2 * 7 / 8 * 4          # one int32/f32 psum at 8 parts
    extra = {"bfs_bsp": {"all-reduce": (8, 8 * all_reduce)},
             "pagerank_fast": {"all-reduce": (10 - 50, (10 - 50)
                                              * all_reduce)}}.get(label, {})
    ops = set(rc["wire_bytes"]) | set(pc["wire_bytes"])
    for op in ops:
        d_count, d_wire = extra.get(op, (0, 0.0))
        assert pc["counts"].get(op, 0) - rc["counts"].get(op, 0) \
            == d_count, (op, pc, rc)
        assert pc["wire_bytes"].get(op, 0.0) \
            == pytest.approx(rc["wire_bytes"].get(op, 0.0) + d_wire,
                             abs=1e-6), (op, pc, rc)
        if op != "all-reduce":
            assert pc["raw_bytes"][op] == pytest.approx(
                rc["raw_bytes"][op], rel=1e-12), op


@pytest.mark.parametrize("algo,variant", [
    ("bfs", "bsp"), ("bfs", "fast"), ("pagerank", "bsp"),
    ("pagerank", "fast"), ("sssp", "default"), ("betweenness", "default"),
    ("pagerank", "async")])
def test_counted_flops_grow_linearly_in_static_iters(algo, variant):
    """Every round of a static_iters run is counted (XLA's cost analysis
    counts a while body once): rounds 10-20 cost twice rounds 5-10."""
    g = abstract_graph(1 << 12, 16, 4)
    eng = dryrun.plan_engine(g)
    garr = g.abstract_arrays()
    params = dryrun.DRYRUN_PARAMS.get((algo, variant), {})
    cost = {it: dryrun.plan_program(eng, garr, algo, variant, it,
                                    **params)[1] for it in (5, 10, 20)}
    for field in ("total_flops", "bytes_touched"):
        a, b, c = (getattr(cost[it], field) for it in (5, 10, 20))
        assert b > a and c - b == 2 * (b - a), (field, a, b, c)


def test_measured_run_matches_plan_on_cpu():
    """measure_vs_plan on a real graph on the CPU: planned argument bytes
    are the resident arrays' bytes, and pagerank's planned exchanges are
    the ones its run ships (bfs/fast's plan pushes every level, its run
    only while the frontier is small)."""
    n = 1 << 12
    eng = GraphEngine(partition_graph(urand_edges(n, 16 * n, seed=42), n, 2),
                      device="cpu")
    garr = eng.device_graph()
    for algo, variant in (("pagerank", "bsp"), ("pagerank", "fast"),
                          ("bfs", "fast")):
        r = dryrun.measure_vs_plan(eng, garr, algo, variant, 6,
                                   **dryrun.DRYRUN_PARAMS.get(
                                       (algo, variant), {}))
        assert r["planned_arg_bytes"] == r["resident_bytes"] > 0
        assert r["measured_peak_bytes"] is None
        assert r["planned_temp_bytes"] > 0
        if algo == "pagerank":
            assert r["planned_wire"] == r["run_wire"], r
        else:
            assert r["planned_wire"]["bcast"] == r["run_wire"]["bcast"]
            assert r["planned_wire"]["or"][1] >= r["run_wire"]["or"][1]


def test_urand28_plans_every_program_at_production_parts():
    """Sixteen of sixteen programs plan at 256 and 512 parts on urand28,
    on meta tensors, with the reference's layout fields."""
    cfg = graph_workloads.ALL["urand28"]
    for mesh, parts in (("pod", 256), ("multipod", 512)):
        recs = dryrun.lower_graph_programs("urand28", mesh)
        r = ref_abstract_graph(cfg.num_vertices, cfg.avg_degree, parts)
        assert [rec["program"] for rec in recs] == [
            ref_registry.program_label(a, v)
            for a, v in ref_registry.available()]
        for rec in recs:
            assert rec["status"] == "ok" and rec["devices"] == parts
            assert (rec["n_vertices"], rec["e_max_per_part"]) == (r.n,
                                                                  r.e_max)
            assert rec["ell_slots_per_part"] == {
                k: m.slots for k, m in r.ell_meta.items()}
            assert rec["arg_bytes_per_device"] > 0
            assert rec["bottleneck"] in ("compute", "memory", "collective")


def test_cli_writes_records_and_refuses_arch(tmp_path):
    """--graph writes its 32 records as before; --arch (here the smoke
    config, one card) now writes its cells' records beside them."""
    env = dict(os.environ, PYTHONPATH=SRC)
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--graph",
         GRAPH, "--mesh", "both", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=600, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    names = sorted(p.name for p in tmp_path.iterdir())
    want = sorted(f"graph-{ref_registry.program_label(a, v)}__{GRAPH}__{m}"
                  f".json" for a, v in ref_registry.available()
                  for m in ("pod", "multipod"))
    assert names == want
    rec = json.loads((tmp_path / names[0]).read_text())
    assert rec["status"] == "ok" and "h100" in rec
    assert "matmul_flops_per_s" not in rec["h100"]
    assert rec["h100"]["compute_s"] == pytest.approx(
        rec["flops_per_device"] / analysis.H100_PEAK_FLOPS_F32)
    assert r.stdout.count("[graph ") == 32
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "tinyllama-1.1b", "--shape", "train_4k,decode_32k", "--smoke",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=300, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "All dry-run cells passed." in r.stdout
    for shape, program in (("train_4k", "train_step"),
                           ("decode_32k", "serve_step(decode)")):
        rec = json.loads((tmp_path / f"tinyllama-1.1b__{shape}__single"
                                     f".json").read_text())
        assert rec["status"] == "ok" and rec["program"] == program
        assert rec["mesh"] == "single" and rec["devices"] == 1
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        want + [f"tinyllama-1.1b__{s}__single.json"
                for s in ("train_4k", "decode_32k")])
