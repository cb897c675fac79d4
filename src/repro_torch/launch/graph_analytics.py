"""Graph-analytics launcher: the paper's workload end to end.

Generates a urand/rmat/smallworld graph, cuts it into P vertex blocks
stacked on one device, runs every registered program (BFS and PageRank,
each in its BSP baseline and its HPX-adapted fast variant, SSSP, CC,
triangle counting, k-core, betweenness), verifies the results, and
reports per-program times, rounds and kernel launch counts.  The
incremental variants (pagerank/warm, cc/incremental, kcore/incremental)
run from their cold seeds.  Programs whose ``n_budget`` the graph
exceeds (the O(n^2/P) triangle-counting bitmap) are skipped with a note.
``--exec-mode {bsp,async}`` keeps the programs of one loop (the default
``all`` runs both and cross-checks them in the ``[verify]`` lines).
``--multi-source B`` also runs the rooted non-bsp programs (bfs/fast,
sssp, betweenness, bfs/async, sssp/async) batched over B roots against
one graph residency.  ``--layout coo`` is the escape hatch back to the
COO scatter reference path; ``REPRO_LOCALOPS={auto,ref,ell,kernel}``
further overrides the local-ops dispatch.  ``--obs`` also runs each
program's ``telemetry=True`` build after its timed run (so the headline
ms stays the plain number) and prints ``[obs]`` lines: rounds, wall
time and wire bytes a round by op; ``--trace-out PATH`` (implies
``--obs``) records those runs' layer spans (``obs/spans.py``: each call,
its init, rounds and outputs, BFS levels, local ops and exchanges, as
measured on the host clock) and writes them as a validated Chrome
trace, one track per layer, to open in ui.perfetto.dev.

Under ``torchrun`` the P parts are P ranks (``DistComm``): each rank
generates and partitions the graph with the same seed, keeps its own
part, and runs every program with the others; rank 0 prints the lines
a one-process run prints, with the same rounds.  ``--device cpu`` runs
the ranks over gloo; otherwise rank r takes ``cuda:{LOCAL_RANK}`` over
NCCL, which needs one card a rank (it raises otherwise).

  PYTHONPATH=src python -m repro_torch.launch.graph_analytics \\
      --graph urand22 --parts 4 --multi-source 4 --exec-mode async
  PYTHONPATH=src python -m repro_torch.launch.graph_analytics \\
      --graph urand12 --device cpu --obs --trace-out build/obs/urand12.json
  PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
      -m repro_torch.launch.graph_analytics --graph urand12 --parts 2 \\
      --device cpu
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.configs import graph_workloads
from repro_torch.core import GraphEngine, incremental, localops, \
    partition_graph, registry
from repro_torch.core.registry import program_label
from repro_torch.graphs import generate_edges
from repro_torch.kernels.frontier.kernel import bfs_pull
from repro_torch.kernels.spmv.kernel import spmv_ell
from repro_torch.launch.mesh import make_graph_mesh
from repro_torch.obs import SpanRecorder, chrome_trace, recording, \
    write_trace

INT_INF = 2 ** 30


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(fn, args, device):
    out = fn(*args)               # warm-up (first call builds kernels)
    _sync(device)
    t0 = time.perf_counter()
    out = fn(*args)
    _sync(device)
    return out, time.perf_counter() - t0


def _quiet(*args, **kwargs) -> None:
    """What a rank other than 0 prints: nothing."""


def init_ranks(device: str | None) -> str | None:
    """Under ``torchrun`` (``RANK`` in the environment), join the process
    group and return this rank's device: ``cpu`` over gloo, else
    ``cuda:{LOCAL_RANK}`` over NCCL (one card a rank, or this raises).
    Without ``torchrun``, ``device`` as given and no group."""
    if "RANK" not in os.environ:
        return device
    import torch.distributed as dist
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo", init_method="env://")
        return "cpu"
    local, cards = int(os.environ["LOCAL_RANK"]), torch.cuda.device_count()
    if local >= cards:
        raise RuntimeError(
            f"NCCL takes one card a rank: local rank {local} of "
            f"{os.environ['WORLD_SIZE']} ranks, {cards} cards here (pass "
            "--device cpu for gloo)")
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", init_method="env://")
    return f"cuda:{local}"


def run(graph_name: str, parts: int, *, device: str | None = None,
        pr_iters: int = 50, verify: bool = True, seed: int = 42,
        multi_source: int = 0, layout: str = "ell",
        exec_mode: str = "all", obs: bool = False,
        trace_out: str | None = None) -> dict:
    gcfg = graph_workloads.ALL[graph_name]
    edges = generate_edges(gcfg, seed)
    t0 = time.perf_counter()
    g = partition_graph(edges, gcfg.num_vertices, parts)
    ell_slots = sum(m.slots for m in g.ell_meta.values())
    eng = GraphEngine(g, device=device, layout=layout,
                      mesh=make_graph_mesh(parts))
    # under torchrun every rank runs every program (the exchanges and
    # the gathers are collectives), and rank 0 prints
    say = print if eng.comm.first_part == 0 else _quiet
    say(f"[graph] generating {graph_name}: 2^{gcfg.scale} vertices, "
        f"{gcfg.num_edges:,} edges ({gcfg.generator})")
    if eng.distributed:
        say(f"[graph] mesh: {parts} ranks over {eng.comm.backend}, one "
            "part a rank (DistComm)")
    say(f"[graph] partitioned over {parts} parts in "
        f"{time.perf_counter() - t0:.1f}s (n_local={g.n_local:,}, "
        f"e_max={g.e_max:,}; layout={layout} ell_slots/part="
        f"{ell_slots:,} localops={localops.get_mode()} "
        f"device={eng.device})")
    garr = eng.device_graph()
    root = 0
    results = {}
    obs = obs or bool(trace_out)
    rec = SpanRecorder()   # the telemetry runs' layer spans
    for algo, variant in registry.available():
        spec = registry.get_spec(algo, variant)
        name = program_label(algo, variant)
        if exec_mode != "all" and spec.exec_mode != exec_mode:
            continue
        if spec.n_budget and g.n > spec.n_budget:
            say(f"[graph] {name:14s}   skipped (n={g.n:,} exceeds its "
                f"n_budget={spec.n_budget:,})")
            continue
        params = {"iters": pr_iters} if algo == "pagerank" else {}
        prog = eng.program(algo, variant, **params)
        if any(k != "scalar" for k in spec.input_kinds):
            # seeded incremental variants run from their cold seed here
            (seed_arr,) = incremental.cold_seed(spec, g)
            args = (garr, eng.scatter_vertex_field(
                seed_arr, incremental.KIND_DTYPES[spec.input_kinds[0]]))
        else:
            args = (garr,) + (root,) * len(spec.inputs)
        out, dt = _timed(prog, args, eng.device)
        results[name] = (out, dt)
        say(f"[graph] {name:14s} {dt * 1e3:9.1f} ms  rounds={out[-1]}")
        if obs:
            # a separate telemetry build, run after the timed one so the
            # headline ms stays the plain number
            tprog = eng.program(algo, variant, telemetry=True, **params)
            with recording(rec):
                tel = tprog.run_telemetry(tprog(*args)[-1])
            s = tel.summary()
            wire = s["wire_bytes_per_round"]
            say(f"[obs]   {name:14s} rounds={s['rounds']:3d} "
                f"wall={s.get('wall_ms', 0.0):8.1f} ms  wire/round="
                + (" ".join(f"{op}:{b:,}B" for op, b in wire.items())
                   or "none"))

    if multi_source:
        roots = list(range(multi_source))
        for algo, variant in registry.available():
            spec = registry.get_spec(algo, variant)
            if (not spec.inputs or variant == "bsp"
                    or any(k != "scalar" for k in spec.input_kinds)
                    or (exec_mode != "all" and spec.exec_mode != exec_mode)
                    or (spec.n_budget and g.n > spec.n_budget)):
                continue          # batch only the rooted non-bsp programs
            prog = eng.program(algo, variant, batch=multi_source)
            name = f"{program_label(algo, variant)}_x{multi_source}"
            out, dt = _timed(prog, (garr, roots), eng.device)
            results[name] = (out, dt)
            say(f"[graph] {name:14s} {dt * 1e3:9.1f} ms "
                f"({dt * 1e3 / multi_source:7.1f} ms/query)  "
                f"rounds={out[-1]}")
    say(f"[kernels] launches: spmv_ell={spmv_ell.launches} "
        f"bfs_pull={bfs_pull.launches}")

    if verify:
        if "bfs_bsp" in results and "bfs_fast" in results:
            p_bsp = eng.gather_vertex_field(results["bfs_bsp"][0][0])
            p_fast = eng.gather_vertex_field(results["bfs_fast"][0][0])
            same = ((p_bsp < INT_INF) == (p_fast < INT_INF)).all()
            say(f"[verify] BFS reachability bsp==fast: {bool(same)}")
        if "pagerank_bsp" in results and "pagerank_fast" in results:
            r_bsp = eng.gather_vertex_field(results["pagerank_bsp"][0][0])
            r_fast = eng.gather_vertex_field(results["pagerank_fast"][0][0])
            rel = np.abs(r_bsp - r_fast).max() / r_bsp.max()
            say(f"[verify] PageRank bsp-vs-fast max rel diff: {rel:.2e}")
        # async-vs-bsp cross-checks when both modes ran
        if "bfs_async" in results and "bfs_fast" in results:
            pa = eng.gather_vertex_field(results["bfs_async"][0][0])
            pf = eng.gather_vertex_field(results["bfs_fast"][0][0])
            same = ((pa < INT_INF) == (pf < INT_INF)).all()
            say(f"[verify] BFS reachability async==fast: {bool(same)}")
        if "pagerank_async" in results and "pagerank_bsp" in results:
            ra = eng.gather_vertex_field(results["pagerank_async"][0][0])
            rb = eng.gather_vertex_field(results["pagerank_bsp"][0][0])
            rel = np.abs(ra - rb).max() / rb.max()
            say(f"[verify] PageRank bsp-vs-async max rel diff: {rel:.2e}")
        for name, label, what in (("cc", "CC", "labels"),
                                  ("sssp", "SSSP", "dist")):
            if f"{name}_async" in results and name in results:
                va = eng.gather_vertex_field(results[f"{name}_async"][0][0])
                vb = eng.gather_vertex_field(results[name][0][0])
                say(f"[verify] {label} {what} async==bsp: "
                    f"{bool((va == vb).all())}")
        if "kcore" in results:
            say(f"[verify] k-core degeneracy: {results['kcore'][0][1]}")
        if "betweenness" in results:
            bc0 = float(eng.gather_vertex_field(
                results["betweenness"][0][0])[root])
            say(f"[verify] betweenness delta_s(s) == 0: {bc0 == 0.0}")
        if "triangles" in results:
            tri = eng.gather_vertex_field(results["triangles"][0][0])
            total = results["triangles"][0][1]
            say(f"[verify] triangles sum/3 == total: "
                f"{int(tri.sum()) // 3 == total} ({total:,})")
        if multi_source:
            for name, label in (("bfs_fast", "BFS"), ("sssp", "SSSP"),
                                ("betweenness", "betweenness"),
                                ("bfs_async", "BFS async"),
                                ("sssp_async", "SSSP async")):
                batched = f"{name}_x{multi_source}"
                if name not in results or batched not in results:
                    continue
                single, rounds = results[name][0], results[name][0][-1]
                out = results[batched][0]
                same = rounds == out[-1][0] and all(
                    np.array_equal(eng.gather_batched_vertex_field(b)[0],
                                   eng.gather_vertex_field(s))
                    for b, s in zip(out[:-1], single[:-1]))
                say(f"[verify] multi-source {label} root0 == "
                    f"single-source: {same}")
    if trace_out and eng.comm.first_part == 0:
        counts = write_trace(trace_out, chrome_trace(rec.spans()))
        say(f"[graph] wrote {trace_out} (chrome trace, "
            f"{sum(counts.values())} events; open in ui.perfetto.dev)")
    return results


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="urand16",
                    choices=sorted(graph_workloads.ALL))
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    ap.add_argument("--pr-iters", type=int, default=50)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--multi-source", type=int, default=0,
                    help="also run the rooted non-bsp programs batched "
                         "over this many roots (0, 1, ...)")
    ap.add_argument("--layout", choices=("ell", "coo"), default="ell",
                    help="edge layout for the superstep hot loops: "
                         "blocked-ELL (kernels on CUDA) or the COO "
                         "scatter reference path")
    ap.add_argument("--exec-mode", choices=("all", "bsp", "async"),
                    default="all",
                    help="restrict to one superstep loop: bsp runs the "
                         "synchronous programs only, async the "
                         "double-buffered ones; all runs both and "
                         "cross-checks them in verify")
    ap.add_argument("--obs", action="store_true",
                    help="also run each program's telemetry=True build "
                         "(a separate cache entry) and print its "
                         "per-round series summary and wire bytes a "
                         "round by op")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the "
                         "telemetry runs' measured layer spans (implies "
                         "--obs; open in ui.perfetto.dev)")
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args()
    device = init_ranks(args.device)
    try:
        run(args.graph, args.parts, device=device, pr_iters=args.pr_iters,
            verify=not args.no_verify, seed=args.seed,
            multi_source=args.multi_source, layout=args.layout,
            exec_mode=args.exec_mode, obs=args.obs,
            trace_out=args.trace_out)
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
