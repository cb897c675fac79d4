"""Graph-analytics launcher: the paper's workload end to end.

Generates a urand/rmat/smallworld graph, cuts it into P vertex blocks
stacked on one device, runs every registered program (BFS and PageRank,
each in its BSP baseline and its HPX-adapted fast variant), verifies the
results against each other, and reports per-program times, rounds and
kernel launch counts.  ``--layout coo`` is the escape hatch back to the
COO scatter reference path; ``REPRO_LOCALOPS={auto,ref,ell,kernel}``
further overrides the local-ops dispatch.

  PYTHONPATH=src python -m repro_torch.launch.graph_analytics \\
      --graph urand22 --parts 4
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import graph_workloads
from repro_torch.core import GraphEngine, localops, partition_graph, \
    registry
from repro_torch.core.registry import program_label
from repro_torch.graphs import generate_edges
from repro_torch.kernels.frontier.kernel import bfs_pull
from repro_torch.kernels.spmv.kernel import spmv_ell

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


def run(graph_name: str, parts: int, *, device: str | None = None,
        pr_iters: int = 50, verify: bool = True, seed: int = 42,
        layout: str = "ell") -> dict:
    gcfg = graph_workloads.ALL[graph_name]
    print(f"[graph] generating {graph_name}: 2^{gcfg.scale} vertices, "
          f"{gcfg.num_edges:,} edges ({gcfg.generator})")
    edges = generate_edges(gcfg, seed)
    t0 = time.perf_counter()
    g = partition_graph(edges, gcfg.num_vertices, parts)
    ell_slots = sum(m.slots for m in g.ell_meta.values())
    eng = GraphEngine(g, device=device, layout=layout)
    print(f"[graph] partitioned over {parts} parts in "
          f"{time.perf_counter() - t0:.1f}s (n_local={g.n_local:,}, "
          f"e_max={g.e_max:,}; layout={layout} ell_slots/part="
          f"{ell_slots:,} localops={localops.get_mode()} "
          f"device={eng.device})")
    garr = eng.device_graph()
    root = 0
    results = {}
    for algo, variant in registry.available():
        spec = registry.get_spec(algo, variant)
        name = program_label(algo, variant)
        params = {"iters": pr_iters} if algo == "pagerank" else {}
        prog = eng.program(algo, variant, **params)
        args = (garr,) + (root,) * len(spec.inputs)
        out, dt = _timed(prog, args, eng.device)
        results[name] = (out, dt)
        print(f"[graph] {name:14s} {dt * 1e3:9.1f} ms  rounds={out[-1]}")
    print(f"[kernels] launches: spmv_ell={spmv_ell.launches} "
          f"bfs_pull={bfs_pull.launches}")

    if verify:
        if "bfs_bsp" in results and "bfs_fast" in results:
            p_bsp = eng.gather_vertex_field(results["bfs_bsp"][0][0])
            p_fast = eng.gather_vertex_field(results["bfs_fast"][0][0])
            same = ((p_bsp < INT_INF) == (p_fast < INT_INF)).all()
            print(f"[verify] BFS reachability bsp==fast: {bool(same)}")
        if "pagerank_bsp" in results and "pagerank_fast" in results:
            r_bsp = eng.gather_vertex_field(results["pagerank_bsp"][0][0])
            r_fast = eng.gather_vertex_field(results["pagerank_fast"][0][0])
            rel = np.abs(r_bsp - r_fast).max() / r_bsp.max()
            print(f"[verify] PageRank bsp-vs-fast max rel diff: {rel:.2e}")
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
    ap.add_argument("--layout", choices=("ell", "coo"), default="ell",
                    help="edge layout for the superstep hot loops: "
                         "blocked-ELL (kernels on CUDA) or the COO "
                         "scatter reference path")
    ap.add_argument("--no-verify", action="store_true")
    args = ap.parse_args()
    run(args.graph, args.parts, device=args.device, pr_iters=args.pr_iters,
        verify=not args.no_verify, seed=args.seed, layout=args.layout)


if __name__ == "__main__":
    main()
