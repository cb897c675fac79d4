"""Dry-run: plan every registered graph program for a paper-scale urand
graph at production part counts, on meta tensors, and write its
roofline records.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --graph urand28 \\
      --mesh both --out artifacts/dryrun

Planning needs no card and allocates nothing (``core/dryrun.py``).  It
writes ``graph-<program>__<graph>__<mesh>.json`` records with the JAX
package's keys, TPU v5e and H100 roofline terms.  ``--measure P``
also partitions the graph into P parts, uploads it and runs bfs/fast,
pagerank/bsp and pagerank/fast with their static trip counts beside
their plans (on the card unless ``--device cpu``).

The LM dry-run (``--arch``) is not ported yet: ROADMAP.md item 13b.
"""

from __future__ import annotations

import argparse
import json

MEASURED = (("bfs", "fast"), ("pagerank", "bsp"), ("pagerank", "fast"))


def run_graph_dryrun(graph_name: str, mesh_name: str, out_dir) -> list:
    """Plan the paper's graph engine (every registered program)."""
    from repro_torch.core.dryrun import lower_graph_programs

    return lower_graph_programs(graph_name, mesh_name, out_dir)


def run_measured(graph_name: str, parts: int, device=None) -> list:
    """Plan and run MEASURED at ``parts`` on ``device`` (CUDA unless
    given); print and return each comparison."""
    import torch

    from repro_torch.configs import graph_workloads
    from repro_torch.core import GraphEngine, partition_graph
    from repro_torch.core.dryrun import DRYRUN_PARAMS, STATIC_ITERS, \
        measure_vs_plan
    from repro_torch.graphs import generate_edges

    cfg = graph_workloads.ALL[graph_name]
    edges = generate_edges(cfg)
    eng = GraphEngine(partition_graph(edges, cfg.num_vertices, parts),
                      device=device)
    garr = eng.device_graph()
    out = []
    for algo, variant in MEASURED:
        r = measure_vs_plan(eng, garr, algo, variant, STATIC_ITERS[algo],
                            **DRYRUN_PARAMS.get((algo, variant), {}))
        peak = r["measured_peak_bytes"]
        print(f"[measure {r['program']} x {graph_name} x parts={parts}] "
              f"args planned {r['planned_arg_bytes']} resident "
              f"{r['resident_bytes']} | temp planned "
              f"{r['planned_temp_bytes']} measured "
              f"{'not measured' if peak is None else peak} | wire "
              f"planned {r['planned_wire']} run {r['run_wire']}")
        out.append(r)
    del garr
    if eng.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None,
                    help="LM dry-run: not ported yet (ROADMAP.md, 13b)")
    ap.add_argument("--mesh", default="pod",
                    choices=["pod", "multipod", "both"])
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--graph", default=None,
                    help="run the graph-engine dry-run for this workload")
    ap.add_argument("--measure", type=int, default=0, metavar="P",
                    help="also run the measured programs at P parts")
    ap.add_argument("--device", default=None,
                    help="device of --measure: cuda (the default) or cpu")
    args = ap.parse_args()

    if args.arch is not None or not args.graph:
        raise NotImplementedError(
            "the LM dry-run (--arch) is not ported yet; see ROADMAP.md, "
            "item 13b (launch/dryrun.py --arch, roofline/recost.py, "
            "launch/steps.py::lower_cell)")
    for m in (["pod", "multipod"] if args.mesh == "both" else [args.mesh]):
        run_graph_dryrun(args.graph, m, args.out)
    if args.measure:
        recs = run_measured(args.graph, args.measure, args.device)
        print(json.dumps(recs))


if __name__ == "__main__":
    main()
