"""GRAPH query-server driver: resident engine + coalesced mixed traffic.

Generates and partitions a graph once, keeps it device-resident in a
:class:`~repro_torch.serve.server.GraphServer`, warms the bucket ladder
for every program in the mix, then replays a synthetic arrival trace
(Poisson arrivals, Zipfian roots, weighted algorithm mix) through the
coalescing, double-buffered serve pipeline and reports queries/sec and
p50/p95/p99 latency per (program, bucket) cell.

  PYTHONPATH=src python -m repro_torch.launch.graph_serve \\
      --graph urand22 --parts 4 --mix bfs:8,sssp:4,cc:1 --duration 10
  PYTHONPATH=src python -m repro_torch.launch.graph_serve \\
      --graph urand12 --device cpu --duration 2 --rate 16 --json -

The graph is static: mutation streams and durable serving state
(``--mutate-every``, ``--mutate-size``, ``--wal-dir``,
``--snapshot-every``, ``--recover`` in the JAX package's launcher) are
ROADMAP item 12b.

``--obs`` traces the serving path (every pipeline stage as spans in a
bounded ring, see ``repro_torch.obs``) and prints a trace summary;
``--trace-out trace.json`` additionally writes the session as Chrome
trace-event JSON for ui.perfetto.dev (implies ``--obs``).  The
``--json`` payload gains a ``trace_summary`` block when tracing is on.

This is the GRAPH server.  The other serving driver in this package,
``repro_torch.launch.serve``, is the LM token-serving driver (batched
prefill + decode over the transformer stack).
"""

from __future__ import annotations

import argparse
import json
import time

from repro_torch.configs import graph_workloads
from repro_torch.core import GraphEngine, localops, partition_graph
from repro_torch.core.compat import runtime_fingerprint
from repro_torch.graphs import generate_edges
from repro_torch.obs import SpanRecorder, chrome_trace, trace_summary, \
    write_trace
from repro_torch.serve import GraphServer, parse_mix, synthetic_trace


def run(graph_name: str, parts: int = 1, *, device: str | None = None,
        engine: GraphEngine | None = None,
        mix: str = "bfs:8,sssp:4,cc:1", duration: float = 10.0,
        rate: float = 64.0, buckets=(1, 8, 32, 128), depth: int = 2,
        zipf_s: float = 1.05, seed: int = 42, layout: str = "ell",
        json_path: str | None = None, obs: bool = False,
        trace_out: str | None = None) -> GraphServer:
    """Serve the trace; returns the server (its metrics, its recorder).
    ``engine`` serves a graph already partitioned (``graph_name``'s, at
    ``parts``) in place of generating it."""
    gcfg = graph_workloads.ALL[graph_name]
    # --trace-out implies tracing; a SpanRecorder on the server records
    # every pipeline stage (admission -> ... -> demux) plus resilience
    # events
    rec = SpanRecorder() if (obs or trace_out) else None
    if engine is None:
        print(f"[serve] generating {graph_name}: 2^{gcfg.scale} vertices, "
              f"{gcfg.num_edges:,} edges ({gcfg.generator})")
        edges = generate_edges(gcfg, seed)
        t0 = time.time()
        g = partition_graph(edges, gcfg.num_vertices, parts)
        print(f"[serve] partitioned over {parts} parts in "
              f"{time.time()-t0:.1f}s (layout={layout} "
              f"localops={localops.get_mode()})")
        engine = GraphEngine(g, device=device, layout=layout)
    elif (engine.g.parts, engine.g.n_orig, engine.layout) != \
            (parts, gcfg.num_vertices, layout):
        raise ValueError(
            f"engine holds {engine.g.n_orig} vertices in "
            f"{engine.g.parts} parts ({engine.layout}), not {graph_name} "
            f"in {parts} ({layout})")
    eng = engine
    server = GraphServer(eng, buckets=buckets, depth=depth, obs=rec)

    keys = parse_mix(mix)
    t0 = time.time()
    launches = server.warmup([k for k, _ in keys])
    print(f"[serve] warmed {launches} (program x bucket) launches in "
          f"{time.time()-t0:.1f}s; ladder={server.ladder.sizes} "
          f"depth={depth} device={eng.device}")

    trace = synthetic_trace(eng.g.n_orig, keys, rate=rate,
                            duration=duration, zipf_s=zipf_s, seed=seed)
    print(f"[serve] replaying {len(trace)} queries over "
          f"{duration:.0f}s (rate={rate:.0f}/s, mix={mix}, "
          f"zipf_s={zipf_s})")
    results = server.serve_trace(trace)
    print(f"[serve] served {len(results)} queries "
          f"({len(results)/server.metrics.window_s:.1f} q/s overall)")
    print(server.metrics.table())

    summ = None
    if rec is not None:
        summ = trace_summary(rec)
        top = ", ".join(f"{r['kind']}={r['p99_ms']:.2f}ms"
                        for r in summ["top_p99_ms"])
        print(f"[serve] obs: {summ['spans_total']} spans / "
              f"{summ['events_total']} events recorded; top p99: {top}")
    if trace_out:
        counts = write_trace(trace_out, chrome_trace(
            spans=rec.spans(), events=rec.events()))
        print(f"[serve] wrote {trace_out} "
              f"(chrome trace, {sum(counts.values())} events; open in "
              f"ui.perfetto.dev)")

    if json_path:
        snap = server.metrics.snapshot()
        payload = {
            "meta": {"graph": graph_name, "parts": parts, "mix": mix,
                     "rate": rate, "duration": duration,
                     "buckets": list(server.ladder.sizes), "depth": depth,
                     "zipf_s": zipf_s, "layout": layout,
                     "localops": localops.get_mode(),
                     # the static graph's values of the item-12b fields
                     "mutate_every": 0.0, "mutate_size": 0,
                     "mutations": len(server.mutation_log),
                     "final_epoch": server.epoch,
                     "wal_dir": None, "recovered": False,
                     **runtime_fingerprint(eng.device)},
            "rows": snap["rows"],
            "counts": snap["counts"],
            "epoch": snap["epoch"],
            "recoveries": snap["recoveries"],
            "wal_records": snap["wal_records"],
        }
        if summ is not None:
            payload["trace_summary"] = summ
        if json_path == "-":
            print("SERVE_JSON " + json.dumps(payload))
        else:
            with open(json_path, "w") as f:
                f.write(json.dumps(payload, indent=2) + "\n")
            print(f"[serve] wrote {json_path}")
    return server


def main():
    ap = argparse.ArgumentParser(
        description="Graph query server: coalesced mixed-algorithm "
                    "traffic against a device-resident graph.",
        epilog="For the LM token-serving driver (batched "
               "prefill/decode) see: python -m repro_torch.launch.serve")
    ap.add_argument("--graph", default="urand16")
    ap.add_argument("--parts", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without one)")
    ap.add_argument("--mix", default="bfs:8,sssp:4,cc:1",
                    help="algo[/variant][:weight] list, e.g. "
                         "bfs:8,sssp:4,cc:1")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="trace length in seconds")
    ap.add_argument("--rate", type=float, default=64.0,
                    help="Poisson arrival rate, queries/sec")
    ap.add_argument("--buckets", default="1,8,32,128",
                    help="coalescing batch-size ladder")
    ap.add_argument("--depth", type=int, default=2,
                    help="in-flight launch pipeline depth")
    ap.add_argument("--zipf", type=float, default=1.05,
                    help="Zipf skew of the root distribution")
    ap.add_argument("--layout", choices=("ell", "coo"), default="ell")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--json", default=None,
                    help="write metrics rows to this path ('-' = stdout)")
    ap.add_argument("--obs", action="store_true",
                    help="record serving-path spans (admission/dispatch/"
                         "device/demux/...) and report a trace summary")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the serve "
                         "session (implies --obs; open in ui.perfetto.dev)")
    args = ap.parse_args()
    run(args.graph, args.parts, device=args.device, mix=args.mix,
        duration=args.duration, rate=args.rate,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        depth=args.depth, zipf_s=args.zipf, seed=args.seed,
        layout=args.layout, json_path=args.json, obs=args.obs,
        trace_out=args.trace_out)


if __name__ == "__main__":
    main()
