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

``--mutate-every S --mutate-size K`` merges a timed mutation stream
(``repro_torch.serve.dynamic.mutation_stream``) into the trace: every S
seconds a K-edge delete/insert batch applies in place and opens a new
snapshot epoch, so the replay exercises serving under churn.

``--wal-dir DIR`` makes the server durable (write-ahead mutation log +
crash-consistent snapshots every ``--snapshot-every`` epochs, see
``repro_torch.serve.persist``); ``--recover --wal-dir DIR`` resumes a
killed server from that directory instead of regenerating the graph.

  PYTHONPATH=src python -m repro_torch.launch.graph_serve \\
      --graph urand12 --device cpu --duration 2 --rate 16 \\
      --mutate-every 0.5 --mutate-size 16 --wal-dir build/wal --json -
  PYTHONPATH=src python -m repro_torch.launch.graph_serve \\
      --graph urand12 --device cpu --duration 2 --rate 16 --recover \\
      --wal-dir build/wal --json -

Under ``torchrun`` every rank joins the process group (gloo with
``--device cpu``, else NCCL with one card a rank, as
``launch/graph_analytics.py`` does), builds ``make_graph_mesh(parts)``
(``--parts`` is the world size) and holds one part; rank 0 leads the
server (admission, coalescing, the trace, the WAL) and alone prints and
writes ``--json``, and the other ranks follow its launches, demuxes and
mutation batches.  ``--mutate-every``, ``--wal-dir`` and ``--recover``
work there too (each rank snapshots its part):

  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.graph_serve --graph urand12 --parts 4 \\
      --device cpu --duration 2 --rate 16 --mutate-every 0.5 \\
      --mutate-size 16 --wal-dir build/wal4 --json -
  PYTHONPATH=src torchrun --standalone --nproc-per-node 4 \\
      -m repro_torch.launch.graph_serve --graph urand12 --parts 4 \\
      --device cpu --duration 2 --rate 16 --recover \\
      --wal-dir build/wal4 --json -

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
from repro_torch.launch.graph_analytics import _quiet, init_ranks
from repro_torch.launch.mesh import make_graph_mesh
from repro_torch.obs import SpanRecorder, chrome_trace, trace_summary, \
    write_trace
from repro_torch.serve import GraphServer, Persistence, mutation_stream, \
    parse_mix, synthetic_trace


def run(graph_name: str, parts: int = 1, *, device: str | None = None,
        engine: GraphEngine | None = None,
        mix: str = "bfs:8,sssp:4,cc:1", duration: float = 10.0,
        rate: float = 64.0, buckets=(1, 8, 32, 128), depth: int = 2,
        zipf_s: float = 1.05, seed: int = 42, layout: str = "ell",
        json_path: str | None = None, mutate_every: float = 0.0,
        mutate_size: int = 64, wal_dir: str | None = None,
        snapshot_every: int = 8, recover: bool = False, obs: bool = False,
        trace_out: str | None = None) -> GraphServer:
    """Serve the trace; returns the server (its metrics, its recorder).
    ``engine`` serves a graph already partitioned (``graph_name``'s, at
    ``parts``) in place of generating it; ``recover`` resumes the
    server ``wal_dir`` holds instead.  Inside a process group of
    ``parts`` ranks every rank calls this: each holds its part, rank 0
    leads and prints, and the others follow."""
    gcfg = graph_workloads.ALL[graph_name]
    mesh = engine.mesh if engine is not None else make_graph_mesh(parts)
    lead = True
    if mesh.distributed:
        import torch.distributed as dist
        lead = dist.get_rank() == 0
    say = print if lead else _quiet
    # --trace-out implies tracing; a SpanRecorder on the server records
    # every pipeline stage (admission -> ... -> demux) plus durability
    # spans and resilience events
    rec = SpanRecorder() if (obs or trace_out) else None
    edges = None
    if recover:
        if not wal_dir:
            raise SystemExit("[serve] --recover requires --wal-dir")
        if engine is not None:
            raise ValueError("recover resumes the graph wal_dir holds; "
                             "it takes no engine")
        t0 = time.time()
        server = GraphServer.recover(wal_dir, mesh=mesh, device=device,
                                     buckets=buckets, depth=depth,
                                     snapshot_every=snapshot_every, obs=rec)
        eng = server.engine
        rep = server.recovery_report
        say(f"[serve] recovered {wal_dir} in {time.time()-t0:.1f}s: "
            f"epoch {server.epoch} (snapshot {rep.snapshot_epoch} "
            f"+ {rep.replayed} WAL records replayed, "
            f"{rep.skipped} skipped, {rep.rebuilds} rebuilds)")
    else:
        if engine is None:
            say(f"[serve] generating {graph_name}: 2^{gcfg.scale} "
                f"vertices, {gcfg.num_edges:,} edges ({gcfg.generator})")
            edges = generate_edges(gcfg, seed)
            t0 = time.time()
            g = partition_graph(edges, gcfg.num_vertices, parts)
            say(f"[serve] partitioned over {parts} parts in "
                f"{time.time()-t0:.1f}s (layout={layout} "
                f"localops={localops.get_mode()})")
            engine = GraphEngine(g, device=device, layout=layout, mesh=mesh)
        elif (engine.g.parts, engine.g.n_orig, engine.layout) != \
                (parts, gcfg.num_vertices, layout):
            raise ValueError(
                f"engine holds {engine.g.n_orig} vertices in "
                f"{engine.g.parts} parts ({engine.layout}), not "
                f"{graph_name} in {parts} ({layout})")
        eng = engine
        persistence = Persistence(dir=wal_dir,
                                  snapshot_every=snapshot_every) \
            if wal_dir else None
        server = GraphServer(eng, buckets=buckets, depth=depth,
                             persistence=persistence, obs=rec)
        if persistence:
            say(f"[serve] durable: wal-dir={wal_dir} "
                f"snapshot_every={snapshot_every}")

    keys = parse_mix(mix)
    t0 = time.time()
    launches = server.warmup([k for k, _ in keys])
    say(f"[serve] warmed {launches} (program x bucket) launches in "
        f"{time.time()-t0:.1f}s; ladder={server.ladder.sizes} "
        f"depth={depth} device={eng.device}")

    trace = synthetic_trace(eng.g.n_orig, keys, rate=rate,
                            duration=duration, zipf_s=zipf_s, seed=seed)
    n_mut = 0
    if mutate_every > 0:
        src_edges = edges if edges is not None \
            else server.dynamic_graph().current_edges()
        events = mutation_stream(src_edges, every=mutate_every,
                                 size=mutate_size, duration=duration,
                                 seed=seed)
        trace = trace + events          # serve_trace sorts by time
        n_mut = len(events)
        say(f"[serve] merged {n_mut} mutation batches "
            f"(every {mutate_every:.1f}s, {mutate_size} edges each)")
    say(f"[serve] replaying {len(trace)-n_mut} queries over "
        f"{duration:.0f}s (rate={rate:.0f}/s, mix={mix}, "
        f"zipf_s={zipf_s})")
    results = server.serve_trace(trace)
    if not lead:                  # the followers' part is done
        return server
    print(f"[serve] served {len(results)} queries "
          f"({len(results)/server.metrics.window_s:.1f} q/s overall)")
    print(server.metrics.table())
    if server.mutation_log:
        rebuilds = sum(m["rebuild"] for m in server.mutation_log)
        print(f"[serve] applied {len(server.mutation_log)} mutation "
              f"batches ({rebuilds} rebuilds); final epoch {server.epoch}")

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
                     "mutate_every": mutate_every,
                     "mutate_size": mutate_size,
                     "mutations": len(server.mutation_log),
                     "final_epoch": server.epoch,
                     "wal_dir": wal_dir, "recovered": bool(recover),
                     **runtime_fingerprint(eng.device)},
            "rows": snap["rows"],
            "counts": snap["counts"],
            "epoch": snap["epoch"],
            # resilience + durability counters
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
    ap.add_argument("--mutate-every", type=float, default=0.0,
                    help="apply a mutation batch every this many seconds "
                         "(0 = static graph); epochs advance mid-trace")
    ap.add_argument("--mutate-size", type=int, default=64,
                    help="edges per mutation batch (alternating "
                         "delete/insert; see serve.dynamic.mutation_stream)")
    ap.add_argument("--wal-dir", default=None,
                    help="durability directory (WAL + snapshots); makes "
                         "the server crash-recoverable")
    ap.add_argument("--snapshot-every", type=int, default=8,
                    help="epochs between crash-consistent snapshots")
    ap.add_argument("--recover", action="store_true",
                    help="resume from --wal-dir instead of generating "
                         "and partitioning a fresh graph")
    ap.add_argument("--obs", action="store_true",
                    help="record serving-path spans (admission/dispatch/"
                         "device/demux/...) and report a trace summary")
    ap.add_argument("--trace-out", default=None,
                    help="write a Chrome trace-event JSON of the serve "
                         "session (implies --obs; open in ui.perfetto.dev)")
    args = ap.parse_args()
    device = init_ranks(args.device)
    run(args.graph, args.parts, device=device, mix=args.mix,
        duration=args.duration, rate=args.rate,
        buckets=tuple(int(b) for b in args.buckets.split(",")),
        depth=args.depth, zipf_s=args.zipf, seed=args.seed,
        layout=args.layout, json_path=args.json,
        mutate_every=args.mutate_every, mutate_size=args.mutate_size,
        wal_dir=args.wal_dir, snapshot_every=args.snapshot_every,
        recover=args.recover, obs=args.obs, trace_out=args.trace_out)


if __name__ == "__main__":
    main()
