"""Declared observability vocabulary.

Everything the subsystem can emit is declared HERE, statically:

  * ``COMPONENTS`` — the tracks a span/event can land on.  The trace
    exporter gives each component its own ``tid`` in declaration
    order, so track layout in Perfetto is stable across runs.
  * ``SPAN_KINDS`` — every interval kind, its canonical component, its
    Chrome export shape (``complete`` -> one "X" event; ``async`` ->
    "b"/"e" pairs, used for kinds that OVERLAP on one track: a query's
    lifetime brackets many nested server spans, device launches
    double-buffer), and a one-line description.  The analytics path's
    layer sites (``obs/spans.py``) record the kinds of the ``engine``,
    ``bfs``, ``localops`` and ``comm`` components; their profiler range
    is ``repro_torch.<component>.<kind>``.
  * ``EVENT_KINDS`` — instant events ("i" in the export).

``docs/API.md``'s table of the port's spans is generated by
``spans_markdown_table()`` and drift-tested with the same ``table in
docs`` idiom as the algorithm and crash-point tables.
"""

from __future__ import annotations

# component -> description (declaration order = exported tid order)
COMPONENTS = {
    "server": "GraphServer request path (admission, demux, mutation)",
    "coalescer": "bucket-ladder batch formation",
    "executor": "double-buffered executor host side",
    "device": "device launches (dispatch -> done)",
    "durability": "WAL appends and snapshot writes",
    "engine": "the engine's calls and the superstep loop",
    "recovery": "checkpoint runner (chunks, detections, rollbacks)",
    "bfs": "bfs/fast's direction-optimizing levels",
    "localops": "local edge work between the exchanges",
    "comm": "the exchanges and collectives of StackedComm / DistComm",
}

# kind -> (component, export, description); export in {complete, async}
SPAN_KINDS = {
    "query": ("server", "async",
              "whole query lifetime, submit -> resolve; args carry the "
              "exact latency_s ServeMetrics recorded"),
    "admission": ("server", "complete",
                  "submit_query: stamp, validate, hand to coalescer"),
    "validate": ("server", "complete",
                 "root/weight validation inside admission"),
    "coalesce_wait": ("coalescer", "async",
                      "batch formation: first admit -> batch formed"),
    "dispatch": ("executor", "complete",
                 "host-side build + dispatch of a formed batch"),
    "device": ("device", "async",
               "device launch in flight: t_dispatch -> t_done"),
    "demux": ("server", "complete",
              "launch result demux + per-query resolve"),
    "mutation": ("server", "complete",
                 "mutate(): barrier flush, apply, snapshot check"),
    "wal_append": ("durability", "complete",
                   "write-ahead-log record append (incl. flush)"),
    "snapshot": ("durability", "complete",
                 "crash-consistent snapshot write"),
    "recovery": ("server", "complete",
                 "GraphServer.recover(): snapshot load + WAL replay"),
    "chunk": ("recovery", "complete",
              "one checkpointed chunk of rounds in CheckpointRunner"),
    "call": ("engine", "complete",
             "CompiledProgram.__call__: one call of a built program"),
    "init": ("engine", "complete",
             "the superstep loop's init (the seed state, its exchanges)"),
    "round": ("engine", "complete",
              "one superstep round: step, or local + fold"),
    "outputs": ("engine", "complete",
                "the program's outputs after the loop"),
    "push": ("bfs", "complete",
             "a bfs/fast push level: OR-combine over ell_dst, parents"),
    "pull": ("bfs", "complete",
             "a bfs/fast pull level: parents over ell_in"),
    **{fn: ("localops", "complete", f"localops.{fn}, every route")
       for fn in ("scatter_combine", "frontier_pull", "spmv_pull",
                  "pull_min_eq")},
    **{op: ("comm", "complete", f"the comm's {op}")
       for op in ("exchange_sum", "exchange_or", "exchange_min_int",
                  "broadcast_global", "shift", "psum_scalar", "sum_parts",
                  "all_parts", "max_scalar", "gather_parts",
                  "exchange_min_start", "exchange_min_finish",
                  "exchange_sum_start", "exchange_sum_finish",
                  "exchange_or_start", "exchange_or_finish")},
}

# instant events: kind -> (component, description)
EVENT_KINDS = {
    "fault_detection": ("recovery",
                        "guard tripped; chunk result discarded"),
    "rollback": ("recovery", "carry restored from last checkpoint"),
    "checkpoint": ("recovery", "chunk committed as a new checkpoint"),
    "shed": ("server", "query shed at admission (queue full)"),
    "rejected": ("server", "query rejected at validation"),
    "timed_out": ("server", "query deadline expired before dispatch"),
    "launch_failure": ("executor", "device launch raised; batch failed"),
}

def spans_markdown_table() -> str:
    """Span + event kinds as one markdown table (docs-drift-tested)."""
    lines = ["| kind | component | shape | description |",
             "|------|-----------|-------|-------------|"]
    for kind, (comp, export, desc) in SPAN_KINDS.items():
        lines.append(f"| `{kind}` | {comp} | span ({export}) | {desc} |")
    for kind, (comp, desc) in EVENT_KINDS.items():
        lines.append(f"| `{kind}` | {comp} | event | {desc} |")
    return "\n".join(lines)
