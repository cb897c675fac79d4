"""Query-serving subsystem: a resident-engine graph server.

Keep the partitioned graph device-resident inside one
:class:`~repro_torch.core.api.GraphEngine`, stream mixed typed queries
(BFS/SSSP/betweenness source queries, PageRank/CC/k-core refreshes)
through an admission queue, coalesce compatible queries into a fixed
bucket ladder of already-built batched programs, pipeline launches
through a double-buffered executor, and demultiplex per-query answers
back out — measuring queries/sec and latency percentiles per (program,
bucket).

The graph is NOT frozen: ``GraphServer.mutate`` applies batched edge
inserts/deletes in place (``repro_torch.serve.dynamic``) under
snapshot-epoch versioning, and the seeded incremental programs
(``pagerank/warm``, ``cc/incremental``, ``kcore/incremental``)
recompute from the previous epoch's served outputs.

Serving state is DURABLE on request: ``GraphServer(...,
persistence=Persistence(dir))`` write-ahead-logs every mutation batch
and snapshots the whole serving state (``repro_torch.serve.persist``),
and ``GraphServer.recover(dir)`` resumes a killed server at the exact
epoch with bit-identical answers.

CLI: ``python -m repro_torch.launch.graph_serve``.  The LM
token-serving driver is separate: ``repro_torch.launch.serve``.
"""

from repro_torch.serve.coalescer import Batch, BucketLadder, Coalescer, \
    DEFAULT_BUCKETS
from repro_torch.serve.dynamic import DynamicGraph, EllOverflow, \
    MutationBatch, MutationStats, mutation_stream
from repro_torch.serve.executor import DoubleBufferedExecutor
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.persist import Persistence
from repro_torch.serve.query import Query, QueryKey, QueryResult, \
    make_key, query, validate_query
from repro_torch.serve.server import GraphServer
from repro_torch.serve.workload import parse_mix, synthetic_trace, \
    zipf_root_sampler

__all__ = [
    "Batch", "BucketLadder", "Coalescer", "DEFAULT_BUCKETS",
    "DoubleBufferedExecutor", "DynamicGraph", "EllOverflow", "GraphServer",
    "MutationBatch", "MutationStats", "Persistence", "Query", "QueryKey",
    "QueryResult", "ServeMetrics", "make_key", "mutation_stream",
    "parse_mix", "query", "synthetic_trace", "validate_query",
    "zipf_root_sampler",
]
