"""Query-serving subsystem: a resident-engine graph server.

Keep the partitioned graph device-resident inside one
:class:`~repro_torch.core.api.GraphEngine`, stream mixed typed queries
(BFS/SSSP/betweenness source queries, PageRank/CC/k-core refreshes)
through an admission queue, coalesce compatible queries into a fixed
bucket ladder of already-built batched programs, pipeline launches
through a double-buffered executor, and demultiplex per-query answers
back out — measuring queries/sec and latency percentiles per (program,
bucket).

The graph is static: mutations and durable serving state (the JAX
package's ``serve/dynamic`` and ``serve/persist``) are ROADMAP item
12b, and the server's entry points for them raise
``NotImplementedError``.

CLI: ``python -m repro_torch.launch.graph_serve``.  The LM
token-serving driver is separate: ``repro_torch.launch.serve``.
"""

from repro_torch.serve.coalescer import Batch, BucketLadder, Coalescer, \
    DEFAULT_BUCKETS
from repro_torch.serve.executor import DoubleBufferedExecutor
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.query import Query, QueryKey, QueryResult, \
    make_key, query, validate_query
from repro_torch.serve.server import GraphServer
from repro_torch.serve.workload import parse_mix, synthetic_trace, \
    zipf_root_sampler

__all__ = [
    "Batch", "BucketLadder", "Coalescer", "DEFAULT_BUCKETS",
    "DoubleBufferedExecutor", "GraphServer", "Query", "QueryKey",
    "QueryResult", "ServeMetrics", "make_key", "parse_mix", "query",
    "synthetic_trace", "validate_query", "zipf_root_sampler",
]
