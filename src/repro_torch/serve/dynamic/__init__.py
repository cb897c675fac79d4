"""Dynamic-graph subsystem: in-place blocked-ELL mutation, snapshot
epochs, and the mutation-stream generator for trace replay.

``DynamicGraph`` (mutation.py) owns the host-side free-slot index and
the device patch path; ``GraphServer.mutate`` wraps it with pipeline
flushing and epoch bookkeeping; the incremental recompute programs the
epochs feed live in ``repro_torch.core.incremental`` / the registry.
"""

from repro_torch.serve.dynamic.mutation import DynamicGraph, EllOverflow, \
    MutationBatch, MutationStats
from repro_torch.serve.dynamic.stream import mutation_stream

__all__ = ["DynamicGraph", "EllOverflow", "MutationBatch",
           "MutationStats", "mutation_stream"]
