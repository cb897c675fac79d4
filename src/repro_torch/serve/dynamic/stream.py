"""Timed mutation streams for trace replay: interleave MutationBatch
events with the synthetic query trace so ``GraphServer.serve_trace``
exercises epochs under load (the launcher's ``--mutate-every``)."""

from __future__ import annotations

import numpy as np

from repro_torch.serve.dynamic.mutation import MutationBatch


def mutation_stream(edges: np.ndarray, *, every: float, size: int,
                    duration: float, seed: int = 0) -> list:
    """``[(t, MutationBatch), ...]`` alternating delete / insert batches
    of ``size`` edges every ``every`` seconds.

    Deletes draw WITHOUT replacement from the ORIGINAL edge list, so
    every delete batch names live instances no matter what already
    mutated; running a delete batch before each insert batch also frees
    COO positions for it.  Inserts are uniform random pairs — they may
    overflow a hot row's bucket, which exercises the rebuild fallback
    on purpose (a stress stream should hit both paths).
    """
    if every <= 0 or size <= 0:
        return []
    rng = np.random.default_rng(seed)
    n = int(edges.max()) + 1 if len(edges) else 1
    pool = rng.permutation(len(edges))
    events, pi, k = [], 0, 0
    t = every
    while t < duration:
        if k % 2 == 0 and pi + size <= len(pool):
            dels = np.asarray(edges)[pool[pi:pi + size]]
            pi += size
            events.append((t, MutationBatch(deletes=dels)))
        else:
            ins = np.stack([rng.integers(0, n, size=size),
                            rng.integers(0, n, size=size)], axis=1)
            events.append((t, MutationBatch(inserts=ins)))
        k += 1
        t += every
    return events
