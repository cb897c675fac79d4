"""Synthetic serving workload: Zipfian roots, weighted algorithm mix,
Poisson arrivals.

Real query traffic over a graph is skewed — a few hot sources dominate
(the "millions of users" scenario is mostly queries about the same
popular vertices) — so roots draw from a Zipf(s) distribution over a
seed-fixed permutation of the vertex ids (hot vertices are scattered
across partitions, not clustered at id 0).  Arrivals are a Poisson
process at ``rate`` queries/sec; the mix string gives per-program
weights, e.g. ``"bfs:8,sssp:4,cc:1"`` (``algo[/variant][:weight]``,
weight defaults to 1, variants resolve through the registry).
"""

from __future__ import annotations

import numpy as np

from repro_torch.serve.query import Query, QueryKey, make_key


def parse_mix(mix: str) -> list[tuple[QueryKey, float]]:
    """``"bfs:8,sssp/default:4,cc:1"`` -> [(QueryKey, weight), ...]."""
    out = []
    for entry in mix.split(","):
        entry = entry.strip()
        if not entry:
            continue
        name, _, w = entry.partition(":")
        out.append((make_key(name.strip()), float(w) if w else 1.0))
    if not out:
        raise ValueError(f"empty mix: {mix!r}")
    return out


def zipf_root_sampler(n: int, s: float = 1.05, seed: int = 0):
    """``sample(size=None) -> vertex id(s)``, Zipf(s)-skewed over a
    permutation of [0, n)."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, n + 1, dtype=np.float64) ** -s
    w /= w.sum()
    perm = rng.permutation(n)

    def sample(size=None):
        picked = rng.choice(n, size=size, p=w)
        return perm[picked] if size is not None else int(perm[picked])

    return sample


def synthetic_trace(n_vertices: int, mix, *, rate: float = 64.0,
                    duration: float = 5.0, zipf_s: float = 1.05,
                    seed: int = 0) -> list[tuple[float, Query]]:
    """Timed arrival trace: ``[(t_arrival_s, Query), ...]`` sorted by
    time.  ``mix`` is a mix string or pre-parsed [(key, weight)] list."""
    if isinstance(mix, str):
        mix = parse_mix(mix)
    keys = [k for k, _ in mix]
    w = np.asarray([wt for _, wt in mix], np.float64)
    w /= w.sum()
    rng = np.random.default_rng(seed)
    roots = zipf_root_sampler(n_vertices, s=zipf_s, seed=seed + 1)
    trace, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / rate)
        if t >= duration:
            return trace
        key = keys[rng.choice(len(keys), p=w)]
        root = roots() if key.rooted else None
        trace.append((t, Query(key, root)))
