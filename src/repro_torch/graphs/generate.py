"""Graph generators: urand (Erdos-Renyi, as in the paper's SS5), RMAT
(GAP 'kron'-style), and Watts-Strogatz small-world - deterministic,
numpy-based.  The small-world family (ring lattice + random rewiring,
emitted as directed edge pairs) is the second graph family of the
oracle-conformance gate: high clustering exercises triangle counting
and k-core in a way ER graphs do not.

The paper evaluates on 'urand' graphs of varying scale (urand25 = 2^25
vertices); GAP's urand draws E = n*k directed edges with independently
uniform endpoints, which is what we implement.
"""

from __future__ import annotations

import numpy as np

from repro_torch.configs.base import GraphConfig


def generate_edges(cfg: GraphConfig, seed: int = 42) -> np.ndarray:
    """Return (E, 2) int64 edge array [src, dst]."""
    if cfg.generator == "urand":
        return urand_edges(cfg.num_vertices, cfg.num_edges, seed)
    if cfg.generator == "rmat":
        return rmat_edges(cfg.scale, cfg.num_edges, seed)
    if cfg.generator == "smallworld":
        return smallworld_edges(cfg.num_vertices, k=cfg.avg_degree,
                                seed=seed)
    raise ValueError(cfg.generator)


def smallworld_edges(n: int, k: int = 8, p: float = 0.1,
                     seed: int = 42) -> np.ndarray:
    """Watts-Strogatz small-world graph as a directed edge list.

    Ring lattice: each vertex links to its k/2 nearest successors; every
    undirected lattice edge is emitted as BOTH directed edges (n*k edges
    total, matching ``GraphConfig.num_edges`` with avg_degree=k).  Each
    directed edge's head is then rewired to a uniform random vertex with
    probability ``p`` — deterministic in ``seed``.
    """
    half = max(1, k // 2)
    rng = np.random.default_rng(seed)
    u = np.repeat(np.arange(n, dtype=np.int64), half)
    offs = np.tile(np.arange(1, half + 1, dtype=np.int64), n)
    v = (u + offs) % n
    src = np.concatenate([u, v])
    dst = np.concatenate([v, u])
    rewire = rng.random(src.size) < p
    dst = np.where(rewire, rng.integers(0, n, size=src.size), dst)
    return np.stack([src, dst], axis=1)


def urand_edges(n: int, e: int, seed: int = 42) -> np.ndarray:
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, size=e, dtype=np.int64)
    dst = rng.integers(0, n, size=e, dtype=np.int64)
    return np.stack([src, dst], axis=1)


def rmat_edges(scale: int, e: int, seed: int = 42,
               a: float = 0.57, b: float = 0.19, c: float = 0.19) -> np.ndarray:
    """GAP-style Kronecker/RMAT, vectorized over bits."""
    rng = np.random.default_rng(seed)
    src = np.zeros(e, dtype=np.int64)
    dst = np.zeros(e, dtype=np.int64)
    for _ in range(scale):
        src <<= 1
        dst <<= 1
        r1 = rng.random(e)
        r2 = rng.random(e)
        src_bit = r1 > (a + b)
        dst_bit = ((r1 <= a + b) & (r2 > a / (a + b))) | (
            (r1 > a + b) & (r2 > c / max(1e-12, (1.0 - a - b))))
        src |= src_bit.astype(np.int64)
        dst |= dst_bit.astype(np.int64)
    # GAP permutes vertex ids to destroy locality artifacts
    perm = rng.permutation(1 << scale)
    return np.stack([perm[src], perm[dst]], axis=1)
