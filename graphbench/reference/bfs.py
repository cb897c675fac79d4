"""Plain BFS over an edge list: levels, parents and rounds.

Semantics stated by the configurations: a search from ``root`` gives
every vertex reached within ``max_levels`` levels the smallest id among
its in-neighbours one level nearer the root (the root is its own
parent), and every other vertex the parent ``UNREACHED``.  ``rounds``
counts the level expansions run, the last of which finds nothing
unless ``max_levels`` stops the search first.

Plain torch over the benchmark's own edge list; imports nothing of the
program.
"""

from __future__ import annotations

import torch

UNREACHED = 2 ** 30


def levels(edges: torch.Tensor, n: int, root: int, max_levels: int
           ) -> tuple[torch.Tensor, int]:
    """``(level, rounds)``: int64 level a vertex (-1 unreached)."""
    src, dst = edges[:, 0], edges[:, 1]
    level = torch.full((n,), -1, dtype=torch.int64, device=edges.device)
    level[root] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=edges.device)
    frontier[root] = True
    rounds, count, depth = 0, 1, 0
    while rounds < max_levels and count > 0:
        nxt = torch.zeros(n, dtype=torch.bool, device=edges.device)
        nxt[dst[frontier[src]]] = True
        nxt &= level < 0
        depth += 1
        level[nxt] = depth
        frontier = nxt
        count = int(nxt.sum())
        rounds += 1
    return level, rounds


def parents_from_levels(edges: torch.Tensor, level: torch.Tensor, root: int,
                        pick: str = "amin") -> torch.Tensor:
    """The parent a vertex: ``pick`` (``amin``, the stated rule, or
    ``amax``) over its in-neighbours one level up."""
    src, dst = edges[:, 0], edges[:, 1]
    lsrc, ldst = level[src], level[dst]
    up = (ldst > 0) & (lsrc == ldst - 1)
    parent = torch.full_like(level, UNREACHED)
    parent.scatter_reduce_(0, dst[up], src[up], pick, include_self=False)
    parent[root] = root
    return parent


def bfs(edges: torch.Tensor, n: int, root: int, max_levels: int,
        pick: str = "amin") -> tuple[torch.Tensor, int]:
    """``(parents, rounds)`` of a search from ``root``."""
    level, rounds = levels(edges, n, root, max_levels)
    return parents_from_levels(edges, level, root, pick), rounds
