"""The benchmark's graphs, in plain torch, on the device.

A configuration file names its generator, sizes, parts and
``structure_seed``.  ``make_edges`` draws ``edge_factor * 2**scale``
edges of that structure on the given device in a few large calls, by
the family's file under ``generators/`` (``urand``: GAP's uniform random
graph; ``kron``: the Graph500 Kronecker generator).  A configuration
that says ``symmetric`` is then made undirected as GAP builds its
graphs: both directions of every edge, self-loops and repeated edges
dropped.

It then relabels the vertices inside each of the ``parts`` blocks of
contiguous ids by a permutation drawn from ``--seed``.  So every seed
runs the same graph with the same vertices in each part: the same
degrees, levels and per-part loads, the same work, under other ids and
another order of the edges within each part.  The same seed on the same
device gives the same edges.
"""

from __future__ import annotations

import importlib

import torch


def torch_seed(seed: int) -> int:
    """``--seed`` (any whole number) as a ``manual_seed`` value."""
    return int(seed) % (1 << 63)


def generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    return gen


def sizes(cfg: dict) -> tuple[int, int]:
    """``(vertices, edges drawn)`` of a configuration; a symmetric
    graph holds up to twice as many directed edges."""
    n = 1 << int(cfg["scale"])
    return n, int(cfg["edge_factor"]) * n


def family(name: str):
    """``generators/<name>.py``: a graph family, found by its name."""
    return importlib.import_module(f"graphbench.generators.{name}")


def make_edges(cfg: dict, seed: int, device) -> torch.Tensor:
    """The ``(E, 2)`` int64 ``[src, dst]`` edge list of ``cfg``,
    symmetrised where it says so, its ids permuted inside each part from
    ``seed``."""
    n, e = sizes(cfg)
    gen = generator(int(cfg["structure_seed"]), device)
    edges = family(cfg["generator"]).make(cfg, n, e, gen, device)
    if cfg.get("symmetric", False):
        edges = symmetrise(edges, n)
    return relabel_within_parts(n, int(cfg["parts"]), seed, device)[edges]


def symmetrise(edges: torch.Tensor, n: int) -> torch.Tensor:
    """The undirected graph of ``edges`` as GAP builds it: both
    directions of every edge, self-loops and repeated edges dropped;
    sorted by ``(src, dst)``."""
    src, dst = edges[:, 0], edges[:, 1]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    key = torch.unique(torch.cat([src * n + dst, dst * n + src]))
    return torch.stack([key // n, key % n], dim=1)


def relabel_within_parts(n: int, parts: int, seed: int,
                         device) -> torch.Tensor:
    """A permutation of ``range(n)`` that keeps each of the ``parts``
    blocks of ``n // parts`` contiguous ids in place, drawn from
    ``seed``."""
    if n % parts:
        raise ValueError(f"{parts} parts do not divide {n} vertices")
    block = n // parts
    gen = generator(seed, device)
    keys = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    keys += torch.arange(n, device=device) // block
    return torch.argsort(keys)


def draw_roots(out_degree: torch.Tensor, count: int, seed: int
               ) -> torch.Tensor:
    """``count`` roots drawn uniformly, from ``seed``, among the vertices
    with at least one out-edge (Graph500's rule), as a host int64
    tensor."""
    candidates = torch.nonzero(out_degree > 0).reshape(-1)
    if candidates.numel() == 0:
        raise ValueError("no vertex has an out-edge")
    # a stream of its own, so the roots do not depend on how many
    # numbers the edges took
    gen = generator(seed ^ 0x5EED, out_degree.device)
    pick = torch.randint(0, candidates.numel(), (count,), generator=gen,
                         device=out_degree.device)
    return candidates[pick].cpu()
