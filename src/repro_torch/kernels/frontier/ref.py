"""Plain-PyTorch version of the BFS pull kernel."""

from __future__ import annotations

import torch

INT_INF = 2 ** 30


def bfs_pull_ref(nbr: torch.Tensor, bits: torch.Tensor,
                 unvisited: torch.Tensor) -> torch.Tensor:
    """nbr (B, rows, K) int32; bits (B, W) int32 words; unvisited
    (B, rows).  Returns (B, rows) int32: the min neighbor id whose bit
    is set, INT_INF if none is or the row's unvisited flag is not 1."""
    b, rows, k = nbr.shape
    word = torch.gather(bits, 1, (nbr >> 5).reshape(b, rows * k)) \
        .reshape(b, rows, k)
    hit = ((word >> (nbr & 31)) & 1) == 1
    parent = torch.where(hit, nbr, INT_INF).amin(dim=2)
    return torch.where(unvisited.to(torch.int32) == 1, parent, INT_INF)
