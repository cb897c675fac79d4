"""Plain-PyTorch versions of the BFS pull kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels._ell import bucket_views

INT_INF = 2 ** 30


def bfs_pull_ref(nbr: torch.Tensor, bits: torch.Tensor,
                 unvisited: torch.Tensor, *,
                 skip: int | None = None) -> torch.Tensor:
    """nbr (B, rows, K) int32; bits (B, W) int32 words; unvisited
    (B, rows).  Returns (B, rows) int32: the min neighbor id whose bit
    is set, INT_INF if none is or the row's unvisited flag is not 1.  A
    slot equal to ``skip`` is a miss (and may lie past the bitmap)."""
    b, rows, k = nbr.shape
    keep = nbr != skip if skip is not None else torch.ones_like(
        nbr, dtype=torch.bool)
    word = torch.gather(bits, 1, torch.where(keep, nbr >> 5, 0)
                        .reshape(b, rows * k)).reshape(b, rows, k)
    hit = keep & (((word >> (nbr & 31)) & 1) == 1)
    parent = torch.where(hit, nbr, INT_INF).amin(dim=2)
    return torch.where(unvisited.to(torch.int32) == 1, parent, INT_INF)


def bfs_pull_buckets_ref(nbr: torch.Tensor, bits: torch.Tensor,
                         unvisited: torch.Tensor, buckets, *,
                         skip: int | None = None) -> torch.Tensor:
    """nbr (P, slots) int32 laid out by ``buckets`` ((rows, K) runs);
    bits (P, W) int32 words; unvisited (P, n_rows) flags in ELL row
    order.  Returns (P, n_rows) int32: each bucket's ``bfs_pull_ref``,
    concatenated; a zero-width bucket gives INT_INF."""
    outs = []
    for r0, rows, k, blk in bucket_views(nbr, buckets):
        outs.append(bfs_pull_ref(blk, bits, unvisited[:, r0:r0 + rows],
                                 skip=skip) if k else
                    torch.full((nbr.shape[0], rows), INT_INF,
                               dtype=torch.int32, device=nbr.device))
    return torch.cat(outs, dim=1)
