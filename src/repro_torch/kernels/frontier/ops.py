"""Standalone unbatched entry point of the BFS pull step.

The production dispatch for the superstep programs is
``core/localops.py`` (``frontier_pull``), which drives the kernel once
per blocked-ELL bucket for all stacked parts."""

from __future__ import annotations

import torch

from repro_torch.kernels.frontier.kernel import bfs_pull


def frontier_pull(nbr: torch.Tensor, bits: torch.Tensor,
                  unvisited: torch.Tensor) -> torch.Tensor:
    """nbr: (n_rows, K) int32; bits: (W,) int32 words; unvisited:
    (n_rows,).  Returns parents (n_rows,) int32 — the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    return bfs_pull(nbr.contiguous()[None], bits.contiguous()[None],
                    unvisited.to(torch.int32).contiguous()[None])[0]
