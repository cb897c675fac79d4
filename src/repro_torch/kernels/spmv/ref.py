"""Plain-PyTorch version of the ELL SpMV kernel."""

from __future__ import annotations

import torch


def spmv_ell_ref(idx: torch.Tensor, val: torch.Tensor | None,
                 x: torch.Tensor, *, skip: int | None = None) -> torch.Tensor:
    """idx (B, rows, K) int32; val (B, rows, K) f32, or None to weight
    each slot by ``idx != skip``; x (B, n_cols).  Returns (B, rows) f32:
    ``y[b, r] = sum_k w[b, r, k] * x[b, idx[b, r, k]]``."""
    b, rows, k = idx.shape
    gathered = torch.gather(x.float(), 1, idx.reshape(b, rows * k)) \
        .reshape(b, rows, k)
    if val is None:
        return torch.where(idx != skip, gathered, 0.0).sum(dim=2)
    return (gathered * val).sum(dim=2)
