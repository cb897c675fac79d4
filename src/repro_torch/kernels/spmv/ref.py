"""Plain-PyTorch versions of the ELL SpMV kernel.

Both add a row's slots one at a time, left to right, in float32 (the
order ``csrc/spmv_ell.cu`` adds in, and ``localops``' ell path), so the
kernel equals them bit for bit."""

from __future__ import annotations

import torch

from repro_torch.kernels._ell import bucket_views


def sum_slots(a: torch.Tensor) -> torch.Tensor:
    """(..., K) -> (...) sums taken slot by slot, left to right: the order
    the JAX package's CPU row reduction adds in (``localops``' ell path
    gives its bits) and the kernel's."""
    acc = a[..., 0].clone()
    for s in range(1, a.shape[-1]):
        acc += a[..., s]
    return acc


def spmv_ell_ref(idx: torch.Tensor, val: torch.Tensor | None,
                 x: torch.Tensor, *, skip: int | None = None) -> torch.Tensor:
    """idx (B, rows, K) int32; val (B, rows, K) f32, or None to weight
    each slot by ``idx != skip`` (a skipped slot is never read, so
    ``skip`` may lie past x); x (B, n_cols).  Returns (B, rows) f32:
    ``y[b, r] = sum_k w[b, r, k] * x[b, idx[b, r, k]]``, in slot order."""
    b, rows, k = idx.shape
    x = x.float()
    if val is None:
        keep = idx != skip
        gathered = torch.gather(x, 1, torch.where(keep, idx, 0)
                                .reshape(b, rows * k)).reshape(b, rows, k)
        return sum_slots(torch.where(keep, gathered, 0.0))
    gathered = torch.gather(x, 1, idx.reshape(b, rows * k)) \
        .reshape(b, rows, k)
    return sum_slots(gathered * val)


def spmv_ell_buckets_ref(idx: torch.Tensor, val: torch.Tensor | None,
                         x: torch.Tensor, buckets, *,
                         skip: int | None = None) -> torch.Tensor:
    """idx (P, slots) int32 laid out by ``buckets`` ((rows, K) runs);
    val (P, slots) f32 or None; x (P, n_cols).  Returns (P, n_rows) f32
    in ELL row order: each bucket's ``spmv_ell_ref``, concatenated; a
    zero-width bucket gives 0."""
    vals = bucket_views(val, buckets) if val is not None else None
    outs = []
    for _, rows, k, blk in bucket_views(idx, buckets):
        v = next(vals)[3] if vals is not None else None
        outs.append(spmv_ell_ref(blk, v, x, skip=skip) if k else
                    torch.zeros((idx.shape[0], rows), dtype=torch.float32,
                                device=idx.device))
    return torch.cat(outs, dim=1)
