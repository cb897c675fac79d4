"""Standalone unbatched entry point of the ELL SpMV.

The production dispatch for the superstep programs is
``core/localops.py`` (``spmv_pull`` / ``scatter_combine``), which drives
the kernel once per blocked-ELL bucket for all stacked parts."""

from __future__ import annotations

import torch

from repro_torch.kernels.spmv.kernel import spmv_ell


def spmv(idx: torch.Tensor, val: torch.Tensor,
         x: torch.Tensor) -> torch.Tensor:
    """idx/val: (n_rows, K); x: (n_cols,).  Returns y: (n_rows,) f32 —
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    return spmv_ell(idx.contiguous()[None], val.float().contiguous()[None],
                    x.float().contiguous()[None])[0]
