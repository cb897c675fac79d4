"""ELL SpMV on Hopper: the checked wrapper of ``csrc/spmv_ell.cu``.

Replaces the Pallas TPU kernel ``spmv_ell``
(``src/repro/kernels/spmv/kernel.py``, body ``_spmv_kernel``):
``y[b, r] = sum_k w[b, r, k] * x[b, idx[b, r, k]]`` with f32 output.

Bound on the H100: bytes.  Per slot a 4-byte index, a 4-byte gathered x
value and, with ``val``, a 4-byte weight; per row a 4-byte output.  The
design (one group of lanes per row, coalesced index reads, x resident in
L2, shuffle row sums, one launch for all stacked parts) is described in
the CUDA source.  The main path passes ``val=None, skip=sentinel``,
which reads no weights.

For CPU tensors the wrapper runs the plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises.  ``spmv_ell.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.spmv.ref import spmv_ell_ref

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("spmv_ell")
        lib.spmv_ell_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,     # idx, batch stride
            ctypes.c_void_p, ctypes.c_longlong,     # val (or NULL), stride
            ctypes.c_void_p, ctypes.c_longlong,     # x, batch stride
            ctypes.c_void_p,                        # y
            ctypes.c_int, ctypes.c_int, ctypes.c_int,   # batch, rows, K
            ctypes.c_int,                           # skip
            ctypes.c_void_p]                        # stream
        lib.spmv_ell_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(idx, val, x, skip):
    if idx.dtype != torch.int32 or idx.dim() != 3:
        raise ValueError(f"idx must be (B, rows, K) int32, got "
                         f"{tuple(idx.shape)} {idx.dtype}")
    b, rows, k = idx.shape
    if rows < 1 or k < 1:
        raise ValueError(f"idx needs rows >= 1 and K >= 1, got "
                         f"{tuple(idx.shape)}")
    if idx.stride(2) != 1 or idx.stride(1) != k:
        raise ValueError("idx rows and slots must be contiguous")
    if val is None:
        if skip is None:
            raise ValueError("pass val, or skip to weight slots by "
                             "idx != skip")
    else:
        if val.dtype != torch.float32 or tuple(val.shape) != (b, rows, k):
            raise ValueError(f"val must be {(b, rows, k)} float32, got "
                             f"{tuple(val.shape)} {val.dtype}")
        if val.stride(2) != 1 or val.stride(1) != k:
            raise ValueError("val rows and slots must be contiguous")
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != b:
        raise ValueError(f"x must be ({b}, n_cols) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.stride(1) != 1:
        raise ValueError("x columns must be contiguous")
    devices = {t.device for t in (idx, val, x) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def spmv_ell(idx: torch.Tensor, val: torch.Tensor | None, x: torch.Tensor,
             *, skip: int | None = None) -> torch.Tensor:
    """idx (B, rows, K) int32 with values < n_cols; val (B, rows, K) f32
    or None; x (B, n_cols) f32.  Returns y (B, rows) f32."""
    _check(idx, val, x, skip)
    if not idx.is_cuda:
        return spmv_ell_ref(idx, val, x, skip=skip)
    lib = _library()
    b, rows, k = idx.shape
    y = torch.empty((b, rows), dtype=torch.float32, device=idx.device)
    code = lib.spmv_ell_launch(
        idx.data_ptr(), idx.stride(0),
        val.data_ptr() if val is not None else None,
        val.stride(0) if val is not None else 0,
        x.data_ptr(), x.stride(0), y.data_ptr(),
        b, rows, k, -1 if skip is None else int(skip),
        torch.cuda.current_stream(idx.device).cuda_stream)
    _build.check(lib, "spmv_ell", code)
    spmv_ell.launches += 1
    return y


spmv_ell.launches = 0
