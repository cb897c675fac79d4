"""ELL SpMV on Hopper: the checked wrappers of ``csrc/spmv_ell.cu``.

Replaces the Pallas TPU kernel ``spmv_ell``
(``src/repro/kernels/spmv/kernel.py``, body ``_spmv_kernel``):
``y[b, r] = sum_k w[b, r, k] * x[b, idx[b, r, k]]`` with f32 output,
the slots of a row added one at a time, left to right.

Two entry points run the same kernel:

- ``spmv_ell(idx, val, x, skip=)``, the TPU kernel's function on one
  bucket ``(B, rows, K)``;
- ``spmv_ell_buckets(idx, val, x, buckets, skip=)``, every bucket of a
  blocked-ELL structure ``(P, slots)`` in one launch, the rows in ELL
  order (what ``core/localops.py`` calls).

Bound on the H100: bytes.  Per slot a 4-byte index, a 4-byte gathered x
value and, with ``val``, a 4-byte weight; per row a 4-byte output.  The
design (one persistent launch over the bucket table, a thread per row
with a batch of gathers in flight, L2 evict_last for x) is described in
the CUDA source.  The main path passes ``val=None, skip=sentinel``: a
slot holding ``skip`` is never read, so x needs no pad slot.

For CPU tensors the wrappers run the plain versions (``ref.py``), which
give the kernel's bits; for CUDA tensors they launch the kernel or
raise.  ``spmv_ell.launches`` counts kernel launches of both.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._ell import check_table, launch_tables
from repro_torch.kernels.spmv.ref import spmv_ell_buckets_ref, spmv_ell_ref

INTERFACE = 2   # spmv_ell_interface() of csrc/spmv_ell.cu: the bucket table

_lib: ctypes.CDLL | None = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's arguments on a loaded library; raise
    unless the library has this interface (a build of another checkout
    may not)."""
    version = getattr(lib, "spmv_ell_interface", None)
    if version is None or version() != INTERFACE:
        raise RuntimeError(f"{lib._name}: not spmv_ell C interface "
                           f"{INTERFACE}")
    lib.spmv_ell_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,     # idx, part stride
        ctypes.c_void_p, ctypes.c_longlong,     # val (or NULL), stride
        ctypes.c_void_p, ctypes.c_longlong,     # x, part stride (may be 0)
        ctypes.c_void_p, ctypes.c_longlong,     # y, part stride
        ctypes.c_int,                           # parts
        ctypes.c_void_p, ctypes.c_int,          # bucket table, buckets
        ctypes.c_int,                           # skip
        ctypes.c_void_p]                        # stream
    lib.spmv_ell_launch.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(_build.load("spmv_ell"))
    return _lib


def _check_x(x, parts):
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != parts:
        raise ValueError(f"x must be ({parts}, n_cols) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.stride(1) != 1 or x.shape[1] < 1:
        raise ValueError("x needs n_cols >= 1 contiguous columns")


def _check_devices(*ts):
    devices = {t.device for t in ts if t is not None}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


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
    _check_x(x, b)
    _check_devices(idx, val, x)


def launch(lib: ctypes.CDLL, idx: torch.Tensor, val: torch.Tensor | None,
           x: torch.Tensor, y: torch.Tensor, buckets: tuple,
           skip: int | None) -> int:
    """Launch the kernel of ``lib`` on checked inputs, once per bucket
    table of ``buckets``; return the number of launches."""
    stream = torch.cuda.current_stream(y.device).cuda_stream
    tables = launch_tables(buckets)
    for table, nb in tables:
        code = lib.spmv_ell_launch(
            idx.data_ptr(), idx.stride(0),
            None if val is None else val.data_ptr(),
            0 if val is None else val.stride(0), x.data_ptr(), x.stride(0),
            y.data_ptr(), y.stride(0), y.shape[0], table, nb,
            -1 if skip is None else int(skip), stream)
        _build.check(lib, "spmv_ell", code)
    return len(tables)


def spmv_ell(idx: torch.Tensor, val: torch.Tensor | None, x: torch.Tensor,
             *, skip: int | None = None) -> torch.Tensor:
    """idx (B, rows, K) int32 with values < n_cols (or == skip); val
    (B, rows, K) f32 or None; x (B, n_cols) f32.  Returns y (B, rows)
    f32."""
    _check(idx, val, x, skip)
    if not idx.is_cuda:
        return spmv_ell_ref(idx, val, x, skip=skip)
    b, rows, k = idx.shape
    y = torch.empty((b, rows), dtype=torch.float32, device=idx.device)
    spmv_ell.launches += launch(_library(), idx, val, x, y, ((rows, k),),
                                skip)
    return y


spmv_ell.launches = 0


def spmv_ell_buckets(idx: torch.Tensor, val: torch.Tensor | None,
                     x: torch.Tensor, buckets, *,
                     skip: int | None = None) -> torch.Tensor:
    """idx (P, slots) int32 laid out by ``buckets`` (``EllMeta.buckets``:
    (rows, K) runs), values < n_cols or == skip; val (P, slots) f32 or
    None (then ``skip`` is required); x (P, n_cols) f32, any part stride.
    Returns y (P, n_rows) f32 in ELL row order; a zero-width bucket's
    rows are 0."""
    buckets, rows = check_table(idx, buckets, "idx")
    if val is None:
        if skip is None:
            raise ValueError("pass val, or skip to weight slots by "
                             "idx != skip")
    elif (val.dtype != torch.float32 or val.shape != idx.shape
          or val.stride(1) != 1):
        raise ValueError(f"val must be {tuple(idx.shape)} float32 with "
                         f"contiguous slots, got {tuple(val.shape)} "
                         f"{val.dtype}")
    _check_x(x, idx.shape[0])
    _check_devices(idx, val, x)
    if not idx.is_cuda:
        return spmv_ell_buckets_ref(idx, val, x, buckets, skip=skip)
    y = torch.empty((idx.shape[0], rows), dtype=torch.float32,
                    device=idx.device)
    spmv_ell.launches += launch(_library(), idx, val, x, y, buckets, skip)
    return y
