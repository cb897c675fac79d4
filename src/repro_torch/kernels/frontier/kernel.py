"""BFS pull step on Hopper: the checked wrappers of ``csrc/bfs_pull.cu``.

Replaces the Pallas TPU kernel ``bfs_pull``
(``src/repro/kernels/frontier/kernel.py``, body ``_frontier_kernel``):
per row, the min neighbor id whose bit ``bits[id >> 5] >> (id & 31) & 1``
is set; INT_INF = 2**30 if none is or if ``unvisited[r] != 1``.

Two entry points run the same kernel:

- ``bfs_pull(nbr, bits, unvisited)``, the TPU kernel's function on one
  bucket ``(B, rows, K)``;
- ``bfs_pull_buckets(nbr, bits, unvisited, buckets, skip=)``, every
  bucket of a blocked-ELL structure ``(P, slots)`` in one launch, the
  rows in ELL order (what ``core/localops.py`` calls).  A slot holding
  ``skip`` is a miss and reads no bitmap word, so the bitmap needs no
  guard word for the ELL sentinel.

Flags are uint8 or bool (one byte a row) or int32 (the TPU kernel's
type).  Bound on the H100: bytes.  Per slot of a live row a 4-byte
neighbor id and a 4-byte bitmap word (the n/8-byte bitmap stays in
L2); per row a flag read and a 4-byte parent written.  The design (one
persistent launch over the bucket table, a thread per row with a batch
of word loads in flight, a ballot that skips tiles with no live row) is
described in the CUDA source.

For CPU tensors the wrappers run the plain versions (``ref.py``); for
CUDA tensors they launch the kernel or raise.  ``bfs_pull.launches``
counts kernel launches of both.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._ell import check_table, launch_tables
from repro_torch.kernels.frontier.ref import INT_INF, bfs_pull_buckets_ref, \
    bfs_pull_ref

__all__ = ["INT_INF", "bfs_pull", "bfs_pull_buckets"]

FLAG_TYPES = (torch.bool, torch.uint8, torch.int32)

INTERFACE = 2   # bfs_pull_interface() of csrc/bfs_pull.cu: the bucket table

_lib: ctypes.CDLL | None = None


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's arguments on a loaded library; raise
    unless the library has this interface (a build of another checkout
    may not)."""
    version = getattr(lib, "bfs_pull_interface", None)
    if version is None or version() != INTERFACE:
        raise RuntimeError(f"{lib._name}: not bfs_pull C interface "
                           f"{INTERFACE}")
    lib.bfs_pull_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong,     # nbr, part stride
        ctypes.c_void_p, ctypes.c_longlong,     # bits, stride (may be 0)
        ctypes.c_void_p, ctypes.c_longlong,     # unvisited, stride
        ctypes.c_int,                           # flag bytes: 1 or 4
        ctypes.c_void_p, ctypes.c_longlong,     # out, part stride
        ctypes.c_int,                           # parts
        ctypes.c_void_p, ctypes.c_int,          # bucket table, buckets
        ctypes.c_int,                           # skip
        ctypes.c_void_p]                        # stream
    lib.bfs_pull_launch.restype = ctypes.c_int
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        _lib = bind(_build.load("bfs_pull"))
    return _lib


def _check_bits(bits, parts):
    if bits.dtype != torch.int32 or bits.dim() != 2 or bits.shape[0] != parts:
        raise ValueError(f"bits must be ({parts}, W) int32 words, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if bits.stride(1) != 1:
        raise ValueError("bits words must be contiguous")


def _check_flags(unvisited, shape):
    if unvisited.dtype not in FLAG_TYPES or tuple(unvisited.shape) != shape:
        raise ValueError(f"unvisited must be {shape} bool, uint8 or int32, "
                         f"got {tuple(unvisited.shape)} {unvisited.dtype}")
    if unvisited.stride(1) != 1:
        raise ValueError("unvisited rows must be contiguous")


def _check(nbr, bits, unvisited):
    if nbr.dtype != torch.int32 or nbr.dim() != 3:
        raise ValueError(f"nbr must be (B, rows, K) int32, got "
                         f"{tuple(nbr.shape)} {nbr.dtype}")
    b, rows, k = nbr.shape
    if rows < 1 or k < 1:
        raise ValueError(f"nbr needs rows >= 1 and K >= 1, got "
                         f"{tuple(nbr.shape)}")
    if nbr.stride(2) != 1 or nbr.stride(1) != k:
        raise ValueError("nbr rows and slots must be contiguous")
    _check_bits(bits, b)
    _check_flags(unvisited, (b, rows))
    devices = {nbr.device, bits.device, unvisited.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def launch(lib: ctypes.CDLL, nbr: torch.Tensor, bits: torch.Tensor,
           unvisited: torch.Tensor, out: torch.Tensor, buckets: tuple,
           skip: int | None) -> int:
    """Launch the kernel of ``lib`` on checked inputs, once per bucket
    table of ``buckets``; return the number of launches."""
    stream = torch.cuda.current_stream(out.device).cuda_stream
    tables = launch_tables(buckets)
    for table, nb in tables:
        code = lib.bfs_pull_launch(
            nbr.data_ptr(), nbr.stride(0), bits.data_ptr(), bits.stride(0),
            unvisited.data_ptr(), unvisited.stride(0),
            unvisited.element_size(), out.data_ptr(), out.stride(0),
            out.shape[0], table, nb, -1 if skip is None else int(skip),
            stream)
        _build.check(lib, "bfs_pull", code)
    return len(tables)


def bfs_pull(nbr: torch.Tensor, bits: torch.Tensor,
             unvisited: torch.Tensor) -> torch.Tensor:
    """nbr (B, rows, K) int32 with values < 32 * W; bits (B, W) int32
    words; unvisited (B, rows) bool, uint8 or int32.  Returns parents
    (B, rows) int32."""
    _check(nbr, bits, unvisited)
    if not nbr.is_cuda:
        return bfs_pull_ref(nbr, bits, unvisited)
    b, rows, k = nbr.shape
    out = torch.empty((b, rows), dtype=torch.int32, device=nbr.device)
    bfs_pull.launches += launch(_library(), nbr, bits, unvisited, out,
                                ((rows, k),), None)
    return out


bfs_pull.launches = 0


def bfs_pull_buckets(nbr: torch.Tensor, bits: torch.Tensor,
                     unvisited: torch.Tensor, buckets, *,
                     skip: int | None = None) -> torch.Tensor:
    """nbr (P, slots) int32 laid out by ``buckets`` (``EllMeta.buckets``:
    (rows, K) runs), values < 32 * W or == skip; bits (P, W) int32 words,
    any part stride; unvisited (P, n_rows) bool, uint8 or int32 flags in
    ELL row order.  Returns parents (P, n_rows) int32 in ELL row order; a
    zero-width bucket's rows are INT_INF."""
    buckets, rows = check_table(nbr, buckets, "nbr")
    _check_bits(bits, nbr.shape[0])
    _check_flags(unvisited, (nbr.shape[0], rows))
    devices = {nbr.device, bits.device, unvisited.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")
    if not nbr.is_cuda:
        return bfs_pull_buckets_ref(nbr, bits, unvisited, buckets, skip=skip)
    out = torch.empty((nbr.shape[0], rows), dtype=torch.int32,
                      device=nbr.device)
    bfs_pull.launches += launch(_library(), nbr, bits, unvisited, out,
                                buckets, skip)
    return out
