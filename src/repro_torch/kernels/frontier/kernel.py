"""BFS pull step on Hopper: the checked wrapper of ``csrc/bfs_pull.cu``.

Replaces the Pallas TPU kernel ``bfs_pull``
(``src/repro/kernels/frontier/kernel.py``, body ``_frontier_kernel``):
per row, the min neighbor id whose bit ``bits[id >> 5] >> (id & 31) & 1``
is set; INT_INF = 2**30 if none is or if ``unvisited[r] != 1``.

Bound on the H100: bytes.  Per slot of an unvisited row a 4-byte
neighbor id and a 4-byte bitmap word (the n/8-byte bitmap stays in
L2); per row a 4-byte flag read and a 4-byte parent written.  Visited
rows skip their slots, so late BFS levels read little.  The CUDA source
describes the mapping.

For CPU tensors the wrapper runs the plain version (``ref.py``); for
CUDA tensors it launches the kernel or raises.  ``bfs_pull.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.frontier.ref import INT_INF, bfs_pull_ref

__all__ = ["INT_INF", "bfs_pull"]

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("bfs_pull")
        lib.bfs_pull_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong,     # nbr, batch stride
            ctypes.c_void_p, ctypes.c_longlong,     # bits, batch stride
            ctypes.c_void_p, ctypes.c_longlong,     # unvisited, stride
            ctypes.c_void_p,                        # out
            ctypes.c_int, ctypes.c_int, ctypes.c_int,   # batch, rows, K
            ctypes.c_void_p]                        # stream
        lib.bfs_pull_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    if bits.dtype != torch.int32 or bits.dim() != 2 or bits.shape[0] != b:
        raise ValueError(f"bits must be ({b}, W) int32 words, got "
                         f"{tuple(bits.shape)} {bits.dtype}")
    if bits.stride(1) != 1:
        raise ValueError("bits words must be contiguous")
    if unvisited.dtype != torch.int32 or tuple(unvisited.shape) != (b, rows):
        raise ValueError(f"unvisited must be {(b, rows)} int32, got "
                         f"{tuple(unvisited.shape)} {unvisited.dtype}")
    if unvisited.stride(1) != 1:
        raise ValueError("unvisited rows must be contiguous")
    devices = {nbr.device, bits.device, unvisited.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def bfs_pull(nbr: torch.Tensor, bits: torch.Tensor,
             unvisited: torch.Tensor) -> torch.Tensor:
    """nbr (B, rows, K) int32 with values < 32 * W; bits (B, W) int32
    words; unvisited (B, rows) int32.  Returns parents (B, rows) int32."""
    _check(nbr, bits, unvisited)
    if not nbr.is_cuda:
        return bfs_pull_ref(nbr, bits, unvisited)
    lib = _library()
    b, rows, k = nbr.shape
    out = torch.empty((b, rows), dtype=torch.int32, device=nbr.device)
    code = lib.bfs_pull_launch(
        nbr.data_ptr(), nbr.stride(0), bits.data_ptr(), bits.stride(0),
        unvisited.data_ptr(), unvisited.stride(0), out.data_ptr(),
        b, rows, k, torch.cuda.current_stream(nbr.device).cuda_stream)
    _build.check(lib, "bfs_pull", code)
    bfs_pull.launches += 1
    return out


bfs_pull.launches = 0
