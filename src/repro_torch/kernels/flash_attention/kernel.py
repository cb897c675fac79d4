"""Flash attention forward on Hopper: the checked wrapper of
``csrc/flash_attention_fwd.cu``.

Replaces the Pallas TPU kernel ``flash_attention_fwd``
(``src/repro/kernels/flash_attention/kernel.py``, body ``_flash_kernel``):
blocked online-softmax attention on ``(BH, S, D)`` with f32 scores
``q k^T / sqrt(D)``, optional softcap ``tanh(s / c) * c``, causal and
sliding-window masks, f32 running max, sum and accumulator, output in
q's dtype.

Bound on the H100 SXM (data-sheet peaks, 700 W limit) at TinyLlama-1.1B
prefill: bytes (0.040 ms for q, k, v and o), with the bf16 tensor-core
time for the same work (0.035 ms) close behind.  The CUDA source
describes the two designs, chosen by dtype: bf16 runs on the tensor
cores (wgmma, TMA, warp-specialised), f32 on the CUDA cores.

It takes f32 or bf16, any head dim D that is a multiple of 8 up to 256
(the scale is the true ``1/sqrt(D)``), and any Sq, Sk.  For CPU tensors
the wrapper runs the plain version (``ref.py``); for CUDA tensors it
launches the kernel or raises.  ``return_lse=True`` also returns each
row's f32 log-sum-exp ``(BH, Sq)``, the residual of the training
backward (``models/layers.py``); ``o`` has the same bits either way.  ``flash_attention_fwd.launches`` counts
kernel launches, ``flash_attention_fwd.launches_tc`` those of them that
ran the bf16 tensor-core design.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_lib: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load("flash_attention_fwd")
        lib.flash_attention_fwd_launch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,       # q, k
            ctypes.c_void_p, ctypes.c_void_p,       # v, o
            ctypes.c_void_p,                        # lse (or null)
            ctypes.c_int, ctypes.c_int,             # bh, sq
            ctypes.c_int, ctypes.c_int,             # sk, d
            ctypes.c_int, ctypes.c_float,           # dtype, scale
            ctypes.c_int, ctypes.c_int,             # causal, window
            ctypes.c_float,                         # softcap
            ctypes.c_void_p]                        # stream
        lib.flash_attention_fwd_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q, k, v):
    from torch.distributed.tensor import DTensor
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention_fwd takes each rank's own shard "
                        "(models/layers.py runs it per shard), not a "
                        "DTensor")
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be (BH, S, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    bh, _, d = q.shape
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != bh \
            or k.shape[2] != d:
        raise ValueError(f"k and v must be ({bh}, Sk, {d}), got "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share a dtype in float32/bfloat16, "
                         f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if d % 8 or not 8 <= d <= 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, "
                         f"got {d}")
    if q.shape[1] < 1 or k.shape[1] < 1:
        raise ValueError("Sq and Sk must be at least 1")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: int = 0,
                        softcap: float = 0.0, return_lse: bool = False):
    """q (BH, Sq, D), k/v (BH, Sk, D), contiguous, f32 or bf16.
    Returns (BH, Sq, D) in q's dtype, and with ``return_lse`` the
    (BH, Sq) f32 log-sum-exp beside it."""
    _check(q, k, v)
    if not q.is_cuda:
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, return_lse=return_lse)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("bf16 q, k, v must start on 16-byte boundaries "
                         "(TMA loads them)")
    lib = _library()
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    code = lib.flash_attention_fwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), bh, sq, k.shape[1], d,
        _DTYPES[q.dtype], d ** -0.5, int(bool(causal)), int(window),
        float(softcap or 0.0),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_attention_fwd", code)
    flash_attention_fwd.launches += 1
    if q.dtype == torch.bfloat16:
        flash_attention_fwd.launches_tc += 1
    return (o, lse) if return_lse else o


flash_attention_fwd.launches = 0
flash_attention_fwd.launches_tc = 0
