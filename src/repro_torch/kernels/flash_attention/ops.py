"""Dispatch wrapper for flash attention.

The ``(B, S, H, D) <-> (B*H, S, D)`` adapter around the kernel, and the
choice of path: on CUDA tensors the Hopper kernel (the role the Pallas
kernel has on the TPU), on CPU tensors the plain chunked forward of
``models/layers.py`` (the role of ``flash_attention_xla``).  The kernel
takes any head dim that is a multiple of 8 up to 256, so the
reference's padding to 128 and its rescale of q are not needed.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd


def _to_bh(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, s, d).contiguous()


def flash_attention_kernel(q, k, v, *, causal=True, window=0, softcap=0.0,
                           return_lse=False):
    """q/k/v (B, S, H, D), kv heads pre-repeated -> (B, Sq, H, D) through
    the kernel wrapper (its plain version for CPU tensors); with
    ``return_lse`` also the f32 log-sum-exp as (B, H, Sq)."""
    b, sq, h, d = q.shape
    o = flash_attention_fwd(_to_bh(q), _to_bh(k), _to_bh(v), causal=causal,
                            window=window, softcap=softcap,
                            return_lse=return_lse)
    if return_lse:
        o, lse = o
        return o.reshape(b, h, sq, d).transpose(1, 2), lse.reshape(b, h, sq)
    return o.reshape(b, h, sq, d).transpose(1, 2)


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q/k/v (B, S, H, D) with kv heads pre-repeated -> (B, Sq, H, D)."""
    if q.is_cuda:
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      softcap=softcap)
    from repro_torch.models.layers import flash_attention_chunked
    return flash_attention_chunked(q, k, v, causal=causal, window=window,
                                   softcap=softcap)
