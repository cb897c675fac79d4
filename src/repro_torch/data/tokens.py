"""Deterministic synthetic token pipeline.

Produces a reproducible token stream without external data: tokens are
a stateless hash of (seed, stream position), so any worker can
materialize any batch index independently.  A light Zipfian shaping
makes the stream non-uniform.

The hash is uint32 arithmetic with wrap-around, done in numpy: PyTorch's
CPU kernels do not shift uint32, and int64 products of two 32-bit values
overflow.  The power goes through the C library's ``powf``, which is what
the JAX package's float32 ``jnp.power`` computes on the CPU; numpy's and
PyTorch's vectorised float32 powers differ from it by an ulp at times,
enough to move a token across a boundary.  The tokens are byte-identical
to the JAX package's.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from dataclasses import dataclass

import numpy as np
import torch


def _hash_u32(x: np.ndarray, seed: int) -> np.ndarray:
    x = x.astype(np.uint32) + np.uint32(seed)
    x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
    x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
    return x ^ (x >> np.uint32(16))


def _powf(x: np.ndarray, y: float) -> np.ndarray:
    """float32 ``x ** y``, element by element through libm's powf."""
    powf = ctypes.CDLL(ctypes.util.find_library("m")).powf
    powf.restype = ctypes.c_float
    powf.argtypes = [ctypes.c_float, ctypes.c_float]
    y = float(np.float32(y))
    return np.array([powf(v, y) for v in x.tolist()], dtype=np.float32)


def batch_at(step: int, *, global_batch: int, seq_len: int, vocab_size: int,
             seed: int = 0, zipf: float = 1.3) -> torch.Tensor:
    """Tokens for a given step: (global_batch, seq_len) int32 on the CPU.

    Stateless: batch_at(k) is identical across restarts and hosts.
    """
    n = global_batch * seq_len
    base = np.uint32(step) * np.uint32(n)
    pos = base + np.arange(n, dtype=np.uint32)
    h = _hash_u32(pos, seed)
    u = (h.astype(np.float32) + np.float32(0.5)) / np.float32(2 ** 32)
    # inverse-CDF of a truncated Zipf-ish distribution
    r = _powf(u, zipf)
    toks = np.clip((r * np.float32(vocab_size)).astype(np.int32), 0,
                   vocab_size - 1)
    # inject local correlation: every position mixes with its predecessor
    mixed = np.where(h % 4 == 0, np.roll(toks, 1), toks)
    return torch.from_numpy(mixed.reshape(global_batch, seq_len))


@dataclass
class TokenStream:
    """Iterator facade used by the training driver."""

    global_batch: int
    seq_len: int
    vocab_size: int
    seed: int = 0
    step: int = 0

    def next(self):
        b = batch_at(self.step, global_batch=self.global_batch,
                     seq_len=self.seq_len, vocab_size=self.vocab_size,
                     seed=self.seed)
        self.step += 1
        return {"tokens": b}

    def restore(self, step: int):
        self.step = step
