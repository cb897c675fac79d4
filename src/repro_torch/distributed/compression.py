"""Gradient compression: int8 quantization with error feedback.

Cross-pod data-parallel gradient all-reduces traverse the slow links
between pods; int8 with one float32 scale a leaf cuts that wire 4x
against float32.  Error feedback (Karimireddy et al.) keeps the
quantization residual locally and adds it back the next step, so the
transmitted signal tracks the true sum.

The JAX package's ``distributed/compression.py`` in torch, over
``repro_torch.tree``: ``torch.round`` rounds half to even as
``jnp.round`` does, the scale is ``max|y| / 127 + 1e-12`` in float32,
and the residual is ``y - q * scale`` with the product rounded once
before the difference, so ``q``, the scale and the residual are the
reference's bits.  Neither package wires it into a trainer:

    qgrads, scales, ef_state = compress_tree(grads, ef_state)
    # all-reduce qgrads across the pods, then
    grads = decompress_tree(qgrads, scales)
"""

from __future__ import annotations

import torch

from repro_torch import tree


def quantize_int8(x: torch.Tensor, resid: torch.Tensor):
    """``x + resid`` -> ``(int8 payload, float32 scale, new residual)``."""
    y = x.float() + resid
    # a divisor on the tensor's device: CUDA multiplies by the reciprocal
    # of a Python scalar, which is not always the quotient's bits
    scale = y.abs().max() / torch.full((), 127.0, device=y.device) + 1e-12
    q = torch.clamp(torch.round(y / scale), -127, 127).to(torch.int8)
    return q, scale, y - dequantize_int8(q, scale)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_ef_state(grads):
    """A float32 zero residual for every gradient leaf."""
    return tree.tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                               device=g.device), grads)


def compress_tree(grads, ef_state):
    """Quantize every leaf of ``grads`` with its residual in ``ef_state``
    (a tree of the same structure): ``(payloads, scales, residuals)``,
    three trees of that structure."""
    flat_g, spec = tree.flatten(grads)
    flat_e = tree.leaves(ef_state)
    if len(flat_e) != len(flat_g):
        raise ValueError(f"ef_state has {len(flat_e)} leaves for "
                         f"{len(flat_g)} gradients")
    out = [quantize_int8(g, e) for g, e in zip(flat_g, flat_e)]
    return tuple(tree.unflatten(spec, [o[i] for o in out])
                 for i in range(3))


def decompress_tree(qs, scales):
    return tree.tree_map(dequantize_int8, qs, scales)
