"""Parameter-spec system: declare shapes and logical axes once, derive
materialized parameters from the same tree.

A model definition builds a nested dict (lists for the segments) of
``ParamSpec`` leaves.  ``init_params`` materializes it from a
``torch.Generator``, and ``abstract_params`` gives its meta-tensor
stand-ins, which the dry-run plans against.  ``params_from_arrays``
builds the model from the JAX package's parameter tree, and
``params_to_arrays`` gives a model's or a parameter tree's values back
as that tree, so tests can hold the two against each other on the same
weights both ways.  The logical axes are kept for the sharding half of
the reference's ``params.py``, which waits for the multi-card slice
(ROADMAP.md, L6b).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Optional[str], ...]   # logical axis name per dim (or None)
    init: str = "normal"              # normal | zeros | ones | arange_neg
    scale: float = 0.02
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def spec(shape, axes, init="normal", scale=0.02,
         dtype=torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def tree_map_specs(fn: Callable, tree):
    """Apply ``fn`` to every ParamSpec leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_specs(fn, v) for v in tree)
    return fn(tree)


def param_count(spec_tree) -> int:
    if isinstance(spec_tree, dict):
        return sum(param_count(v) for v in spec_tree.values())
    if isinstance(spec_tree, (list, tuple)):
        return sum(param_count(v) for v in spec_tree)
    return math.prod(spec_tree.shape)


def init_params(spec_tree, generator: torch.Generator,
                device: torch.device | str):
    """Materialize a spec tree into real fp32 parameters on ``device``:
    normal x ``scale``, zeros, ones, or ``arange_neg`` (mamba's ``A_log``:
    ``log(1 .. n)`` along the last axis).  ``generator`` lives on
    ``device``; its draws follow the tree's order."""

    def make(s: ParamSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "arange_neg":
            base = torch.log(torch.arange(1, s.shape[-1] + 1,
                                          dtype=torch.float32, device=device))
            return base.expand(s.shape).to(s.dtype).clone()
        if s.init != "normal":
            raise ValueError(f"unknown init {s.init!r}")
        return torch.randn(s.shape, generator=generator, dtype=torch.float32,
                           device=device).mul_(s.scale).to(s.dtype)

    return tree_map_specs(make, spec_tree)


def abstract_params(spec_tree):
    """The spec tree as meta tensors (shapes and dtypes, no storage), the
    role of the reference's ShapeDtypeStruct tree; no generator is
    involved and nothing is allocated."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree)


def params_from_arrays(cfg, tree):
    """The port's ``Transformer`` on the CPU holding the values of the JAX
    package's parameter tree ``tree`` (numpy arrays, the layers of a
    segment stacked on axis 0; ``{}`` for a shared-attention segment,
    whose block is ``tree["shared"]``)."""
    from repro_torch.models.model import Transformer

    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [convert(v) for v in t]
        return torch.from_numpy(np.array(t, dtype=np.float32))

    return Transformer(cfg, convert(tree))


def params_to_arrays(cfg, model):
    """The JAX package's parameter tree (float32 numpy arrays, the layers
    of a segment stacked on axis 0) holding the values of the
    ``Transformer`` ``model``, every family's blocks, its shared block
    and its encoder included: the inverse of :func:`params_from_arrays`."""

    def arr(t):
        return t.detach().float().cpu().numpy()

    def block(b):
        return {name: {k: arr(t) for k, t in sub.items()}
                for name, sub in b.named_children()}

    def stacked(blocks):
        if len(blocks) == 0:
            return {}
        return {name: {k: np.stack([arr(getattr(b, name)[k])
                                    for b in blocks]) for k in sub}
                for name, sub in blocks[0].named_children()}

    tree = {"embed": arr(model.embed),
            "final_norm": {k: arr(t) for k, t in model.final_norm.items()}}
    if hasattr(model, "lm_head"):
        tree["lm_head"] = arr(model.lm_head)
    tree["segments"] = [stacked(blocks) for blocks in model.segments]
    if hasattr(model, "shared"):
        tree["shared"] = block(model.shared)
    if hasattr(model, "encoder"):
        enc = model.encoder
        tree["encoder"] = {
            "segments": [stacked(blocks) for blocks in enc.segments],
            "final_norm": {k: arr(t) for k, t in enc.final_norm.items()}}
    return tree
