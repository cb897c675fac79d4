"""FLOP and byte counter over the torch ops a call issues.

The JAX package walks a jaxpr (``count_fn`` over ``make_jaxpr``), since
XLA's ``cost_analysis`` counts a ``while`` body once.  The port has no
jaxpr: :func:`count_fn` runs the call under a ``TorchDispatchMode`` and
counts every aten op that reaches the dispatcher, so every round of a
Python loop (a ``static_iters`` run) is counted as it runs.  The module
keeps the reference's path, its ``Cost`` fields and ``count_fn(fn,
*args)``.  What it counts:

  * matmul FLOPs: 2·M·N·K for ``mm``/``addmm`` and 2·B·M·N·K for
    ``bmm``/``baddbmm`` (einsum reaches these), 2·M·K for ``mv``;
  * elementwise FLOPs: the element count of each output of a pointwise
    op or a reduction (a second-order figure, reported apart);
  * unfused bytes: inputs plus outputs of every op that is not a view,
    data movement included (an upper bound on memory traffic that
    ignores fusion and caches);
  * ``peak_live_bytes`` (port only): the most bytes the tensors the call
    allocated held at once, freed when the last tensor over a storage
    dies (weakref finalisers), the figure behind a plan's temp bytes.

Views (``view``, ``slice``, ``permute``, ``expand`` ...) cost nothing.
On ``device="meta"`` tensors nothing is allocated or computed, so a
paper-scale program is counted on a host with no card.  A host read of
a meta tensor (``.item()``, ``int()``, ``bool()``) has no value: under
the counter it reads 0 (``False``, ``0.0``), which a ``static_iters``
run's halt never reads; a branch on it takes its zero side (bfs/fast
pushes every level, the costlier direction).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_MATMUL = {aten.mm.default, aten.bmm.default, aten.addmm.default,
           aten.baddbmm.default, aten.mv.default, aten.dot.default}
_REDUCTIONS = {"sum", "mean", "prod", "amax", "amin", "max", "min",
               "argmax", "argmin", "any", "all", "cumsum", "cumprod",
               "logsumexp", "var", "std", "norm", "linalg_vector_norm",
               "scatter_add", "scatter_reduce", "index_add", "index_reduce",
               "_softmax", "_log_softmax"}


@dataclass
class Cost:
    matmul_flops: float = 0.0
    elementwise_flops: float = 0.0
    bytes_touched: float = 0.0
    peak_live_bytes: float = 0.0

    @property
    def total_flops(self) -> float:
        return self.matmul_flops + self.elementwise_flops


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _matmul_flops(func, args) -> float:
    if func in (aten.mm.default, aten.addmm.default):
        a, b = (args[0], args[1]) if func is aten.mm.default else args[1:3]
        return 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
    if func in (aten.bmm.default, aten.baddbmm.default):
        a, b = (args[0], args[1]) if func is aten.bmm.default else args[1:3]
        return 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if func is aten.mv.default:
        return 2.0 * args[0].shape[0] * args[0].shape[1]
    return 2.0 * args[0].numel()                        # dot


def _zero(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return 0.0 if dtype.is_floating_point else 0


class CostCounter(TorchDispatchMode):
    """Counts the ops run under it into :attr:`cost` (see the module
    docstring); :attr:`live_bytes` and ``cost.peak_live_bytes`` track the
    storages the counted ops allocated."""

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self._refs: dict[int, list] = {}     # storage -> [tensors, bytes]

    def _release(self, key: int) -> None:
        ent = self._refs.get(key)
        if ent is None:
            return
        ent[0] -= 1
        if ent[0] == 0:
            self.live_bytes -= ent[1]
            del self._refs[key]

    def _track(self, t: torch.Tensor, fresh: bool) -> None:
        key = t.untyped_storage()._cdata
        ent = self._refs.get(key)
        if ent is None:
            if not fresh:
                return                        # a view of an untracked input
            ent = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live_bytes += ent[1]
            self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                            self.live_bytes)
        ent[0] += 1
        weakref.finalize(t, self._release, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is aten._local_scalar_dense.default and args[0].is_meta:
            return _zero(args[0].dtype)
        out = func(*args, **kwargs)
        schema = func._schema
        mutates = schema.is_mutable
        view = not mutates and any(r.alias_info is not None
                                   for r in schema.returns)
        outs = list(_tensors(out))
        if view:
            for t in outs:
                self._track(t, fresh=False)
            return out
        ins = list(_tensors(args)) + list(_tensors(kwargs))
        c = self.cost
        c.bytes_touched += sum(_nbytes(t) for t in ins) \
            + sum(_nbytes(t) for t in outs)
        if func in _MATMUL:
            c.matmul_flops += _matmul_flops(func, args)
        elif torch.Tag.pointwise in func.tags \
                or func.name().split("::")[-1].split(".")[0].rstrip("_") \
                in _REDUCTIONS:
            c.elementwise_flops += sum(t.numel() for t in outs)
        in_keys = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            self._track(t, fresh=t.untyped_storage()._cdata not in in_keys)
        return out


def count_fn(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and
    return what it counted."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.cost


__all__ = ["Cost", "CostCounter", "count_fn"]
