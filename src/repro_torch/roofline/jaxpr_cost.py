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
  * ``peak_live_bytes`` (port only): the most bytes the storages the
    call allocated held at once, each counted until the storage itself
    is freed (a weakref finaliser on its Python object, which lives as
    long as the storage does), so a tensor that autograd saved for the
    backward, or that ``torch.utils.checkpoint`` holds for its
    recompute, stays counted until the backward frees it: the figure
    behind a plan's temp bytes.

Under autograd the dispatcher sees the backward's ops too (the engine
runs them with the caller's dispatch modes), and under
``torch.utils.checkpoint`` the recompute's, so a training step's count
holds its forward, its remat recompute and its backward.
Views (``view``, ``slice``, ``permute``, ``expand`` ...) cost nothing.
On ``device="meta"`` tensors nothing is allocated or computed, so a
paper-scale program is counted on a host with no card.

On DTensors (a sharded step planned over a fake process group) the
counter lets DTensor turn each op into the local ops of one rank first,
and counts those at their local shapes (not the global-shape op that
DTensor's sharding propagation runs on fake tensors the first time it
meets an op); the collectives DTensor issues
(``_c10d_functional`` all-gather, reduce-scatter, all-reduce and
all-to-all) are tallied in ``Cost.collectives`` by op and group size,
with the bytes one rank sends into each and the calls, and each
all-gather's input shape in ``Cost.gathered``.  A host read of
a meta tensor (``.item()``, ``int()``, ``bool()``) has no value: under
the counter it reads 0 (``False``, ``0.0``), which a ``static_iters``
run's halt never reads; a branch on it takes its zero side (bfs/fast
pushes every level, the costlier direction).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass, field

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
    # (op, group size) -> [input bytes of one rank, calls]
    collectives: dict = field(default_factory=dict)
    # (shape, dtype) of each all-gather's input (one rank's shard) ->
    # calls: what was gathered, e.g. that no MoE expert weight was
    gathered: dict = field(default_factory=dict)

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
        self._live: set[int] = set()          # storages counted as live
        # a call signature on meta tensors -> its outputs' metadata and
        # counts: meta kernels cost tens of microseconds of Python each,
        # and a planning run repeats the same calls (layers, chunks), so
        # a repeat builds empty meta outputs and adds the same counts
        self._outs: dict = {}

    def _release(self, key: int, nbytes: int) -> None:
        self._live.discard(key)
        self.live_bytes -= nbytes

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        self._live.add(key)
        self.live_bytes += st.nbytes()
        self.cost.peak_live_bytes = max(self.cost.peak_live_bytes,
                                        self.live_bytes)
        weakref.finalize(st, self._release, key, st.nbytes())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_dtensor(types):
            return NotImplemented       # DTensor desugars to local ops first
        kwargs = kwargs or {}
        if _fake(args):
            # DTensor's sharding propagation infers an op's global output
            # on fake tensors (once a distinct op): no rank runs it
            return func(*args, **kwargs)
        if func is aten._local_scalar_dense.default and args[0].is_meta:
            return _zero(args[0].dtype)
        op = _collective(func)
        if op == "wait_tensor":
            return func(*args, **kwargs)
        if op is not None:
            key = (op, _group_size(op, args))
            tally = self.cost.collectives.setdefault(key, [0, 0])
            tally[0] += _nbytes(args[0])
            tally[1] += 1
            if op == "all_gather_into_tensor":
                g = (tuple(args[0].shape), str(args[0].dtype))
                self.cost.gathered[g] = self.cost.gathered.get(g, 0) + 1
            out = func(*args, **kwargs)
            for t in _tensors(out):
                self._track(t)
            return out
        view, kind = _func_info(func)
        if view:
            return func(*args, **kwargs)
        key = _meta_key(func, args, kwargs)
        hit = self._outs.get(key) if key is not None else None
        if hit is not None:
            metas, single, d_mm, d_ew, d_bytes = hit
            outs = [torch.empty_strided(shape, stride, dtype=dtype,
                                        device="meta")
                    for shape, stride, dtype in metas]
            out = outs[0] if single else tuple(outs)
        else:
            out = func(*args, **kwargs)
            ins = list(_tensors(args)) + list(_tensors(kwargs))
            outs = list(_tensors(out))
            d_bytes = sum(_nbytes(t) for t in ins) \
                + sum(_nbytes(t) for t in outs)
            d_mm = _matmul_flops(func, args) if kind == "mm" else 0.0
            d_ew = sum(t.numel() for t in outs) if kind == "ew" else 0.0
            in_keys = {t.untyped_storage()._cdata for t in ins}
            outs = [t for t in outs
                    if t.untyped_storage()._cdata not in in_keys]
            if key is not None and _cacheable(out, outs):
                self._outs[key] = (
                    [(tuple(t.shape), t.stride(), t.dtype) for t in outs],
                    isinstance(out, torch.Tensor), d_mm, d_ew, d_bytes)
        c = self.cost
        c.bytes_touched += d_bytes
        c.matmul_flops += d_mm
        c.elementwise_flops += d_ew
        for t in outs:
            self._track(t)
        return out


_FUNC_INFO: dict = {}

# DTensor's collectives (``_c10d_functional``), and where each takes its
# process group's name
_COLLECTIVES = {"all_gather_into_tensor": 2, "reduce_scatter_tensor": 3,
                "all_reduce": 2, "all_to_all_single": 3}


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _fake(args) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in _tensors(args))


def _collective(func) -> str | None:
    """A functional collective's name (``wait_tensor`` included), else
    None."""
    ns, _, name = func.name().partition("::")
    if ns == "_c10d_functional" and (name in _COLLECTIVES
                                     or name == "wait_tensor"):
        return name
    return None


def _group_size(op: str, args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(args[_COLLECTIVES[op]]).size()


def _func_info(func) -> tuple[bool, str | None]:
    """(is a view op, "mm" / "ew" / None: what its FLOPs count as)."""
    info = _FUNC_INFO.get(func)
    if info is None:
        schema = func._schema
        view = not schema.is_mutable and any(r.alias_info is not None
                                             for r in schema.returns)
        if func in _MATMUL:
            kind = "mm"
        elif torch.Tag.pointwise in func.tags \
                or func.name().split("::")[-1].split(".")[0].rstrip("_") \
                in _REDUCTIONS:
            kind = "ew"
        else:
            kind = None
        info = _FUNC_INFO[func] = (view, kind)
    return info


_ATOMS = (bool, int, float, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _sig(x):
    if isinstance(x, torch.Tensor):
        if not x.is_meta:
            raise TypeError
        return ("T", tuple(x.shape), x.stride(), x.dtype)
    if isinstance(x, (list, tuple)):
        return tuple(_sig(v) for v in x)
    if isinstance(x, _ATOMS):
        return (type(x).__name__, x)
    raise TypeError


def _meta_key(func, args, kwargs):
    """The signature of a call on meta tensors (shapes, strides, dtypes and
    the other arguments), or None when an argument is of another kind
    (a tensor elsewhere than on meta, say)."""
    try:
        return (func, _sig(args), _sig(tuple(sorted(kwargs.items()))))
    except TypeError:
        return None


def _cacheable(out, fresh) -> bool:
    """A functional op's result that depends on its arguments' metadata
    alone: a meta tensor or a tuple of them, none aliasing an input."""
    outs = [out] if isinstance(out, torch.Tensor) else out
    return (isinstance(outs, (list, tuple)) and len(fresh) == len(outs)
            and all(isinstance(t, torch.Tensor) and t.is_meta
                    for t in outs))


def count_fn(fn, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostCounter` and
    return what it counted."""
    counter = CostCounter()
    with counter:
        fn(*args, **kwargs)
    return counter.cost


__all__ = ["Cost", "CostCounter", "count_fn"]
