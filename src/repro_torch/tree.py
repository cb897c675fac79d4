"""Nested-container helpers in the JAX package's leaf order.

A tree is nested dicts, lists and tuples (NamedTuples included) with
tensors or arrays at the leaves.  :func:`flatten` lists the leaves as
``jax.tree.flatten`` does: dict entries by sorted key, sequences in
order.  The optimizer and the checkpoint files depend on that order: a
checkpoint written by either package names its leaves ``arr_<i>`` in
it.
"""

from __future__ import annotations


def _walk(t, out: list):
    if isinstance(t, dict):
        return (dict, [(k, _walk(t[k], out)) for k in sorted(t)])
    if isinstance(t, (list, tuple)):
        return (type(t), [_walk(v, out) for v in t])
    out.append(t)
    return None


def flatten(tree):
    """``(leaves, spec)``: the leaves in order and the structure that
    :func:`unflatten` rebuilds from them.  (Module-level recursion: a
    recursive closure would hold the leaves in a reference cycle, alive
    until the cyclic collector runs, which on the card is gigabytes of
    a training step's trees.)"""
    leaves: list = []
    spec = _walk(tree, leaves)
    return leaves, spec


def _build(s, it):
    if s is None:
        return next(it)
    kind, children = s
    if kind is dict:
        return {k: _build(c, it) for k, c in children}
    vals = [_build(c, it) for c in children]
    if hasattr(kind, "_fields"):                  # a NamedTuple
        return kind(*vals)
    return kind(vals)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)
    out = _build(spec, it)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``, trees of the same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
