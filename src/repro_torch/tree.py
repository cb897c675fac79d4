"""Nested-container helpers in the JAX package's leaf order.

A tree is nested dicts, lists and tuples (NamedTuples included) with
tensors or arrays at the leaves.  :func:`flatten` lists the leaves as
``jax.tree.flatten`` does: dict entries by sorted key, sequences in
order.  The optimizer and the checkpoint files depend on that order: a
checkpoint written by either package names its leaves ``arr_<i>`` in
it.
"""

from __future__ import annotations


def flatten(tree):
    """``(leaves, spec)``: the leaves in order and the structure that
    :func:`unflatten` rebuilds from them."""
    leaves = []

    def walk(t):
        if isinstance(t, dict):
            return (dict, [(k, walk(t[k])) for k in sorted(t)])
        if isinstance(t, (list, tuple)):
            return (type(t), [walk(v) for v in t])
        leaves.append(t)
        return None

    return leaves, walk(tree)


def unflatten(spec, leaves):
    """The tree of ``spec`` with ``leaves`` in :func:`flatten`'s order."""
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, children = s
        if kind is dict:
            return {k: build(c) for k, c in children}
        vals = [build(c) for c in children]
        if hasattr(kind, "_fields"):              # a NamedTuple
            return kind(*vals)
        return kind(vals)

    out = build(spec)
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
