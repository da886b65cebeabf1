"""Nested containers of tensors in JAX's pytree order.

The reference keeps parameters, optimizer moments and checkpoints as
pytrees, and ``jax.tree_util.tree_flatten`` orders their leaves with dict
keys SORTED and lists and tuples in order.  The port keeps the same nested
dicts and lists and walks them in that same order, so the i-th leaf here is
the reference's i-th leaf: an optimizer update pairs the same tensors, and
a checkpoint's ``leaf_<i>.npy`` restores in either package (``opt`` before
``params``, and ``m``, ``step``, ``v`` inside ``opt``).  Anything that is
not a dict, list or tuple is a leaf.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def unflatten(like, flat) -> object:
    """A tree shaped as ``like`` whose leaves are ``flat``, in `leaves`
    order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}           # keep like's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def map_leaves(fn, tree):
    """``tree`` with ``fn`` applied to every leaf."""
    return unflatten(tree, [fn(x) for x in leaves(tree)])


def structure(tree) -> str:
    """A printable description of ``tree``'s nesting (leaves as ``*``), for
    a checkpoint manifest."""
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (list, tuple)):
        return "[" + ", ".join(structure(v) for v in tree) + "]"
    return "*"
