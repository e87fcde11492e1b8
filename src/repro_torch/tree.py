"""Nested-dict parameter trees: the port's stand-in for `jax.tree`.

A tree is a dict (keys visited in sorted order, as jax does), a list or
tuple, or a leaf. Model state is such a tree of tensors, with the same
leaf paths as the JAX package's pytrees.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_leaves(tree) -> list:
    """Leaves in jax's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """`fn` applied leafwise over trees of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_unflatten(like, values: list) -> Any:
    """A tree shaped like `like` whose leaves are `values`, in the order
    `tree_leaves(like)` gives."""
    it = iter(values)
    out = _rebuild(like, it)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out


def _rebuild(node, it):
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, (list, tuple)):
        return type(node)(_rebuild(v, it) for v in node)
    return next(it)
