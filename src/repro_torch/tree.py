"""Param trees: nested dicts and lists of tensors, the reference's pytrees.

Leaves come in ``jax.tree.leaves`` order (dict keys sorted, lists by
index), so a sum over the leaves of a tree adds them in the reference's
order, and a flat list of leaves maps back onto its tree.
"""
from __future__ import annotations

from typing import Callable, List, Mapping, Sequence


def tree_map(fn: Callable, tree):
    """``fn`` applied to every leaf of nested dicts and lists."""
    if isinstance(tree, Mapping):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def tree_leaves(tree) -> List:
    """Every leaf, dict keys sorted, lists in order."""
    if isinstance(tree, Mapping):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(tree, leaves: Sequence):
    """``leaves`` (in ``tree_leaves`` order) put back into ``tree``'s
    structure: the inverse of ``tree_leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [build(v) for v in node]
        return next(it)

    out = build(tree)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the tree has")
    return out


def tree_map_with_path(fn: Callable, tree, path: tuple = ()):
    """``fn(path, leaf)`` applied to every leaf, ``path`` the tuple of
    dict keys and list indices leading to it (``jax.tree_util.
    tree_map_with_path``'s key path)."""
    if isinstance(tree, Mapping):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map_with_path(fn, v, path + (i,))
                for i, v in enumerate(tree)]
    return fn(path, tree)
