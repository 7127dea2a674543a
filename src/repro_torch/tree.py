"""Nested dicts and lists of tensors, the port's stand-in for the
reference's pytrees.

The model's parameters, the optimizer state and a checkpoint's tree are
nested ``dict``s (and, for the GNN and NequIP layers, ``list``s) whose
leaves are tensors (or, for the train step counter, a host int).  Leaves
are visited in sorted key order and in list order, as ``jax.tree_util``
flattens a dict and a list, and a leaf's path is its keys (list positions)
joined by ``/``, as the reference's checkpoint keys are.  A tuple is a
leaf.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``: the structure is ``tree``'s, so a leaf of ``tree`` receives
    whatever ``rest`` holds there (a leaf, or a whole subtree)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_items(tree, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_items(tree[k], prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from tree_items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def tree_leaves(tree) -> List[Any]:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(tree, leaves):
    """``tree``'s structure with ``leaves`` (in ``tree_leaves`` order) in
    place of its leaves."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, list):
            return [build(v) for v in t]
        return next(it)

    out = build(tree)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out


__all__ = ["tree_map", "tree_items", "tree_leaves", "tree_unflatten"]
