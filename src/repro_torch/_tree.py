"""Pytrees of the training state, walked in the reference's leaf order.

JAX flattens a dict by its sorted keys and a tuple, list or ``NamedTuple``
by position; anything else is a leaf.  The optimizer's grad-clip norm sums
its leaves in that order and the checkpoint numbers its ``leaf_<i>`` arrays
by it, so the port walks its nested dicts of tensors the same way, and a
checkpoint directory of either package lines up leaf for leaf.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for child in tree for x in leaves(child)]
    return [tree]


def structure(tree):
    """The tree with every leaf replaced by ``None`` (the port's treedef:
    dicts, lists, tuples and NamedTuples as they are)."""
    if isinstance(tree, dict):
        return {k: structure(tree[k]) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(structure(c) for c in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(structure(c) for c in tree)
    return None


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves(tree), structure(tree))``."""
    return leaves(tree), structure(tree)


def unflatten(treedef, values) -> Any:
    """The tree of shape ``treedef`` (a :func:`structure`) with ``values``
    as its leaves, in order; raises ``ValueError`` on a count mismatch."""
    it = iter(values)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if _is_namedtuple(node):
            return type(node)(*(build(c) for c in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(c) for c in node)
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer values than the tree has leaves") from None

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    flat = leaves(tree)
    others = [leaves(t) for t in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("trees differ in their number of leaves")
    return unflatten(structure(tree),
                     [fn(*xs) for xs in zip(flat, *others)])
