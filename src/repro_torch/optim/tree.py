"""Trees of tensors (nested dicts, lists, tuples and named tuples), as the
reference's pytrees: flatten, unflatten, map, and leaf paths.

Dict keys are visited in sorted order, as the reference's tree utilities
visit them, so leaves come in the reference's order.  ``None`` is an empty
node, not a leaf.  A leaf's path joins the dict keys and sequence indices on the way
to it with ``/`` (``0/layers/0/w``), a named tuple's fields as ``.name``:
the names the reference's checkpoints key their arrays by.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "flatten_with_paths", "unflatten", "leaves", "tree_map"]

_LEAF = object()


def _flatten(tree, path: Tuple[str, ...], out: list):
    if tree is None:
        return (None, None, ())
    if isinstance(tree, dict):
        keys = sorted(tree)
        return (dict, keys, tuple(_flatten(tree[k], path + (str(k),), out) for k in keys))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return (type(tree), None, tuple(_flatten(getattr(tree, f), path + (f".{f}",), out)
                                        for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return (type(tree), None, tuple(_flatten(t, path + (str(i),), out)
                                        for i, t in enumerate(tree)))
    out.append(("/".join(path), tree))
    return _LEAF


def flatten_with_paths(tree) -> Tuple[List[Tuple[str, Any]], Any]:
    """([(path, leaf), ...], spec) in the reference's leaf order."""
    out: list = []
    spec = _flatten(tree, (), out)
    return out, spec


def flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, spec); ``unflatten(spec, leaves)`` rebuilds the tree."""
    pairs, spec = flatten_with_paths(tree)
    return [leaf for _, leaf in pairs], spec


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def unflatten(spec, flat: List[Any]):
    it = iter(flat)

    def build(node):
        if node is _LEAF:
            return next(it)
        kind, keys, children = node
        if kind is None:
            return None
        built = [build(c) for c in children]
        if kind is dict:
            return dict(zip(keys, built))
        if hasattr(kind, "_fields"):
            return kind(*built)
        return kind(built)

    tree = build(spec)
    if next(it, _LEAF) is not _LEAF:
        raise ValueError("unflatten: more leaves than the tree holds")
    return tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    if any(len(o) != len(flat) for o in others):
        raise ValueError("tree_map: trees of different structure")
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
