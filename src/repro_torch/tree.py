"""Parameter trees: nested dicts, lists, tuples and NamedTuples of
tensors, walked as ``jax.tree_util`` walks the reference's trees.

Leaves come in the reference's order: dict keys sorted, lists and tuples
in order, NamedTuple fields in order; ``None`` holds no leaf.  A leaf's
path is written as ``jax.tree_util.keystr`` writes it (``['blocks']``,
``[0]``, ``.mu``), so a checkpoint manifest names leaves alike in both
packages.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key string, child) pairs of a container, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    if node is None:
        return []
    return None


def tree_flatten_with_path(tree) -> List[Tuple[str, Any]]:
    """[(path, leaf)] in the reference's leaf order."""
    out: List[Tuple[str, Any]] = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append((path, node))
            return
        for key, child in kids:
            walk(child, path + key)

    walk(tree, "")
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def tree_unflatten(template, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in leaf order,
    by ``leaves``; dicts keep the template's key order."""
    it: Iterator = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat = [tree_leaves(t) for t in rest]
    leaves = tree_leaves(tree)
    if any(len(f) != len(leaves) for f in flat):
        raise ValueError("trees differ in their number of leaves")
    return tree_unflatten(tree, [fn(*xs) for xs in zip(leaves, *flat)])
