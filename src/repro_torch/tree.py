"""Parameter trees: nested dicts, lists, tuples, NamedTuples and
registered dataclasses of tensors, walked as ``jax.tree_util`` walks the
reference's trees.

Leaves come in the reference's order: dict keys sorted, lists and tuples
in order, NamedTuple fields in order, a registered dataclass's data
fields in field order; ``None`` holds no leaf.  A leaf's path is written
as ``jax.tree_util.keystr`` writes it (``['blocks']``, ``[0]``, ``.mu``,
``['lm_head'].packed``), so a checkpoint manifest names leaves alike in
both packages.  Only ``list`` and ``tuple`` themselves are containers: a
subclass of tuple that is not a NamedTuple is a leaf, as in JAX.

``register_dataclass`` is the reference's
``jax.tree_util.register_dataclass``: the quantized weights
(``core.quant.QTensor``, ``sail_linear.StackedQTensor``) are registered
with their tensors as data fields and their statics (``bits``,
``group_size``, ``k``, ``abits``) carried by the structure, so
``tree_unflatten`` rebuilds them with the template's statics.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Iterator, List, Tuple

# registered dataclass type -> its data fields, in field order
_DATACLASSES: Dict[type, Tuple[str, ...]] = {}


def register_dataclass(cls, data_fields):
    """Walk ``cls`` (a dataclass) as a node whose children are
    ``data_fields``; its other fields are statics.  Returns ``cls``."""
    _DATACLASSES[cls] = tuple(data_fields)
    return cls


def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _children(node):
    """(key string, child) pairs of a container, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if type(node) in _DATACLASSES:
        return [(f".{f}", getattr(node, f)) for f in _DATACLASSES[type(node)]]
    if type(node) in (list, tuple):
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
    by ``leaves``; dicts keep the template's key order, registered
    dataclasses the template's statics."""
    it: Iterator = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            vals = {k: build(node[k]) for k in sorted(node)}
            return {k: vals[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if type(node) in _DATACLASSES:
            return dataclasses.replace(node, **{
                f: build(getattr(node, f)) for f in _DATACLASSES[type(node)]})
        if type(node) in (list, tuple):
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
