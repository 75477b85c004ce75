"""Nested dicts / lists / tuples of tensors ("trees"), flattened with
dict keys in sorted order — jax.tree's order, so a spooled blob's leaves
line up with the JAX package's flattening of the same tree."""
from __future__ import annotations

from typing import Any, List, Tuple


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """(leaves, treedef) with leaves in jax.tree order."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        kind, items = "dict", [tree[k] for k in keys]
    elif isinstance(tree, (list, tuple)):
        keys, kind, items = None, type(tree).__name__, list(tree)
    else:
        return [tree], None
    leaves, defs = [], []
    for item in items:
        ls, d = tree_flatten(item)
        leaves += ls
        defs.append(d)
    return leaves, (kind, keys, defs)


def tree_unflatten(treedef, leaves: List[Any]):
    return _build(treedef, iter(leaves))


def _build(d, it):
    # module-level, not a closure over `it`: a recursive closure refers
    # to itself, and that cycle would keep every leaf (a fetched stage's
    # activations) alive until the cyclic garbage collector ran
    if d is None:
        return next(it)
    kind, keys, defs = d
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in zip(keys, defs)}
    vals = [_build(sub, it) for sub in defs]
    return tuple(vals) if kind == "tuple" else vals


def tree_nbytes(tree) -> int:
    """Bytes of every tensor leaf of a tree."""
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])
