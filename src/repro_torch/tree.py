"""Parameter trees: nested dicts / lists / tuples of tensors.

The port's stand-in for ``jax.tree``: ``tree_map`` rebuilds the structure
with ``fn`` applied leaf-wise across matching trees, ``tree_leaves`` flattens
in a fixed order (dict keys in insertion order). ``None`` is a leaf-less
subtree, as in jax.
"""
from __future__ import annotations

from typing import Any, Callable, List

PyTree = Any


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> List[Any]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [x for v in tree for x in tree_leaves(v)]
    if tree is None:
        return []
    return [tree]
