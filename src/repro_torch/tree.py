"""Nested-dict parameter trees: the port's counterpart of the few
``jax.tree`` operations the training path uses. A tree is a dict whose
values are trees or leaves (tensors, or axes tuples in an axes tree);
keys are visited in sorted order, as ``jax.tree`` flattens dicts."""
from __future__ import annotations

from typing import Any, Callable, Dict, List


def tree_map(fn: Callable, tree: Dict, *rest: Dict) -> Dict:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the same
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]
