"""Parameter trees: nested dicts and lists of tensors.

The port keeps the JAX package's parameter pytrees as plain nested
containers. Leaves are visited in ``jax.tree.flatten`` order (dict keys
sorted, lists and tuples in order), so a flat row of the port and a flat
row of the reference hold the same values at the same offsets.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


# The walkers are module functions, not nested closures: a recursive
# closure refers to itself through its cell, and that cycle would keep
# the leaves (a step's bank-sized gradients) alive until Python's cyclic
# collector happens to run.

def _walk(t, leaves: List[Any]):
    if isinstance(t, dict):
        return {k: _walk(t[k], leaves) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_walk(v, leaves) for v in t)
    leaves.append(t)
    return None


def _build(t, it):
    if isinstance(t, dict):
        return {k: _build(v, it) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(_build(v, it) for v in t)
    return next(it)


def tree_flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``: leaves in sorted-key order; ``treedef`` is
    the tree with every leaf replaced by None."""
    leaves: List[Any] = []
    return leaves, _walk(tree, leaves)


def tree_unflatten(treedef, leaves):
    """Inverse of :func:`tree_flatten`."""
    return _build(treedef, iter(leaves))


def tree_leaves(tree) -> List[Any]:
    """Leaves of ``tree`` in flatten order."""
    return tree_flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` to every leaf, keeping the structure; with ``rest``
    (trees of the same structure) ``fn`` gets one leaf of each, as
    ``jax.tree.map``."""
    leaves, treedef = tree_flatten(tree)
    others = [tree_leaves(t) for t in rest]
    if any(len(o) != len(leaves) for o in others):
        raise ValueError("tree_map: trees of different structures")
    return tree_unflatten(treedef, [fn(*args) for args in
                                    zip(leaves, *others)])
