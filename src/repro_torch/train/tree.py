"""Trees of tensors: nested dicts (and lists or tuples) with tensor leaves.

The reference's ``jax.tree`` flattens a dict in sorted key order; these
helpers keep that order, so a sum over a tree's leaves (``global_norm``)
adds them as the reference does.
"""

from __future__ import annotations


def leaves(tree) -> list:
    """The leaves in the reference's order: dict keys sorted, lists and
    tuples in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def part(tree, i: int):
    """The ``i``-th of each tuple leaf of a dict tree (say, the parameter
    of each (parameter, m, v) an update returns)."""
    if isinstance(tree, dict):
        return {k: part(v, i) for k, v in tree.items()}
    return tree[i]


def map_tree(fn, tree, *rest):
    """``fn`` of each leaf (and the same leaf of each tree in ``rest``), in
    ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)
