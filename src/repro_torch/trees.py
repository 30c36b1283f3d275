"""Nested containers of tensors: the port's stand-in for
``jax.tree_util``.

A tree is a tensor, or a dict, list or tuple of trees. Params are flat
dicts; an algorithm's client state, server context and message are dicts,
tuples (``()`` when empty) or single tensors. ``leaves`` walks a dict by
sorted key, the reference's leaf order; ``tree_map`` keeps the first
tree's structure and key order.
"""
from __future__ import annotations

import torch


def leaves(tree) -> list:
    """The tree's tensors in the reference's order (dicts by sorted key)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest])
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest])
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def stack(trees) -> object:
    """Trees of one structure stacked leaf by leaf on a new leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *trees)


def index(tree, i):
    """Row ``i`` of every leaf (a view)."""
    return tree_map(lambda x: x[i], tree)


def nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in leaves(tree))
