"""Tree utilities over the port's containers. Counterpart of
boardlaw_tpu/utils/trees.py.

A tree is a tensor (a leaf), a dict, a list or tuple, or a dataclass such
as the worlds (`envs.hex.Hex`) or the search tree, nested; every helper
maps over the leaves, keeping the structure. Anything else (None, an int,
a device) is carried over as it is and is no leaf. Dicts are walked in
sorted key order, as `jax.tree.leaves` walks them.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass, replace

import torch


def map_tree(f, tree, *rest):
    """``f`` over the leaves of `tree` and the matching leaves of `rest`."""
    if torch.is_tensor(tree):
        return f(tree, *rest)
    if isinstance(tree, dict):
        return {k: map_tree(f, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [map_tree(f, x, *(r[i] for r in rest)) for i, x in enumerate(tree)]
        return type(tree)(out)
    if is_dataclass(tree) and not isinstance(tree, type):
        return replace(tree, **{fl.name: map_tree(f, getattr(tree, fl.name),
                                                  *(getattr(r, fl.name) for r in rest))
                                for fl in fields(tree) if fl.init})
    return tree


def leaves(tree):
    """The leaves of `tree`, dict keys sorted."""
    out = []

    def visit(x):
        if torch.is_tensor(x):
            out.append(x)
        elif isinstance(x, dict):
            for k in sorted(x):
                visit(x[k])
        elif isinstance(x, (list, tuple)):
            for y in x:
                visit(y)
        elif is_dataclass(x) and not isinstance(x, type):
            for fl in fields(x):
                visit(getattr(x, fl.name))

    visit(tree)
    return out


def stack(trees, axis=0):
    """Stack a list of identically-structured trees along a new axis."""
    return map_tree(lambda *xs: torch.stack(xs, axis), *trees)


def concat(trees, axis=0):
    """Concatenate a list of identically-structured trees along an axis."""
    return map_tree(lambda *xs: torch.cat(xs, axis), *trees)


def where(cond, a, b):
    """Leaf-wise ``torch.where`` with `cond` (a prefix of every leaf's
    shape, typically the env axis) expanded with trailing axes per leaf."""

    def _where(x, y):
        return torch.where(cond.reshape(cond.shape + (1,) * (x.ndim - cond.ndim)), x, y)

    return map_tree(_where, a, b)


def index(tree, idx):
    """Index every leaf with the same (leading-axis) index."""
    return map_tree(lambda x: x[idx], tree)


def leading_shape(tree, n=1):
    """The leading ``n`` axes of the first leaf."""
    return tuple(leaves(tree)[0].shape[:n])


def flatten_leading(tree, n=2):
    """Merge the first ``n`` axes of every leaf into one."""
    return map_tree(lambda x: x.reshape((-1,) + tuple(x.shape[n:])), tree)


def unflatten_leading(tree, shape):
    """Split the first axis of every leaf into ``shape``."""
    return map_tree(lambda x: x.reshape(tuple(shape) + tuple(x.shape[1:])), tree)
