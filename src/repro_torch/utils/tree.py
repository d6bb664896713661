"""Pytree vector-space utilities.

Every tree-path state (LEAD's X, H, H_w, D; a baseline's iterates and
public copies) is a pytree with the structure of the parameters.  These
helpers implement the small linear algebra the algorithms need, and the
flat-vector packing of ``ravel_pytree``, over the port's own pytrees:

    leaves   tensors (anything that is not a container below)
    nodes    tuples, lists, dicts (keys in sorted order, as the reference
             flattens them), NamedTuples (fields in order); None is an
             empty subtree

It is the port's own copy of ``src/repro/utils/tree.py``; torch's
``torch.utils._pytree`` is private and is not used.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, List, Tuple

import torch

Pytree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, leaves: List) -> Any:
    """Append tree's leaves to `leaves`; return its structure."""
    if tree is None:
        return ("none",)
    if _is_namedtuple(tree):
        return ("namedtuple", type(tree),
                tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, type(tree),
                tuple(_flatten(c, leaves) for c in tree))
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return ("dict", keys, tuple(_flatten(tree[k], leaves) for k in keys))
    leaves.append(tree)
    return ("leaf",)


def tree_flatten(tree: Pytree) -> Tuple[list, Any]:
    """(leaves in order, treedef)."""
    leaves: list = []
    return leaves, _flatten(tree, leaves)


def tree_unflatten(treedef, leaves) -> Pytree:
    """Rebuild the pytree of `treedef` from `leaves` (in flatten order)."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        children = [build(c) for c in node[2]]
        if kind == "namedtuple":
            return node[1](*children)
        if kind == "dict":
            return dict(zip(node[1], children))
        return node[1](children)

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree structure holds")
    return out


def tree_leaves(tree: Pytree) -> list:
    return tree_flatten(tree)[0]


def tree_map(f: Callable, tree: Pytree, *rest: Pytree) -> Pytree:
    """f applied leaf-wise; every tree in `rest` has `tree`'s structure."""
    leaves, treedef = tree_flatten(tree)
    others = []
    for r in rest:
        r_leaves, r_def = tree_flatten(r)
        if r_def != treedef:
            raise ValueError("tree_map: the trees differ in structure")
        others.append(r_leaves)
    return tree_unflatten(treedef, [f(*xs) for xs in zip(leaves, *others)])


def tree_add(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.add, a, b)


def tree_sub(a: Pytree, b: Pytree) -> Pytree:
    return tree_map(torch.subtract, a, b)


def tree_scale(s, a: Pytree) -> Pytree:
    return tree_map(lambda x: s * x, a)


def tree_axpy(s, a: Pytree, b: Pytree) -> Pytree:
    """s * a + b."""
    return tree_map(lambda x, y: s * x + y, a, b)


def tree_lerp(alpha, a: Pytree, b: Pytree) -> Pytree:
    """(1 - alpha) * a + alpha * b."""
    return tree_map(lambda x, y: (1.0 - alpha) * x + alpha * y, a, b)


def tree_dot(a: Pytree, b: Pytree) -> torch.Tensor:
    """Sum over leaves of <a_leaf, b_leaf>, a 0-d tensor."""
    dots = tree_leaves(tree_map(
        lambda x, y: torch.sum(x.reshape(-1) * y.reshape(-1)), a, b))
    return functools.reduce(torch.add, dots)


def tree_sq_norm(a: Pytree) -> torch.Tensor:
    return tree_dot(a, a)


def tree_norm(a: Pytree) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def tree_zeros_like(a: Pytree) -> Pytree:
    return tree_map(torch.zeros_like, a)


def tree_ones_like(a: Pytree) -> Pytree:
    return tree_map(torch.ones_like, a)


def tree_cast(a: Pytree, dtype) -> Pytree:
    return tree_map(lambda x: x.to(dtype), a)


def tree_random_like(generator: torch.Generator, a: Pytree,
                     scale=1.0) -> Pytree:
    """Standard normal leaves like `a`'s, times `scale`, from `generator`
    (a torch.Generator on the leaves' device)."""
    return tree_map(lambda x: scale * torch.randn(
        x.shape, generator=generator, dtype=x.dtype, device=x.device), a)


def tree_size(a: Pytree) -> int:
    return sum(int(x.numel()) for x in tree_leaves(a))


def tree_bytes(a: Pytree) -> int:
    return sum(int(x.numel()) * x.element_size() for x in tree_leaves(a))


def ravel_pytree(tree: Pytree):
    """Flatten a pytree into one 1-D f32 vector.

    Returns (vector, unravel_fn).  The leaf order is tree_flatten's, and
    unravel restores every leaf's shape and dtype."""
    leaves, treedef = tree_flatten(tree)
    shapes = [x.shape for x in leaves]
    dtypes = [x.dtype for x in leaves]
    sizes = [int(x.numel()) for x in leaves]
    flat = (torch.cat([x.reshape(-1).to(torch.float32) for x in leaves])
            if leaves else torch.zeros((0,), dtype=torch.float32))

    def unravel(vec):
        out, off = [], 0
        for shp, dt, sz in zip(shapes, dtypes, sizes):
            out.append(vec[off:off + sz].reshape(shp).to(dt))
            off += sz
        return tree_unflatten(treedef, out)

    return flat, unravel
