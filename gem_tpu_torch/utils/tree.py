"""Maps over the package's state trees: frozen dataclasses, dicts and
tuples whose leaves are tensors (None stays None), the counterpart of
`jax.tree.map`."""

from __future__ import annotations

import dataclasses
import math

import torch


def tree_map(fn, tree, *rest):
    """fn(leaf, *leaves of `rest` at the same place) over `tree`."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(tree_map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} in field order (None leaves left out)."""
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(tree_leaves(getattr(tree, f.name),
                                   f"{prefix}{f.name}/"))
        return out
    if isinstance(tree, (dict, tuple)):
        out = {}
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        for k, v in items:
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}


def lead(pred, x):
    """`pred` with trailing unit dims, so that it broadcasts against `x`
    along `x`'s leading dims (a (R,) robot predicate over (R, ...) leaves;
    a () predicate is unchanged in effect)."""
    return pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))


def flat_rows(idx, n: int):
    """`idx` (..., k), rows of each leading index's n rows, as rows of all
    of them flattened (leading index b's start at n * b); unchanged for
    one leading index (or none)."""
    rows = idx.shape[:-1]
    if math.prod(rows) == 1:
        return idx
    return idx + n * torch.arange(math.prod(rows), device=idx.device
                                  ).reshape(rows + (1,))


def tree_select(pred, a, b):
    """`torch.where(pred, a, b)` leaf by leaf over two trees of one
    structure: the select that stands for `lax.cond` on a device scalar.
    `pred` is () or carries the trees' leading robot axis, (R,), and is
    broadcast over each leaf's trailing dims (the select that JAX's cond
    becomes under `vmap`).  A leaf that is the same tensor in both trees
    is kept, not copied."""
    return tree_map(lambda x, y: x if x is y
                    else torch.where(lead(pred, x), x, y), a, b)
