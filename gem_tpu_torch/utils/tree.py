"""Maps over the package's state trees: frozen dataclasses and dicts whose
leaves are tensors (None stays None), the counterpart of `jax.tree.map`."""

from __future__ import annotations

import dataclasses


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
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(tree_leaves(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: tree}
