"""Tree helpers used across the port: nested dicts, lists and tuples of
tensors or arrays, named as the reference names its pytrees.

Counterpart of the reference's ``utils/tree.py``.  The traversal follows
JAX's: a dict's items in sorted key order, a list's or tuple's by index,
``None`` holds no leaf, anything else is a leaf, and a leaf's name is its
'/'-joined path.  The checkpoint fingerprint is built from these names.
An ``nn.Module`` is the dict of its ``state_dict`` (keys such as
``layers.0.attn.wq.w``), the same keys as the optimizer state's.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn


def children(node: Any):
    """``[(key, child)]`` of a tree node, or ``None`` for a leaf."""
    if isinstance(node, nn.Module):
        node = node.state_dict(keep_vars=True)
    if isinstance(node, dict):
        return sorted(node.items(), key=lambda kv: kv[0])
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if node is None:
        return []
    return None


def _flatten(tree: Any, prefix: tuple) -> list:
    kids = children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for key, sub in kids:
        out.extend(_flatten(sub, prefix + (str(key),)))
    return out


def tree_map_with_name(fn: Callable[[str, Any], Any], tree: Any) -> Any:
    """Map ``fn(name, leaf)`` over a tree, where name is the '/'-joined
    path.  Dicts, lists and tuples keep their type; a module maps to the
    dict of its state."""

    def walk(node, prefix):
        kids = children(node)
        if kids is None:
            return fn("/".join(prefix), node)
        if node is None:
            return None
        mapped = [(key, walk(sub, prefix + (str(key),))) for key, sub in kids]
        if isinstance(node, (list, tuple)):
            return type(node)(v for _, v in mapped)
        return dict(mapped)

    return walk(tree, ())


def flatten_names(tree: Any) -> list[tuple[str, Any]]:
    """Return [(name, leaf)] for every leaf in the tree."""
    return [("/".join(path), leaf) for path, leaf in _flatten(tree, ())]


def tree_size_bytes(tree: Any) -> int:
    """Total bytes across all array leaves (tensors and numpy arrays)."""
    total = 0
    for _, leaf in flatten_names(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
            total += int(np.prod(leaf.shape)) * np.dtype(leaf.dtype).itemsize
    return total


def tree_param_count(tree: Any) -> int:
    """Total number of scalar parameters across all array leaves."""
    total = 0
    for _, leaf in flatten_names(tree):
        if hasattr(leaf, "shape"):
            total += int(np.prod(tuple(leaf.shape)))
    return total
