"""Parameter and gradient trees: nested dicts, lists and tuples whose leaves
are tensors (or numpy arrays), the shape the JAX package's pytrees take.

``tree_leaves`` lists the leaves in order (dicts in their own key order,
lists and tuples by index); ``tree_map`` applies a function leaf by leaf
across trees of one structure; ``to_device`` moves a batch's arrays and
tensors to a device, leaving other leaves as they are.
"""

from __future__ import annotations

from typing import Any, Callable, List

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Every leaf of ``tree``, in order."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` applied to each leaf of ``tree`` and the leaves at the same
    place in ``rest``; a tree of the same structure. Dicts are matched by
    key, lists and tuples by index."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out) if isinstance(tree, tuple) else out
    return fn(tree, *rest)


def to_device(tree: Any, device: torch.device) -> Any:
    """A batch with every numpy array and tensor as a tensor on
    ``device`` (what the JAX package's jit does to a host batch)."""
    def move(leaf):
        if isinstance(leaf, (np.ndarray, torch.Tensor)):
            return torch.as_tensor(leaf, device=device)
        return leaf
    return tree_map(move, tree)
