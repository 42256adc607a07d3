"""Parameter trees: nested dicts (and tuples) of tensors.

The port's stand-in for the ``jax.tree_util`` calls of the reference's
models: layer stacks are made by stacking per-layer trees leaf by leaf
along a new leading axis, and a layer is read back as views into the
stack.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch


def stack(trees: List[Any]) -> Any:
    """Leaf-by-leaf ``torch.stack`` of trees of one structure (``{}``
    for an empty list, as the reference's superblocks hold)."""
    if not trees:
        return {}
    first = trees[0]
    if isinstance(first, dict):
        if any(not isinstance(t, dict) or t.keys() != first.keys()
               for t in trees):
            raise ValueError("stack: trees differ in structure")
        return {k: stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(stack([t[i] for t in trees]) for i in range(len(first)))
    return torch.stack(trees)


def index(tree: Any, i: int) -> Any:
    """Entry ``i`` of every leaf: one layer of a stack, as views."""
    if isinstance(tree, dict):
        return {k: index(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(index(v, i) for v in tree)
    return tree[i]


def map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (the reference's
    ``jax.tree_util.tree_map``)."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def leaves(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs of a tree of dicts, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree
