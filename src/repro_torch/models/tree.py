"""Parameter trees: nested dicts (and tuples) of tensors.

The port's stand-in for the ``jax.tree_util`` calls of the reference's
models: layer stacks are made by stacking per-layer trees leaf by leaf
along a new leading axis, and a layer is read back as views into the
stack.  A forward that runs every layer takes them all at once with
:func:`unstack`, whose backward is one ``stack`` of the layers'
gradients; :func:`index` (``tensor[i]``), under autograd, writes a zero
tensor the size of the whole stack for every layer it reads.
"""
from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

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


def _depth(tree: Any) -> Optional[int]:
    """The leading size shared by every leaf (None: no leaves)."""
    if isinstance(tree, (dict, tuple)):
        nodes = tree.values() if isinstance(tree, dict) else tree
        depths = {d for d in (_depth(v) for v in nodes) if d is not None}
        if len(depths) > 1:
            raise ValueError(f"unstack: stacks of different depths {depths}")
        return depths.pop() if depths else None
    return tree.shape[0]


def unstack(tree: Any) -> List[Any]:
    """Every layer of a stack, as a list of trees of views: one
    ``torch.unbind`` a leaf.  An empty subtree (the empty stacks of a
    hybrid superblock) is empty in every layer; a tree with no leaves
    gives ``[]``."""
    n = _depth(tree)

    def split(node: Any) -> List[Any]:
        if isinstance(node, dict):
            parts = {k: split(v) for k, v in node.items()}
            return [{k: p[i] for k, p in parts.items()} for i in range(n)]
        if isinstance(node, tuple):
            parts = [split(v) for v in node]
            return [tuple(p[i] for p in parts) for i in range(n)]
        return list(torch.unbind(node, 0))
    return [] if n is None else split(tree)


def map(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of trees of one structure (the reference's
    ``jax.tree_util.tree_map``)."""
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(map(fn, v, *(r[i] for r in rest))
                     for i, v in enumerate(tree))
    return fn(tree, *rest)


def flatten(tree: Any) -> List[Any]:
    """The leaves of a tree, in :func:`map`'s order."""
    out: List[Any] = []
    map(out.append, tree)
    return out


def unflatten(like: Any, values: Iterable[Any]) -> Any:
    """``like``'s structure with its leaves replaced, in :func:`map`'s
    order, by ``values``."""
    it = iter(values)
    return map(lambda _: next(it), like)


def leaves(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) pairs of a tree of dicts, in key order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree
