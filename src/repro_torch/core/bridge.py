"""Carry numpy data into tensors on the port's device.

The system has no weights; what crosses from the JAX package to the
port is fixture data.  :func:`from_numpy` takes the reference's inputs
as numpy (``np.asarray`` of a jax array) and makes tensors of the same
values and type on ``device``, so tests feed both packages the same
numbers.  numpy has no bfloat16 of its own: a bfloat16 array (the
``ml_dtypes`` type jax hands out) goes through float32, which holds
every bfloat16 value exactly.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def from_numpy(tree: Any, device: Any = "cpu") -> Any:
    """Every numpy array or scalar in nested tuples, lists and dicts →
    a tensor on ``device`` (a copy: it never aliases the numpy buffer);
    other leaves pass through unchanged."""
    if isinstance(tree, (np.ndarray, np.generic)):
        arr = np.asarray(tree)
        if arr.dtype.name == "bfloat16":
            return torch.from_numpy(arr.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(arr.copy()).to(device)
    if isinstance(tree, (tuple, list)):
        return type(tree)(from_numpy(node, device) for node in tree)
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return tree
