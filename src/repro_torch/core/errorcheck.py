"""Error-checking utilities — the CUDA-error-check analogue (paper §III-E).

The torch port of ``repro.core.errorcheck``.  The failure modes worth
guarding uniformly are numerical (NaN/Inf escaping a step), shape, and
asynchronous device faults, which surface only at a synchronization
point — so :func:`sync` is where a kernel fault is reported.
"""
from __future__ import annotations

import functools
from typing import Any, Callable

import numpy as np
import torch

from .measure import cuda_devices, leaves


class ScopeError(RuntimeError):
    """Uniform error type raised by the check helpers."""


def check_finite(tree: Any, where: str = "") -> Any:
    """Raise ScopeError if any tensor or array leaf holds NaN/Inf."""
    for i, leaf in enumerate(leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and \
                not bool(torch.isfinite(leaf).all())
        else:
            arr = np.asarray(leaf)
            bad = arr.dtype.kind == "f" and not np.all(np.isfinite(arr))
        if bad:
            raise ScopeError(
                f"non-finite value in leaf {i}" + (f" at {where}" if where else "")
            )
    return tree


def check_shape(x: Any, expected: tuple, where: str = "") -> Any:
    if tuple(x.shape) != tuple(expected):
        raise ScopeError(
            f"shape mismatch{' at ' + where if where else ''}: "
            f"got {tuple(x.shape)}, want {tuple(expected)}"
        )
    return x


def sync(x: Any) -> Any:
    """Device synchronization — ``cudaDeviceSynchronize`` for every CUDA
    device a tensor of ``x`` lies on; a no-op for CPU tensors."""
    for device in cuda_devices(x):
        torch.cuda.synchronize(device)
    return x


def checked(fn: Callable) -> Callable:
    """Decorator: synchronize on outputs and run check_finite on them."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        return check_finite(sync(fn(*args, **kwargs)), where=fn.__name__)

    return wrapper
