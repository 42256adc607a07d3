"""Carry a model's weights from the JAX package into the port.

JAX's and torch's random streams differ, so the two packages are held
to each other with one set of weights: the reference's parameter tree,
as numpy (``jax.tree_util.tree_map(np.asarray, params)``), becomes the
port's tree here.  The tree must have exactly the keys and shapes of the
one the port's own ``init`` makes: a renamed or transposed weight fails
loudly instead of computing something else.  A trainer's whole state
(weights, AdamW moments and counters) crosses with
:func:`train_state_from_numpy`.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.bridge import from_numpy

from . import tree
from .api import family_module
from .config import ModelConfig


def params_from_numpy(cfg: ModelConfig, params: Dict[str, Any],
                      device: Any = "cpu") -> Dict[str, Any]:
    """The reference's parameter tree of numpy arrays → the port's tree
    of tensors on ``device`` (bfloat16 arrives through float32, as
    :func:`repro_torch.core.bridge.from_numpy` carries it).  Raises
    ``ValueError`` on a missing or extra key or a shape that differs
    from the port's ``init(cfg, ...)``."""
    want = dict(tree.leaves(family_module(cfg).init(
        cfg, torch.Generator(), device="meta")))
    got = dict(tree.leaves(params))
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    if missing or extra:
        raise ValueError(f"{cfg.name}: parameter keys differ from the "
                         f"port's init: missing "
                         f"{['/'.join(k) for k in missing]}, extra "
                         f"{['/'.join(k) for k in extra]}")
    shapes = {"/".join(k): (tuple(got[k].shape), tuple(want[k].shape))
              for k in want if tuple(got[k].shape) != tuple(want[k].shape)}
    if shapes:
        raise ValueError(f"{cfg.name}: parameter shapes differ from the "
                         f"port's init (got, want): {shapes}")
    return from_numpy(params, device)


def train_state_from_numpy(cfg: ModelConfig, state: Dict[str, Any],
                           device: Any = "cpu") -> Dict[str, Any]:
    """The reference's ``TrainState`` as numpy (``{"params", "opt": {m,
    v, count}, "step"}``) → the port's on ``device``: the parameters
    through :func:`params_from_numpy` (keys and shapes checked), the
    moments, ``count`` and ``step`` through ``from_numpy``."""
    return {"params": params_from_numpy(cfg, state["params"], device),
            "opt": from_numpy(state["opt"], device),
            "step": from_numpy(state["step"], device)}
