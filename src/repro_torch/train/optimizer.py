"""AdamW, the warmup-cosine schedule and global-norm clipping on trees
of tensors.

The port of the JAX package's ``train/optimizer.py``.  The state's
layout mirrors optax's, ``{"m": tree, "v": tree, "count": int32
scalar}``, so a checkpoint written by either package restores in the
other.  The moments are float32 whatever the parameters' dtype; weight
decay is decoupled (AdamW) and applies only to tensors of two or more
dimensions; clipping runs before the update.

Everything stays on the parameters' device: ``lr``, the bias
corrections and the norm are tensors, and nothing is read back to the
host.  :func:`adamw_update` writes the parameters and the moments in
place (under ``torch.no_grad``), where the reference returns new
arrays: at llama3.2-1b's width a functional copy of parameters, ``m``
and ``v`` would be 14.8 GB a step.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.models import tree
from repro_torch.models.tracing import traced_source


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def warmup_cosine(cfg: AdamWConfig) -> Callable[[Any], torch.Tensor]:
    """``schedule(step)``: a linear warmup to ``cfg.lr`` over
    ``warmup_steps``, then a cosine to ``lr · min_lr_ratio`` at
    ``total_steps``, as a float32 tensor on the step's device."""
    def schedule(step) -> torch.Tensor:
        step = torch.as_tensor(step).float()
        warm = step / max(cfg.warmup_steps, 1)
        prog = (step - cfg.warmup_steps) / max(
            cfg.total_steps - cfg.warmup_steps, 1)
        prog = prog.clamp(0.0, 1.0)
        cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)
    return schedule


@traced_source
def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """``(grads · min(1, max_norm / norm), norm)``, the norm taken over
    every leaf in float32; a new tree in the leaves' dtypes."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in tree.flatten(grads)]))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree.map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_init(params) -> Dict[str, Any]:
    """Zero float32 moments beside every parameter and a zero int32
    ``count`` on the parameters' device."""
    device = tree.flatten(params)[0].device

    def zeros(t):
        return tree.map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                              device=p.device), t)
    return {"m": zeros(params), "v": zeros(params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
@traced_source
def adamw_update(cfg: AdamWConfig, grads, opt_state, params,
                 schedule: Optional[Callable] = None):
    """One AdamW step.  Returns ``(params, opt_state, lr)``: the
    parameters and moments given, written in place, and a new
    ``count`` (the old one + 1, from which ``lr`` and the bias
    corrections are computed)."""
    count = opt_state["count"] + 1
    lr = (schedule or warmup_cosine(cfg))(count)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** count.float()
    bc2 = 1 - b2 ** count.float()

    def upd(g, m, v, p):
        gf = g.float()
        m.copy_(b1 * m + (1 - b1) * gf)
        v.copy_(b2 * v + (1 - b2) * gf.square())
        step = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        if p.ndim >= 2:                   # no decay on norms/biases/scalars
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)

    tree.map(upd, grads, opt_state["m"], opt_state["v"], params)
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "count": count}, lr
