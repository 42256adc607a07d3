"""The train step: loss → gradients → clip → AdamW.

The port of the JAX package's ``train/step.py``, on one device.  The
gradients come from ``torch.autograd.grad`` over the parameter leaves,
in the parameters' dtype (float32: the weights are float32 whatever
the config computes in).  Microbatches run one after another, their
gradients summed in a float32 accumulator and divided by their number,
as the reference's ``lax.scan`` does.

The step updates the state in place: ``params``, ``m`` and ``v`` are
written under ``torch.no_grad``, and the returned state holds those
same tensors with a new ``count`` and ``step``.  A state given to a
step belongs to that step; use the one it returns.  At llama3.2-1b's
width the state is 19.8 GB, and a functional copy of it every step
would cost as much.  The sharded gradient accumulator of the
reference's ``grad_specs`` needs a mesh, which the port does not have
yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models import tree
from repro_torch.models.api import ModelApi
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, warmup_cosine)

TrainState = Dict[str, Any]      # {"params", "opt": {m, v, count}, "step"}


def make_init_fn(api: ModelApi, opt_cfg: AdamWConfig
                 ) -> Callable[[torch.Generator], TrainState]:
    """``init_fn(gen)``: the model's weights from ``gen`` (on its
    device), zero moments and a zero int32 ``step``."""
    def init_fn(gen: torch.Generator) -> TrainState:
        params = api.init(gen)
        opt = adamw_init(params)
        return {"params": params, "opt": opt,
                "step": torch.zeros((), dtype=torch.int32,
                                    device=opt["count"].device)}
    return init_fn


def _split_microbatches(batch: Dict[str, Any], n: int) -> Dict[str, Any]:
    """[B, ...] → [n, B/n, ...] per leaf (M-RoPE positions [3,B,S] →
    [n, 3, B/n, S])."""
    def split(x):
        if x.ndim >= 3 and x.shape[0] == 3:          # M-RoPE positions
            return x.reshape(3, n, x.shape[1] // n,
                             *x.shape[2:]).transpose(0, 1)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def _grad_fn(api: ModelApi):
    """``(params, batch) → ((loss, metrics), grads)``: the reference's
    ``jax.value_and_grad(api.loss, has_aux=True)``.  The loss runs on
    aliases of the parameters that require grad, so the state's own
    tensors never do; a leaf the loss does not reach gets zeros."""
    def grad_fn(params, batch):
        alias = tree.map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = api.loss(alias, batch)
            grads = torch.autograd.grad(loss, tree.flatten(alias),
                                        allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree.unflatten(alias, grads)
    return grad_fn


def make_train_step(api: ModelApi, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, grad_specs=None):
    """``train_step(state, batch) → (state, metrics)``, ``metrics``
    holding ``loss``, ``grad_norm``, ``lr``, ``nll`` and ``aux`` as
    tensors on the device.  ``grad_specs`` (a sharding of the gradient
    accumulator) needs a mesh and must be None."""
    if grad_specs is not None:
        raise ValueError("grad_specs (a sharded gradient accumulator) is "
                         "not yet ported (#7)")
    schedule = warmup_cosine(opt_cfg)
    grad_fn = _grad_fn(api)

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state["params"]
        if num_microbatches > 1:
            micro = _split_microbatches(batch, num_microbatches)
            grads = tree.map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
            for i in range(num_microbatches):
                (l, _m), g = grad_fn(params, {k: v[i]
                                              for k, v in micro.items()})
                tree.map(lambda a, b: a.add_(b.float()), grads, g)
                loss = loss + l
            grads = tree.map(lambda g: g / num_microbatches, grads)
            loss = loss / num_microbatches
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        else:
            (loss, metrics), grads = grad_fn(params, batch)

        grads, gnorm = clip_by_global_norm(grads, opt_cfg.grad_clip)
        new_params, new_opt, lr = adamw_update(
            opt_cfg, grads, state["opt"], params, schedule)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        return new_state, {"loss": loss, "grad_norm": gnorm, "lr": lr,
                           **metrics}

    return train_step


def make_eval_step(api: ModelApi):
    """``eval_step(params, batch) → {"loss", "nll", "aux"}`` with grad
    off."""
    @torch.no_grad()
    def eval_step(params, batch):
        loss, metrics = api.loss(params, batch)
        return {"loss": loss, **metrics}
    return eval_step
