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
would cost as much.

The same step runs on ``DTensor`` state (the dry-run traces it for one
rank of a mesh): every gradient is redistributed out of the partial
sums autograd leaves it in — to the parameter's own placements, or
with ``grad_specs`` (the reference's sharded accumulator) to the spec's
placements, ZeRO's, before it is added to the sum, so each
microbatch's data-parallel reduction is a reduce-scatter.  A batch in
DTensors splits into microbatches on each rank's rows.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.distributed.logical import is_dtensor
from repro_torch.models import tree
from repro_torch.models.api import ModelApi
from repro_torch.models.tracing import repeated, traced_source
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
    [n, 3, B/n, S]).  A ``DTensor`` leaf splits each rank's own rows:
    its microbatch i holds the i-th n-th of every rank's rows."""
    def split(x):
        if x.ndim >= 3 and x.shape[0] == 3:          # M-RoPE positions
            return x.reshape(3, n, x.shape[1] // n,
                             *x.shape[2:]).transpose(0, 1)
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])

    def split_local(x):
        from torch.distributed.tensor import DTensor, Shard
        pl = [Shard(p.dim + 1) if p.is_shard() else p for p in x.placements]
        return DTensor.from_local(split(x.to_local()), x.device_mesh, pl,
                                  run_check=False)
    return {k: split_local(v) if is_dtensor(v) else split(v)
            for k, v in batch.items()}


def _placed(grads, like):
    """Each ``DTensor`` gradient redistributed to the placements of the
    matching leaf of ``like`` (a tree of tensors or of specs); plain
    gradients pass through."""
    from repro_torch.distributed.partition import placements

    def place(g, target):
        if not is_dtensor(g):
            return g
        want = (placements(target, g.device_mesh)
                if isinstance(target, tuple) else list(target.placements))
        return g if list(g.placements) == want \
            else g.redistribute(g.device_mesh, want)
    return _map_specs(place, grads, like)


def _map_specs(fn, grads, like):
    """``tree.map`` over a tree whose leaves in ``like`` may be spec
    tuples (which ``tree.map`` would walk into)."""
    if isinstance(grads, dict):
        return {k: _map_specs(fn, v, like[k]) for k, v in grads.items()}
    return fn(grads, like)


@traced_source
def backward(loss: torch.Tensor, leaves):
    """``d loss / d leaves`` (zeros for a leaf the loss does not
    reach)."""
    return torch.autograd.grad(loss, leaves, allow_unused=True,
                               materialize_grads=True)


def _grad_fn(api: ModelApi):
    """``(params, batch) → ((loss, metrics), grads)``: the reference's
    ``jax.value_and_grad(api.loss, has_aux=True)``.  The loss runs on
    aliases of the parameters that require grad, so the state's own
    tensors never do; a leaf the loss does not reach gets zeros."""
    def grad_fn(params, batch):
        alias = tree.map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            loss, metrics = api.loss(alias, batch)
            grads = backward(loss, tree.flatten(alias))
        metrics = {k: v.detach() for k, v in metrics.items()}
        return (loss.detach(), metrics), tree.unflatten(alias, grads)
    return grad_fn


def make_train_step(api: ModelApi, opt_cfg: AdamWConfig,
                    num_microbatches: int = 1, grad_specs=None):
    """``train_step(state, batch) → (state, metrics)``, ``metrics``
    holding ``loss``, ``grad_norm``, ``lr``, ``nll`` and ``aux`` as
    tensors on the device.  ``grad_specs``: a tree of specs (the
    reference's PartitionSpecs as tuples) for the gradient
    accumulator of ``DTensor`` state; each microbatch's gradient is
    redistributed to it before it is summed."""
    schedule = warmup_cosine(opt_cfg)
    grad_fn = _grad_fn(api)

    def train_step(state: TrainState, batch: Dict[str, Any]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        params = state["params"]
        if grad_specs is not None and not is_dtensor(tree.flatten(params)[0]):
            raise ValueError("grad_specs place DTensor gradients: the state "
                             "must be DTensors on a mesh")
        target = params if grad_specs is None else grad_specs
        if num_microbatches > 1:
            micro = _split_microbatches(batch, num_microbatches)
            grads = _placed(tree.map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params), target)
            loss = torch.zeros((), dtype=torch.float32,
                               device=state["step"].device)
            for i in repeated(list(range(num_microbatches))):
                (l, _m), g = grad_fn(params, {k: v[i]
                                              for k, v in micro.items()})
                g = _placed(g, target)
                tree.map(lambda a, b: a.add_(b.float()), grads, g)
                loss = loss + l
            grads = tree.map(lambda g: g / num_microbatches, grads)
            loss = loss / num_microbatches
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        else:
            (loss, metrics), grads = grad_fn(params, batch)
            grads = _placed(grads, target)

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
