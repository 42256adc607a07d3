"""Unified model API — one surface over all families.

The PyTorch port of ``repro.models.api``.  ``build(cfg)`` returns a
:class:`ModelApi` whose members close over the config; the model scope
(and, later, training and serving) talks only to this surface, never to
family modules directly.  ``init`` takes a ``torch.Generator`` in place
of a PRNG key; its tensors go on the generator's device.  The serving
members: ``init_cache(batch, max_len, dtype=torch.bfloat16,
device=None)`` makes a zero cache on ``device`` (default: torch's);
``prefill(params, batch, cache, **kw)`` fills it from a prompt and
``decode_step(params, tokens, cache)`` advances it one token.  Both
write the cache's tensors in place and return a dict holding them with
the new ``pos``, where the reference returns new arrays: a cache a step
was given is that step's, not to be used again by its caller.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict

import torch

from . import encdec, hybrid, ssm, transformer
from .config import ModelConfig

_FAMILIES = {
    "dense": transformer,
    "moe": transformer,
    "vlm": transformer,
    "ssm": ssm,
    "hybrid": hybrid,
    "encdec": encdec,
    "audio": encdec,
}


@dataclass(frozen=True)
class ModelApi:
    cfg: ModelConfig
    init: Callable[[torch.Generator], Dict]
    loss: Callable[[Dict, Dict], Any]            # (params, batch) -> (loss, metrics)
    logits: Callable[[Dict, Dict], Any]
    init_cache: Callable[..., Dict]
    prefill: Callable[[Dict, Dict, Dict], Any]   # (params, batch, cache)
    decode_step: Callable[[Dict, torch.Tensor, Dict], Any]
    unembed_table: Callable[[Dict], torch.Tensor]


def family_module(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown family {cfg.family!r}")
    return _FAMILIES[cfg.family]


def build(cfg: ModelConfig) -> ModelApi:
    mod = family_module(cfg)
    return ModelApi(
        cfg=cfg,
        init=lambda gen: mod.init(cfg, gen),
        loss=lambda params, batch: mod.loss(cfg, params, batch),
        logits=lambda params, batch: mod.logits(cfg, params, batch),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device=None:
            mod.init_cache(cfg, batch, max_len, dtype, device),
        prefill=lambda params, batch, cache, **kw: mod.prefill(
            cfg, params, batch, cache, **kw),
        decode_step=lambda params, tokens, cache:
            mod.decode_step(cfg, params, tokens, cache),
        unembed_table=mod.unembed_table,
    )
