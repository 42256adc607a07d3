"""Unified model API — one surface over all families.

The PyTorch port of ``repro.models.api``.  ``build(cfg)`` returns a
:class:`ModelApi` whose members close over the config; the model scope
(and, later, training and serving) talks only to this surface, never to
family modules directly.  ``init`` takes a ``torch.Generator`` in place
of a PRNG key; its tensors go on the generator's device.  The serving
members (``init_cache``, ``prefill``, ``decode_step``) are not ported
yet and raise ``NotImplementedError``.
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


def _not_ported(member: str) -> Callable[..., Any]:
    def raise_(*args, **kwargs):
        raise NotImplementedError(
            f"ModelApi.{member}: the decode path is not ported yet; it "
            f"comes with the serve engine (ROADMAP queue 1 #6)")
    return raise_


def build(cfg: ModelConfig) -> ModelApi:
    mod = family_module(cfg)
    return ModelApi(
        cfg=cfg,
        init=lambda gen: mod.init(cfg, gen),
        loss=lambda params, batch: mod.loss(cfg, params, batch),
        logits=lambda params, batch: mod.logits(cfg, params, batch),
        init_cache=_not_ported("init_cache"),
        prefill=_not_ported("prefill"),
        decode_step=_not_ported("decode_step"),
        unembed_table=mod.unembed_table,
    )
