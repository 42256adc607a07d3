"""Mamba2 (SSD) stack — attention-free LM (mamba2-780m).

The PyTorch port of ``repro.models.ssm``: the forward is linear in S
(the chunked SSD of :func:`repro_torch.models.layers.ssd_chunked`).  The
blocks are stacked along a leading axis and run by one Python loop.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from . import layers as L
from . import tree
from .config import ModelConfig

Params = Dict[str, Any]


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Float32 weights from ``gen``, on ``device`` (default: the
    generator's), in the reference's tree."""
    device = L.init_device(gen, device)
    blocks = [{"ln": L.init_rmsnorm(cfg.d_model, device),
               "mamba": L.init_mamba2(gen, cfg, device)}
              for _ in range(cfg.num_layers)]
    p: Params = {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model, device),
        "blocks": tree.stack(blocks),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        p["unembed"] = {"table": L.embed_init(
            gen, (cfg.vocab_size, cfg.d_model), device)}
    return p


def unembed_table(params: Params) -> torch.Tensor:
    return (params.get("unembed") or params["embed"])["table"]


def hidden(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
           collect_state: bool = False):
    """Returns (h, aux = 0, caches | None); with ``collect_state`` the
    caches are (SSD states [L,B,H,P,N], conv tails {x,B,C} [L,B,k-1,·])."""
    x = L.embed(params["embed"], batch["tokens"], L.dtype_of(cfg.dtype))
    states, tails = [], []
    for i in range(cfg.num_layers):
        p = tree.index(params["blocks"], i)
        h = L.rms_norm(p["ln"], x, cfg.norm_eps)
        if collect_state:
            y, state, tail = L.mamba2_block(p["mamba"], h, cfg,
                                            return_state=True)
            states.append(state)
            tails.append(tail)
        else:
            y = L.mamba2_block(p["mamba"], h, cfg)
        x = x + y
    caches = (torch.stack(states), tree.stack(tails)) if collect_state \
        else None
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.zeros((), dtype=torch.float32, device=x.device), caches


def logits(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    return L.unembed(unembed_table(params), h,
                     L.dtype_of(cfg.logits_dtype)), aux


def loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    nll = L.chunked_loss(unembed_table(params), h,
                         L.next_token_labels(batch), cfg.loss_chunk,
                         L.dtype_of(cfg.logits_dtype))
    return nll, {"nll": nll, "aux": aux}
