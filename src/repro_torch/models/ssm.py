"""Mamba2 (SSD) stack — attention-free LM (mamba2-780m).

The PyTorch port of ``repro.models.ssm``: the forward is linear in S
(the chunked SSD of :func:`repro_torch.models.layers.ssd_chunked`), and
decode is an O(1) recurrent update of a float32 state and the conv
tails, written in place.  The blocks are stacked along a leading axis
and run by one Python loop over ``tree.unstack``, each under
``cfg.remat == "full"`` when set, as in the reference.
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

    def block(x, p):
        h = L.rms_norm(p["ln"], x, cfg.norm_eps)
        if collect_state:
            y, state, tail = L.mamba2_block(p["mamba"], h, cfg,
                                            return_state=True)
            return x + y, (state, tail)
        return x + L.mamba2_block(p["mamba"], h, cfg), None

    block = L.maybe_remat(block, cfg)
    states, tails = [], []
    for p in tree.unstack(params["blocks"]):
        x, caches = block(x, p)
        if collect_state:
            states.append(caches[0])
            tails.append(caches[1])
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zero recurrent caches on ``device``: the SSD state [L,B,H,P,N],
    carried in float32 (it integrates over every step), and the conv
    tails {x,B,C} [L,B,k-1,·] of ``dtype``.  ``max_len`` is unused: the
    state does not grow."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di, gn = cfg.ssm_d_inner, cfg.ssm_groups * cfg.ssm_state
    km1, Ln = cfg.ssm_conv - 1, cfg.num_layers

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return {
        "state": zeros(Ln, batch, H, P, N, dt=torch.float32),
        "conv": {"x": zeros(Ln, batch, km1, di),
                 "B": zeros(Ln, batch, km1, gn),
                 "C": zeros(Ln, batch, km1, gn)},
        "pos": zeros(dt=torch.int32),
    }


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            cache: Dict[str, Any]):
    """Process the prompt; write the final SSD states and conv tails
    into the cache's tensors in place; return last-position logits."""
    h, _aux, (states, tails) = hidden(cfg, params, batch, collect_state=True)
    cache["state"].copy_(states)
    tree.map(lambda c, t: c.copy_(t), cache["conv"], tails)
    cache = dict(cache, pos=torch.full((), batch["tokens"].shape[1],
                                       dtype=torch.int32,
                                       device=cache["state"].device))
    out = L.unembed(unembed_table(params), h[:, -1:],
                    L.dtype_of(cfg.logits_dtype))
    return out, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any]):
    """One recurrent step.  tokens [B,1] → (logits [B,1,V], the cache
    with each layer's state and conv tails updated in place)."""
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    for i in range(cfg.num_layers):
        p = tree.index(params["blocks"], i)
        tail = tree.index(cache["conv"], i)
        h = L.rms_norm(p["ln"], x, cfg.norm_eps)
        y, state_new, tail_new = L.mamba2_decode_step(
            p["mamba"], h, cfg, ssm_state=cache["state"][i], conv_tail=tail)
        cache["state"][i] = state_new
        tree.map(lambda c, t: c.copy_(t), tail, tail_new)
        x = x + y
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    out = L.unembed(unembed_table(params), x, L.dtype_of(cfg.logits_dtype))
    return out, dict(cache, pos=cache["pos"] + 1)
