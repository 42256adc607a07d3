"""Hybrid models: Mamba2 and attention layers interleaved, with MoE.

The PyTorch port of ``repro.models.hybrid``.  Layer pattern (period
``attn_every``): attention at block-local index ``attn_offset``, Mamba2
elsewhere; an MoE MLP on the layers ``cfg.is_moe_layer`` picks, a dense
MLP on the rest.  Jamba: period 8, attention at 4, MoE on odd layers.
Granite 4.0-H: period 10, attention at 5, MoE on every layer (no dense
MLP), a tied table, and four μP scalars from the config, each of which
launches nothing at its default: ``embedding_multiplier`` (the
embedding), ``residual_multiplier`` (each residual branch),
``attention_multiplier`` (the softmax scale, folded into q) and
``logits_scaling`` (the logits' divisor).  Neither uses a positional
encoding (``use_rope=False``).  ``residual_dtype`` (default: ``dtype``)
is the stream's between the layers: at float32 the embedding, each
residual add, the norms and the router run in float32, and every
mixer, expert and the loss's product take the norm's output in
``dtype``.

Parameters are organized as the reference's *superblocks*: the layer
stacks inside one period are stacked across periods, and the forward is
one Python loop over the periods of ``tree.unstack``.  Under
``cfg.remat == "full"`` each layer (mixer and MLP) is recomputed in the
backward, so one layer's activations are live at a time, not a
period's.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Tuple

import torch

from . import layers as L
from . import tree
from .config import ModelConfig

Params = Dict[str, Any]


def _pattern(cfg: ModelConfig) -> List[Tuple[str, bool]]:
    """Block-local sublayer pattern: [(mixer, is_moe), ...] of length P."""
    P = cfg.attn_every
    out = []
    for j in range(P):
        mixer = "attn" if j % P == cfg.attn_offset else "ssm"
        out.append((mixer, cfg.is_moe_layer(j)))
    return out


def _counts(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    pat = _pattern(cfg)
    n_ssm = sum(m == "ssm" for m, _ in pat)
    n_attn = len(pat) - n_ssm
    n_moe = sum(moe for _, moe in pat)
    n_dense = len(pat) - n_moe
    return n_ssm, n_attn, n_dense, n_moe


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Float32 weights from ``gen``, on ``device`` (default: the
    generator's), in the reference's superblock tree."""
    if cfg.num_layers % cfg.attn_every:
        raise ValueError(f"hybrid: {cfg.num_layers} layers are not whole "
                         f"periods of {cfg.attn_every}")
    device = L.init_device(gen, device)
    nb = cfg.num_layers // cfg.attn_every
    pat = _pattern(cfg)

    def init_superblock() -> Params:
        mamba, attn, dense, moe = [], [], [], []
        ln1, ln2 = [], []
        for mixer, is_moe in pat:
            ln1.append(L.init_rmsnorm(cfg.d_model, device)["scale"])
            ln2.append(L.init_rmsnorm(cfg.d_model, device)["scale"])
            if mixer == "ssm":
                mamba.append(L.init_mamba2(gen, cfg, device))
            else:
                attn.append(L.init_attention(gen, cfg.d_model, cfg.num_heads,
                                             cfg.num_kv_heads, cfg.hd,
                                             cfg.qk_norm, device))
            if is_moe:
                moe.append(L.init_moe(gen, cfg.d_model, cfg.moe_num_experts,
                                      cfg.moe_d_ff or cfg.d_ff,
                                      cfg.moe_num_shared, cfg.act, device,
                                      held=cfg.moe_experts_held))
            else:
                dense.append(L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                        device))
        return {
            "mamba": tree.stack(mamba), "attn": tree.stack(attn),
            "mlp": tree.stack(dense), "moe": tree.stack(moe),
            "ln1": torch.stack(ln1), "ln2": torch.stack(ln2),
        }

    params = {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model, device),
        "blocks": tree.stack([init_superblock() for _ in range(nb)]),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = {"table": L.embed_init(
            gen, (cfg.vocab_size, cfg.d_model), device)}
    return params


def unembed_table(params: Params) -> torch.Tensor:
    return (params.get("unembed") or params["embed"])["table"]


def _stream(cfg: ModelConfig) -> torch.dtype:
    """The residual stream's dtype."""
    return L.dtype_of(cfg.residual_dtype or cfg.dtype)


def _embed(cfg: ModelConfig, params: Params, tokens: torch.Tensor
           ) -> torch.Tensor:
    """The tokens' rows in the stream's dtype, times
    ``embedding_multiplier`` unless it is 1."""
    x = L.embed(params["embed"], tokens, _stream(cfg))
    if cfg.embedding_multiplier != 1.0:
        x = x * L._scalar(cfg.embedding_multiplier, x)
    return x


def _residual(cfg: ModelConfig, x: torch.Tensor, y: torch.Tensor
              ) -> torch.Tensor:
    """``x + y · residual_multiplier`` in x's dtype, one kernel that
    takes the multiplier at float32 (``alpha``) and y as it is (no
    multiply at 1)."""
    if cfg.residual_multiplier != 1.0:
        return x.add(y, alpha=cfg.residual_multiplier)
    return x + y


def _queries(cfg: ModelConfig, pa: Params, h: torch.Tensor,
             positions: torch.Tensor):
    """(q, k, v) of an attention layer, q scaled so that the softmax's
    own 1/sqrt(hd) makes ``attention_multiplier`` its scale (nothing is
    launched at the default 0: 1/sqrt(hd))."""
    q, k, v = L._qkv(pa, h, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                     cfg.qk_norm, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.use_rope)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.use_rope)
    if cfg.attention_multiplier:
        q = q * L._scalar(cfg.attention_multiplier * math.sqrt(cfg.hd), q)
    return q, k, v


def _layer(cfg: ModelConfig, mixer: str, is_moe: bool, collect: bool,
           x: torch.Tensor, ln1: torch.Tensor, ln2: torch.Tensor,
           pm: Params, pf: Params, positions: torch.Tensor):
    """One layer: the mixer (``pm``: Mamba2 or attention) and the MLP
    (``pf``: MoE or dense), each a pre-norm residual branch.  Returns
    (x, aux | None, cache | None); with ``collect`` the cache is the
    attention's (k, v) or the Mamba2 layer's (state, conv tails)."""
    cd = L.dtype_of(cfg.dtype)
    h = L.rms_norm({"scale": ln1}, x, cfg.norm_eps).to(cd)
    cache = None
    if mixer == "ssm":
        if collect:
            y, st, tl = L.mamba2_block(pm, h, cfg, return_state=True)
            cache = (st, tl)
        else:
            y = L.mamba2_block(pm, h, cfg)
    else:
        q, k, v = _queries(cfg, pm, h, positions)
        o = L.flash_attention_xla(q, k, v, causal=True,
                                  chunk_q=cfg.attn_chunk_q,
                                  chunk_k=cfg.attn_chunk_k,
                                  causal_skip=cfg.causal_skip)
        B, S = x.shape[:2]
        y = L.out_proj(o.reshape(B, S, cfg.num_heads * cfg.hd), pm["wo"])
        if collect:
            cache = (k, v)
    x = _residual(cfg, x, y)
    m, aux = _mlp(cfg, is_moe, pf, L.rms_norm({"scale": ln2}, x,
                                              cfg.norm_eps))
    return _residual(cfg, x, m), aux, cache


def _mlp(cfg: ModelConfig, is_moe: bool, pf: Params, h: torch.Tensor):
    """A layer's MLP on its normed stream ``h``: (out, aux | None).  The
    dropless MoE routes ``h`` as it is; the others take it in
    ``dtype``."""
    if is_moe and cfg.moe_dispatch == "dropless":
        return L.moe_layer(pf, h, cfg)
    h = h.to(L.dtype_of(cfg.dtype))
    if is_moe:
        return L.moe_layer(pf, h, cfg)
    return L.mlp(pf, h, cfg.act), None


def _superblock(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, collect: bool):
    """Apply one period of layers, each under the config's remat.
    Returns (x, aux, caches)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    mixers = {"ssm": iter(tree.unstack(p["mamba"])),
              "attn": iter(tree.unstack(p["attn"]))}
    mlps = {True: iter(tree.unstack(p.get("moe", {}))),
            False: iter(tree.unstack(p.get("mlp", {})))}
    ln1, ln2 = torch.unbind(p["ln1"]), torch.unbind(p["ln2"])
    kv = None
    states, tails = [], []
    for j, (mixer, is_moe) in enumerate(_pattern(cfg)):
        layer = L.maybe_remat(functools.partial(_layer, cfg, mixer, is_moe,
                                                collect), cfg)
        x, aux, c = layer(x, ln1[j], ln2[j], next(mixers[mixer]),
                          next(mlps[is_moe]), positions)
        if aux is not None:
            aux_total = aux_total + aux
        if collect and mixer == "ssm":
            states.append(c[0])
            tails.append(c[1])
        elif collect:
            kv = c
    caches = None
    if collect:
        caches = {"kv": kv,
                  "state": torch.stack(states),     # [n_ssm,B,H,P,N]
                  "conv": tree.stack(tails)}        # {x,B,C} [n_ssm,...]
    return x, aux_total, caches


def hidden(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
           collect: bool = False):
    """Returns (h, aux, caches | None); with ``collect`` the caches of
    every superblock, stacked: {"kv": (k, v) [nb,B,S,K,hd], "state"
    [nb,n_ssm,B,H,P,N], "conv" {x,B,C} [nb,n_ssm,B,k-1,·]}."""
    tokens = batch["tokens"]
    x = _embed(cfg, params, tokens)
    positions = L.token_positions(tokens)
    auxs, caches = [], []
    for p in tree.unstack(params["blocks"]):
        x, aux, c = _superblock(cfg, p, x, positions, collect)
        auxs.append(aux)
        caches.append(c)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps).to(
        L.dtype_of(cfg.dtype))
    return x, torch.stack(auxs).sum(), \
        (tree.stack(caches) if collect else None)


def logits(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    return L.unembed(unembed_table(params), h, L.dtype_of(cfg.logits_dtype),
                     cfg.logits_scaling), aux


def loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    nll = L.chunked_loss(unembed_table(params), h,
                         L.next_token_labels(batch), cfg.loss_chunk,
                         L.dtype_of(cfg.logits_dtype), cfg.logits_scaling)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zero per-type caches on ``device``: the attention layer's KV
    [nb,B,max_len,K,hd] of ``dtype``, the Mamba layers' SSD states
    [nb,n_ssm,B,H,P,N] in float32 and conv tails {x,B,C}
    [nb,n_ssm,B,k-1,·] of ``dtype`` — one KV cache a period, not a
    layer, as only one layer in ``attn_every`` attends."""
    nb = cfg.num_layers // cfg.attn_every
    n_ssm, _, _, _ = _counts(cfg)
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    di, gn = cfg.ssm_d_inner, cfg.ssm_groups * cfg.ssm_state
    km1 = cfg.ssm_conv - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)
    return {
        "k": zeros(nb, batch, max_len, cfg.num_kv_heads, cfg.hd),
        "v": zeros(nb, batch, max_len, cfg.num_kv_heads, cfg.hd),
        "state": zeros(nb, n_ssm, batch, H, P, N, dt=torch.float32),
        "conv": {"x": zeros(nb, n_ssm, batch, km1, di),
                 "B": zeros(nb, n_ssm, batch, km1, gn),
                 "C": zeros(nb, n_ssm, batch, km1, gn)},
        "pos": zeros(dt=torch.int32),
    }


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            cache: Dict[str, Any]):
    """Process the prompt; write the KV prefix, the SSD states and the
    conv tails into the cache's tensors in place; return last-position
    logits."""
    h, _aux, caches = hidden(cfg, params, batch, collect=True)
    k, v = caches["kv"]                              # [nb,B,S,K,hd]
    S = batch["tokens"].shape[1]
    L.write_prefix(cache["k"], k)
    L.write_prefix(cache["v"], v)
    cache["state"].copy_(caches["state"])
    tree.map(lambda c, t: c.copy_(t), cache["conv"], caches["conv"])
    cache = dict(cache, pos=torch.full((), S, dtype=torch.int32,
                                       device=cache["k"].device))
    out = L.unembed(unembed_table(params), h[:, -1:],
                    L.dtype_of(cfg.logits_dtype), cfg.logits_scaling)
    return out, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any]):
    """One step through the superblock pattern: per-mixer SSD states and
    conv tails, and the period's KV cache, all updated in place.
    tokens [B,1] → (logits [B,1,V], the cache with ``pos`` + 1)."""
    B = tokens.shape[0]
    pos = cache["pos"]
    cd = L.dtype_of(cfg.dtype)
    x = _embed(cfg, params, tokens)
    positions = pos.expand(B, 1)
    for b in range(cfg.num_layers // cfg.attn_every):
        p = tree.index(params["blocks"], b)
        k_c, v_c, st = cache["k"][b], cache["v"][b], cache["state"][b]
        cv = tree.index(cache["conv"], b)
        i_ssm = i_attn = i_dense = i_moe = 0
        for j, (mixer, is_moe) in enumerate(_pattern(cfg)):
            h = L.rms_norm({"scale": p["ln1"][j]}, x, cfg.norm_eps).to(cd)
            if mixer == "ssm":
                tail = tree.index(cv, i_ssm)
                y, s_n, t_n = L.mamba2_decode_step(
                    tree.index(p["mamba"], i_ssm), h, cfg,
                    ssm_state=st[i_ssm], conv_tail=tail)
                st[i_ssm] = s_n
                tree.map(lambda c, t: c.copy_(t), tail, t_n)
                i_ssm += 1
            else:
                pa = tree.index(p["attn"], i_attn)
                i_attn += 1
                q, k, v = _queries(cfg, pa, h, positions)
                L.write_at(k_c, k, pos)
                L.write_at(v_c, v, pos)
                o = L.decode_attention(q, k_c, v_c, pos + 1)
                y = L.out_proj(o.reshape(B, 1, cfg.num_heads * cfg.hd),
                               pa["wo"])
            x = _residual(cfg, x, y)
            h = L.rms_norm({"scale": p["ln2"][j]}, x, cfg.norm_eps)
            if is_moe:
                m, _ = _mlp(cfg, True, tree.index(p["moe"], i_moe), h)
                i_moe += 1
            else:
                m, _ = _mlp(cfg, False, tree.index(p["mlp"], i_dense), h)
                i_dense += 1
            x = _residual(cfg, x, m)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps).to(cd)
    out = L.unembed(unembed_table(params), x, L.dtype_of(cfg.logits_dtype),
                    cfg.logits_scaling)
    return out, dict(cache, pos=pos + 1)
