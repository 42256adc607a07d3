"""Jamba-style hybrid: Mamba+attention 1:7 interleave with interleaved MoE.

The PyTorch port of ``repro.models.hybrid``.  Layer pattern (period
``attn_every`` = 8): attention at block-local index ``attn_offset`` (4),
Mamba elsewhere; MoE MLP on odd layers, dense on even.  Jamba uses no
positional encoding (``use_rope=False``).

Parameters are organized as the reference's *superblocks*: the layer
stacks inside one period are stacked across periods, and the forward is
one Python loop over the periods of ``tree.unstack``, each superblock
under ``cfg.remat == "full"`` when set, as in the reference.
"""
from __future__ import annotations

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
                                      cfg.moe_num_shared, cfg.act, device))
            else:
                dense.append(L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                                        device))
        return {
            "mamba": tree.stack(mamba), "attn": tree.stack(attn),
            "mlp": tree.stack(dense), "moe": tree.stack(moe),
            "ln1": torch.stack(ln1), "ln2": torch.stack(ln2),
        }

    return {
        "embed": L.init_embed(gen, cfg.vocab_size, cfg.d_model, device),
        "blocks": tree.stack([init_superblock() for _ in range(nb)]),
        "final_norm": L.init_rmsnorm(cfg.d_model, device),
        "unembed": {"table": L.embed_init(
            gen, (cfg.vocab_size, cfg.d_model), device)},
    }


def unembed_table(params: Params) -> torch.Tensor:
    return (params.get("unembed") or params["embed"])["table"]


def _superblock(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor, collect: bool):
    """Apply one period of sublayers.  Returns (x, aux, caches)."""
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    mambas, attns = tree.unstack(p["mamba"]), tree.unstack(p["attn"])
    dense, moes = tree.unstack(p["mlp"]), tree.unstack(p["moe"])
    ln1, ln2 = torch.unbind(p["ln1"]), torch.unbind(p["ln2"])
    i_ssm = i_attn = i_dense = i_moe = 0
    kv = None
    states, tails = [], []
    for j, (mixer, is_moe) in enumerate(_pattern(cfg)):
        h = L.rms_norm({"scale": ln1[j]}, x, cfg.norm_eps)
        if mixer == "ssm":
            pm = mambas[i_ssm]
            i_ssm += 1
            if collect:
                y, st, tl = L.mamba2_block(pm, h, cfg, return_state=True)
                states.append(st)
                tails.append(tl)
            else:
                y = L.mamba2_block(pm, h, cfg)
        else:
            pa = attns[i_attn]
            i_attn += 1
            q, k, v = L._qkv(pa, h, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                             cfg.qk_norm, cfg.norm_eps)
            q = L.apply_rope(q, positions, cfg.rope_theta,
                             cfg.mrope_sections, cfg.use_rope)
            k = L.apply_rope(k, positions, cfg.rope_theta,
                             cfg.mrope_sections, cfg.use_rope)
            o = L.flash_attention_xla(q, k, v, causal=True,
                                      chunk_q=cfg.attn_chunk_q,
                                      chunk_k=cfg.attn_chunk_k,
                                      causal_skip=cfg.causal_skip)
            B, S = x.shape[:2]
            y = o.reshape(B, S, cfg.num_heads * cfg.hd) @ \
                pa["wo"].to(x.dtype)
            if collect:
                kv = (k, v)
        x = x + y
        h = L.rms_norm({"scale": ln2[j]}, x, cfg.norm_eps)
        if is_moe:
            m, aux = L.moe_layer(moes[i_moe], h, cfg)
            i_moe += 1
            aux_total = aux_total + aux
        else:
            m = L.mlp(dense[i_dense], h, cfg.act)
            i_dense += 1
        x = x + m
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
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)

    def block(x, p):
        return _superblock(cfg, p, x, positions, collect)

    block = L.maybe_remat(block, cfg)
    auxs, caches = [], []
    for p in tree.unstack(params["blocks"]):
        x, aux, c = block(x, p)
        auxs.append(aux)
        caches.append(c)
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, torch.stack(auxs).sum(), \
        (tree.stack(caches) if collect else None)


def logits(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    return L.unembed(unembed_table(params), h,
                     L.dtype_of(cfg.logits_dtype)), aux


def loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    nll = L.chunked_loss(unembed_table(params), h,
                         L.next_token_labels(batch), cfg.loss_chunk,
                         L.dtype_of(cfg.logits_dtype))
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
    cache["k"][:, :, :S] = k
    cache["v"][:, :, :S] = v
    cache["state"].copy_(caches["state"])
    tree.map(lambda c, t: c.copy_(t), cache["conv"], caches["conv"])
    cache = dict(cache, pos=torch.full((), S, dtype=torch.int32,
                                       device=cache["k"].device))
    out = L.unembed(unembed_table(params), h[:, -1:],
                    L.dtype_of(cfg.logits_dtype))
    return out, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any]):
    """One step through the superblock pattern: per-mixer SSD states and
    conv tails, and the period's KV cache, all updated in place.
    tokens [B,1] → (logits [B,1,V], the cache with ``pos`` + 1)."""
    B = tokens.shape[0]
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    positions = pos.expand(B, 1)
    for b in range(cfg.num_layers // cfg.attn_every):
        p = tree.index(params["blocks"], b)
        k_c, v_c, st = cache["k"][b], cache["v"][b], cache["state"][b]
        cv = tree.index(cache["conv"], b)
        i_ssm = i_attn = i_dense = i_moe = 0
        for j, (mixer, is_moe) in enumerate(_pattern(cfg)):
            h = L.rms_norm({"scale": p["ln1"][j]}, x, cfg.norm_eps)
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
                q, k, v = L._qkv(pa, h, cfg.num_heads, cfg.num_kv_heads,
                                 cfg.hd, cfg.qk_norm, cfg.norm_eps)
                q = L.apply_rope(q, positions, cfg.rope_theta,
                                 cfg.mrope_sections, cfg.use_rope)
                k = L.apply_rope(k, positions, cfg.rope_theta,
                                 cfg.mrope_sections, cfg.use_rope)
                L.write_at(k_c, k, pos)
                L.write_at(v_c, v, pos)
                o = L.decode_attention(q, k_c, v_c, pos + 1)
                y = o.reshape(B, 1, cfg.num_heads * cfg.hd) @ \
                    pa["wo"].to(x.dtype)
            x = x + y
            h = L.rms_norm({"scale": p["ln2"][j]}, x, cfg.norm_eps)
            if is_moe:
                m, _ = L.moe_layer(tree.index(p["moe"], i_moe), h, cfg)
                i_moe += 1
            else:
                m = L.mlp(tree.index(p["mlp"], i_dense), h, cfg.act)
                i_dense += 1
            x = x + m
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    out = L.unembed(unembed_table(params), x, L.dtype_of(cfg.logits_dtype))
    return out, dict(cache, pos=pos + 1)
