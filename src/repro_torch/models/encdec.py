"""Whisper-style encoder-decoder backbone (audio family).

The PyTorch port of ``repro.models.encdec``.  The conv/mel frontend is a
stub: the batch supplies precomputed frame embeddings ``frames [B, Se,
d]``, which the encoder consumes directly (adding sinusoidal
positions).  The decoder is a causal transformer with learned positions
and cross-attention.  Whisper uses LayerNorm + GELU and no rotary
embedding, driven by the config (norm="layernorm", act="gelu",
use_rope=False).  Attention over ``enc_seq`` keys (1500 for
whisper-small) is chunked by :func:`~repro_torch.models.layers.
pick_chunk`, the largest divisor of the length within the target.  The
encoder's and the decoder's layers run as Python loops over
``tree.unstack``, each block under ``cfg.remat == "full"`` when set, as
in the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from . import layers as L
from . import tree
from .config import ModelConfig

Params = Dict[str, Any]


def _norm(cfg: ModelConfig):
    if cfg.norm == "layernorm":
        return L.init_layernorm, L.layer_norm
    return L.init_rmsnorm, L.rms_norm


def sinusoids(length: int, channels: int, device="cpu") -> torch.Tensor:
    """Whisper's sinusoidal position embedding [length, channels]."""
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = torch.exp(-log_timescale * torch.arange(
        channels // 2, dtype=torch.float32, device=device))
    scaled = torch.arange(length, dtype=torch.float32,
                          device=device)[:, None] * inv[None]
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Float32 weights from ``gen``, on ``device`` (default: the
    generator's), in the reference's tree."""
    device = L.init_device(gen, device)
    init_n, _ = _norm(cfg)
    d = cfg.d_model

    def attention():
        return L.init_attention(gen, d, cfg.num_heads, cfg.num_kv_heads,
                                cfg.hd, device=device)

    def enc_block():
        return {"ln1": init_n(d, device), "ln2": init_n(d, device),
                "attn": attention(),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.act, device)}

    def dec_block():
        return {"ln1": init_n(d, device), "ln_x": init_n(d, device),
                "ln2": init_n(d, device),
                "attn": attention(), "cross": attention(),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.act, device)}

    return {
        "embed": L.init_embed(gen, cfg.vocab_size, d, device),
        "pos_embed": L.embed_init(gen, (cfg.max_seq, d), device),
        "enc_blocks": tree.stack([enc_block()
                                  for _ in range(cfg.num_enc_layers)]),
        "dec_blocks": tree.stack([dec_block()
                                  for _ in range(cfg.num_layers)]),
        "enc_norm": init_n(d, device),
        "final_norm": init_n(d, device),
    }


def unembed_table(params: Params) -> torch.Tensor:
    return params["embed"]["table"]      # whisper ties embeddings


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def encode(cfg: ModelConfig, params: Params, frames: torch.Tensor
           ) -> torch.Tensor:
    """frames [B, Se, d] (precomputed frontend stub) → encoder states."""
    _, norm_f = _norm(cfg)
    B, Se, d = frames.shape
    dtype = L.dtype_of(cfg.dtype)
    x = frames.to(dtype) + sinusoids(Se, d, frames.device).to(dtype)[None]
    ck = L.pick_chunk(Se, cfg.attn_chunk_k)

    def block(x, p):
        h = norm_f(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hd, False, cfg.norm_eps)
        o = L.flash_attention_xla(q, k, v, causal=False,
                                  chunk_q=ck, chunk_k=ck)
        x = x + o.reshape(B, Se, -1) @ p["attn"]["wo"].to(x.dtype)
        h = norm_f(p["ln2"], x, cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.act)

    block = L.maybe_remat(block, cfg)
    for p in tree.unstack(params["enc_blocks"]):
        x = block(x, p)
    return norm_f(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _cross_kv(cfg: ModelConfig, p_cross: Params, enc: torch.Tensor):
    B, Se, _ = enc.shape
    k = (enc @ p_cross["wk"].to(enc.dtype)).reshape(
        B, Se, cfg.num_kv_heads, cfg.hd)
    v = (enc @ p_cross["wv"].to(enc.dtype)).reshape(
        B, Se, cfg.num_kv_heads, cfg.hd)
    return k, v


def _decoder(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
             enc: torch.Tensor, collect_kv: bool = False):
    """Teacher-forced decoder pass.  Returns (h, kv|None); kv is
    (k, v, cross k, cross v), each stacked [L, B, ·, K, hd]."""
    _, norm_f = _norm(cfg)
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    x = x + params["pos_embed"][:S].to(x.dtype)[None]
    ckx = L.pick_chunk(enc.shape[1], cfg.attn_chunk_k)

    def block(x, p):
        h = norm_f(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hd, False, cfg.norm_eps)
        o = L.flash_attention_xla(q, k, v, causal=True,
                                  chunk_q=cfg.attn_chunk_q,
                                  chunk_k=cfg.attn_chunk_k,
                                  causal_skip=cfg.causal_skip)
        x = x + o.reshape(B, S, -1) @ p["attn"]["wo"].to(x.dtype)
        # cross-attention
        h = norm_f(p["ln_x"], x, cfg.norm_eps)
        qx = (h @ p["cross"]["wq"].to(x.dtype)).reshape(
            B, S, cfg.num_heads, cfg.hd)
        kx, vx = _cross_kv(cfg, p["cross"], enc)
        ox = L.flash_attention_xla(qx, kx, vx, causal=False,
                                   chunk_q=cfg.attn_chunk_q, chunk_k=ckx)
        x = x + ox.reshape(B, S, -1) @ p["cross"]["wo"].to(x.dtype)
        h = norm_f(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg.act)
        return x, ((k, v, kx, vx) if collect_kv else None)

    block = L.maybe_remat(block, cfg)
    kvs = []
    for p in tree.unstack(params["dec_blocks"]):
        x, kv = block(x, p)
        if collect_kv:
            kvs.append(kv)
    x = norm_f(params["final_norm"], x, cfg.norm_eps)
    return x, (tree.stack(kvs) if collect_kv else None)


def hidden(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
           collect_kv: bool = False):
    enc = encode(cfg, params, batch["frames"])
    h, kv = _decoder(cfg, params, batch["tokens"], enc, collect_kv)
    return h, torch.zeros((), dtype=torch.float32, device=h.device), kv


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
    """Zero caches of ``dtype`` on ``device``: the decoder's self-
    attention KV [L,B,max_len,K,hd] and the cross-attention's keys and
    values of the encoder states ``xk``/``xv`` [L,B,enc_seq,K,hd]."""
    K, hd, Ln = cfg.num_kv_heads, cfg.hd, cfg.num_layers
    self_kv = (Ln, batch, max_len, K, hd)
    cross_kv = (Ln, batch, cfg.enc_seq, K, hd)
    return {
        "k": torch.zeros(self_kv, dtype=dtype, device=device),
        "v": torch.zeros(self_kv, dtype=dtype, device=device),
        "xk": torch.zeros(cross_kv, dtype=dtype, device=device),
        "xv": torch.zeros(cross_kv, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            cache: Dict[str, Any]):
    """Encode the frames and run the decoder over the prompt; write the
    self-attention prefix and the cross keys and values into the cache's
    tensors in place; return last-position logits."""
    h, _aux, (k, v, xk, xv) = hidden(cfg, params, batch, collect_kv=True)
    S = batch["tokens"].shape[1]
    cache["k"][:, :, :S] = k
    cache["v"][:, :, :S] = v
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    cache = dict(cache, pos=torch.full((), S, dtype=torch.int32,
                                       device=cache["k"].device))
    out = L.unembed(unembed_table(params), h[:, -1:],
                    L.dtype_of(cfg.logits_dtype))
    return out, cache


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any]):
    """One decoder step at the learned position ``pos``, attending to
    its own cached prefix (written in place) and across to the cached
    encoder keys and values.  tokens [B,1] → (logits [B,1,V], cache)."""
    _, norm_f = _norm(cfg)
    B = tokens.shape[0]
    pos = cache["pos"]
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    pe = params["pos_embed"]                 # clamped, as dynamic_slice does
    x = x + pe.index_select(0, pos.clamp(max=pe.shape[0] - 1).reshape(
        1).long()).to(x.dtype)
    for i in range(cfg.num_layers):
        p = tree.index(params["dec_blocks"], i)
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = norm_f(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hd, False, cfg.norm_eps)
        L.write_at(k_c, k, pos)
        L.write_at(v_c, v, pos)
        o = L.decode_attention(q, k_c, v_c, pos + 1)
        x = x + o.reshape(B, 1, -1) @ p["attn"]["wo"].to(x.dtype)
        h = norm_f(p["ln_x"], x, cfg.norm_eps)
        qx = (h @ p["cross"]["wq"].to(x.dtype)).reshape(
            B, 1, cfg.num_heads, cfg.hd)
        ox = L.naive_attention(qx, cache["xk"][i], cache["xv"][i],
                               causal=False)
        x = x + ox.reshape(B, 1, -1) @ p["cross"]["wo"].to(x.dtype)
        h = norm_f(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg.act)
    x = norm_f(params["final_norm"], x, cfg.norm_eps)
    out = L.unembed(unembed_table(params), x, L.dtype_of(cfg.logits_dtype))
    return out, dict(cache, pos=pos + 1)
