"""Decoder-only transformer LM — dense, MoE, and VLM-stub variants.

The PyTorch port of ``repro.models.transformer``.  Covers llama3.2-1b,
qwen3-1.7b, internlm2-1.8b, stablelm-12b (dense), moonshot-v1-16b-a3b,
deepseek-moe-16b (MoE), qwen2-vl-2b (VLM backbone with M-RoPE and
stubbed vision embeddings).

Layers are stacked along a leading axis (``params["blocks"]``), as the
reference stacks them for ``lax.scan``; the forward is one Python loop
over the layers of ``tree.unstack``, whatever ``cfg.scan_layers`` says,
each block under ``cfg.remat`` (``none``, ``full`` or ``dots``: see
:func:`~repro_torch.models.layers.maybe_remat`).  Serving: a KV cache
[L, B, max_len, K, hd] padded to ``max_len``, filled by :func:`prefill`
and advanced by :func:`decode_step` (one clock for the batch) or
:func:`decode_step_ragged` (a clock a row); both write the cache's
tensors in place.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

from . import layers as L
from . import tree
from .config import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, moe: bool,
                device) -> Params:
    p: Params = {
        "ln1": L.init_rmsnorm(cfg.d_model, device),
        "ln2": L.init_rmsnorm(cfg.d_model, device),
        "attn": L.init_attention(gen, cfg.d_model, cfg.num_heads,
                                 cfg.num_kv_heads, cfg.hd, cfg.qk_norm,
                                 device=device),
    }
    if moe:
        p["moe"] = L.init_moe(gen, cfg.d_model, cfg.moe_num_experts,
                              cfg.moe_d_ff or cfg.d_ff,
                              cfg.moe_num_shared, cfg.act, device=device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.act,
                              device=device)
    return p


def init(cfg: ModelConfig, gen: torch.Generator, device=None) -> Params:
    """Float32 weights from ``gen``, on ``device`` (default: the
    generator's), in the reference's tree."""
    device = L.init_device(gen, device)
    moe = cfg.moe_num_experts > 0
    blocks = [_init_block(gen, cfg, moe and cfg.is_moe_layer(i), device)
              for i in range(cfg.num_layers)]
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


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _block_apply(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 positions: torch.Tensor, collect_kv: bool):
    """One transformer block.  Returns (x, aux, (k, v) | None)."""
    h = L.rms_norm(p["ln1"], x, cfg.norm_eps)
    q, k, v = L._qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads, cfg.hd,
                     cfg.qk_norm, cfg.norm_eps)
    q = L.apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.use_rope)
    k = L.apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections,
                     cfg.use_rope)
    if cfg.attn_impl == "naive":
        o = L.naive_attention(q, k, v, causal=True)
    else:
        o = L.flash_attention_xla(q, k, v, causal=True,
                                  chunk_q=cfg.attn_chunk_q,
                                  chunk_k=cfg.attn_chunk_k,
                                  causal_skip=cfg.causal_skip)
    B, S = x.shape[:2]
    x = x + o.reshape(B, S, cfg.num_heads * cfg.hd) @ \
        p["attn"]["wo"].to(x.dtype)

    h = L.rms_norm(p["ln2"], x, cfg.norm_eps)
    if "moe" in p:
        m, aux = L.moe_layer(p["moe"], h, cfg)
    else:
        m = L.mlp(p["mlp"], h, cfg.act)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    x = x + m
    return x, aux, ((k, v) if collect_kv else None)


def _embed_inputs(cfg: ModelConfig, params: Params, batch: Dict[str, Any]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    if cfg.frontend == "vision_patches" and "vision_embeds" in batch:
        # stubbed multimodal merge: precomputed patch embeddings replace
        # the token embeddings at masked positions (qwen2-vl style)
        ve = batch["vision_embeds"].to(x.dtype)
        x = torch.where(batch["vision_mask"][..., None], ve, x)
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        if cfg.mrope_sections:
            positions = positions[None].expand(3, B, S)
    return x, positions


def hidden(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
           collect_kv: bool = False):
    """Run the block stack.  Returns (h, aux, kv|None).

    kv (prefill): (k, v) stacked [L, B, S, K, hd].
    """
    x, positions = _embed_inputs(cfg, params, batch)

    def block(x, p):
        return _block_apply(cfg, p, x, positions, collect_kv)

    block = L.maybe_remat(block, cfg, dots=True)
    auxs, ks, vs = [], [], []
    for p in tree.unstack(params["blocks"]):
        x, a, kv = block(x, p)
        auxs.append(a)
        if collect_kv:
            ks.append(kv[0])
            vs.append(kv[1])
    aux = torch.stack(auxs).sum()
    kv = (torch.stack(ks), torch.stack(vs)) if collect_kv else None
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return x, aux, kv


def logits(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    h, aux, _ = hidden(cfg, params, batch)
    out = L.unembed(unembed_table(params), h, L.dtype_of(cfg.logits_dtype))
    return out, aux


def loss(cfg: ModelConfig, params: Params, batch: Dict[str, Any]):
    """Next-token cross-entropy (+ MoE aux), seq-chunked when configured."""
    h, aux, _ = hidden(cfg, params, batch)
    nll = L.chunked_loss(unembed_table(params), h,
                         L.next_token_labels(batch), cfg.loss_chunk,
                         L.dtype_of(cfg.logits_dtype))
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


# ---------------------------------------------------------------------------
# serving: cache / prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    """Zero KV cache [L, B, max_len, K, hd] of ``dtype`` on ``device``
    (default: torch's), and the clock ``pos``."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: Params, batch: Dict[str, Any],
            cache: Dict[str, Any], logit_pos=None):
    """Process the prompt; fill the cache; return last-position logits.

    ``logit_pos``: position whose logits to return (an int or a scalar
    tensor) — the serve engine passes len(prompt)-1 for right-padded
    prompts.  The prompt's keys and values are written into the cache's
    tensors in place; the returned dict holds them and the new ``pos``.
    """
    h, _aux, kv = hidden(cfg, params, batch, collect_kv=True)
    k, v = kv                                       # [L,B,S,K,hd]
    S = k.shape[2]
    cache["k"][:, :, :S] = k
    cache["v"][:, :, :S] = v
    cache = dict(cache, pos=torch.full((), S, dtype=torch.int32,
                                       device=cache["k"].device))
    if logit_pos is None:
        h_last = h[:, -1:]
    elif isinstance(logit_pos, torch.Tensor):
        h_last = h.index_select(1, logit_pos.reshape(1).long())
    else:
        h_last = h[:, logit_pos:logit_pos + 1]
    out = L.unembed(unembed_table(params), h_last,
                    L.dtype_of(cfg.logits_dtype))
    return out, cache


def _decode_blocks(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                   cache: Dict[str, Any], pos: torch.Tensor,
                   write: Callable[[torch.Tensor, torch.Tensor], None]):
    """The block stack over one token a row at positions ``pos`` [B]:
    each layer writes its k/v with ``write`` and attends to the row's
    prefix up to the new token.  Returns the logits [B,1,V]."""
    B = tokens.shape[0]
    positions = pos[:, None]                             # [B,1]
    if cfg.mrope_sections:
        positions = positions[None].expand(3, B, 1)
    x = L.embed(params["embed"], tokens, L.dtype_of(cfg.dtype))
    for i in range(cfg.num_layers):
        p = tree.index(params["blocks"], i)
        k_c, v_c = cache["k"][i], cache["v"][i]
        h = L.rms_norm(p["ln1"], x, cfg.norm_eps)
        q, k, v = L._qkv(p["attn"], h, cfg.num_heads, cfg.num_kv_heads,
                         cfg.hd, cfg.qk_norm, cfg.norm_eps)
        q = L.apply_rope(q, positions, cfg.rope_theta,
                         cfg.mrope_sections, cfg.use_rope)
        k = L.apply_rope(k, positions, cfg.rope_theta,
                         cfg.mrope_sections, cfg.use_rope)
        write(k_c, k)
        write(v_c, v)
        o = L.decode_attention(q, k_c, v_c, pos + 1)
        x = x + o.reshape(B, 1, cfg.num_heads * cfg.hd) @ \
            p["attn"]["wo"].to(x.dtype)
        h = L.rms_norm(p["ln2"], x, cfg.norm_eps)
        if "moe" in p:
            m, _ = L.moe_layer(p["moe"], h, cfg)
        else:
            m = L.mlp(p["mlp"], h, cfg.act)
        x = x + m
    x = L.rms_norm(params["final_norm"], x, cfg.norm_eps)
    return L.unembed(unembed_table(params), x, L.dtype_of(cfg.logits_dtype))


def decode_step(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                cache: Dict[str, Any]):
    """One decode step.  tokens [B,1] → (logits [B,1,V], the cache with
    the new token's k/v written in place and ``pos`` + 1)."""
    pos = cache["pos"]
    out = _decode_blocks(cfg, params, tokens, cache,
                         pos.expand(tokens.shape[0]),
                         lambda c, new: L.write_at(c, new, pos))
    return out, dict(cache, pos=pos + 1)


def decode_step_ragged(cfg: ModelConfig, params: Params,
                       tokens: torch.Tensor, cache: Dict[str, Any]):
    """Decode with PER-ROW positions — the continuous-batching path.

    ``cache['pos']`` is [B]: each slot writes its k/v at its own offset
    (in place) and masks to its own prefix.  Used by the serve engine,
    whose slots hold requests admitted at different times; the
    uniform-batch ``decode_step`` remains the path of a batch that
    started together.
    """
    pos = cache["pos"]                                   # [B]
    out = _decode_blocks(cfg, params, tokens, cache, pos,
                         lambda c, new: L.write_rows(c, new, pos))
    return out, dict(cache, pos=pos + 1)
