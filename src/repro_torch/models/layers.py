"""Neural building blocks — the PyTorch port of ``repro.models.layers``.

The forward path of the model zoo: norms (:func:`rms_norm`,
:func:`layer_norm`), rotary embeddings with M-RoPE, GQA attention
(:func:`naive_attention`, the oracle, and :func:`flash_attention_xla`,
the chunked online-softmax formulation with a recompute backward), the
SwiGLU/GELU MLP, capacity-based MoE (scatter dispatch and the one-hot
einsum oracle, with shared experts), the Mamba2 block on the SSD scans
(:func:`ssd_reference`, :func:`ssd_chunked`), and the embedding, the
unembedding and the (chunked) cross-entropy; and the decode path
(:func:`decode_attention` over a padded KV cache, :func:`mamba2_decode_step`
with :func:`_conv_decode`); and :func:`maybe_remat`, the per-layer
rematerialization the families apply under grad.  The expert-parallel
``moe_shard_map`` is not ported yet.

Conventions are the reference's: parameters are plain dicts of float32
tensors made by the matching ``init_*`` functions (from an explicit
``torch.Generator``, on its device unless ``device`` is given; the
``meta`` device gives the tree's shapes without data), activations
``[B, S, ...]``, attention heads ``[B, S, H, D]`` with ``K`` kv heads
(``H % K == 0``).  Weights are cast to the activations' dtype at each
product (``x @ w.to(x.dtype)``), so a bfloat16 forward rounds every
product to bfloat16 where the reference does.  The reference's
``constrain`` sharding annotations are left out: the port has no mesh
yet.  JAX's ``lax.scan`` loops become Python loops; products that the
reference takes with ``preferred_element_type=float32`` are taken on
float32 copies of the operands, which gives the same products (a
bfloat16 product is exact in float32) summed in float32.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

Params = Dict[str, Any]

_NEG_INF = float("-inf")

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Normal float32 weights, scaled by ``1/sqrt(fan_in)`` unless
    ``scale`` is given, on ``device`` (default: the generator's)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=init_device(gen, device)) * scale


def embed_init(gen: torch.Generator, shape, device=None) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=init_device(gen, device)) * 0.02


def init_device(gen: torch.Generator, device) -> torch.device:
    """Where ``init_*`` puts its tensors: ``device``, else the
    generator's."""
    return gen.device if device is None else torch.device(device)


# ---------------------------------------------------------------------------
# rematerialization
# ---------------------------------------------------------------------------


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``dots``: keep the outputs of 2-D products (``aten.mm``: every
    weight product, the products with no batch dimension that
    ``checkpoint_dots_with_no_batch_dims`` keeps) and recompute the rest,
    the attention's batched products among them."""
    if op is torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def maybe_remat(fn: Callable, cfg, dots: bool = False) -> Callable:
    """``fn`` under the config's ``remat`` policy, the reference's
    ``jax.checkpoint`` of a layer: ``full`` keeps only the layer's inputs
    and recomputes its forward in the backward; ``dots`` (where
    ``dots``, as the reference's transformer allows it) keeps the 2-D
    products' outputs too.  Anything else, and any call with grad off
    (``inference_mode``, ``no_grad``: the model scope, serving), runs
    ``fn`` as it is.  Non-tensor arguments pass through; the config and
    other constants belong in ``fn``'s closure."""
    if cfg.remat == "full":
        context_fn = None
    elif dots and cfg.remat == "dots":
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       _save_dots)
    else:
        return fn

    def remat(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        if context_fn is None:
            return checkpoint(fn, *args, use_reentrant=False)
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=context_fn)
    return remat


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, cast back to
    ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def pick_chunk(S: int, target: int = 512) -> int:
    """Largest divisor of S that is ≤ target (flash chunking for odd S)."""
    best = 1
    for c in range(1, min(S, target) + 1):
        if S % c == 0:
            best = c
    return best


def init_layernorm(d: int, device) -> Params:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm in float32 with the population variance (``jnp.var``),
    cast back to ``x.dtype``."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"] + p["bias"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding (standard + M-RoPE)
# ---------------------------------------------------------------------------


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Tuple[int, ...] = (),
               enabled: bool = True) -> torch.Tensor:
    """Rotate ``x [B,S,H,D]`` by position (the identity when not
    ``enabled``).

    ``positions``: ``[B,S]`` for standard RoPE, or ``[3,B,S]`` for M-RoPE
    (qwen2-vl): the D/2 frequency channels are split into
    ``mrope_sections`` groups (t, h, w), each rotated by its own position
    stream.  Text tokens carry identical t/h/w positions, which makes
    M-RoPE collapse to standard RoPE.
    """
    if not enabled:
        return x
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                 # [D/2]
    pos = positions.float()
    if mrope_sections:
        if pos.ndim != 3 or sum(mrope_sections) != hd // 2:
            raise ValueError(f"M-RoPE needs [3,B,S] positions and sections "
                             f"summing to {hd // 2}: {tuple(pos.shape)}, "
                             f"{mrope_sections}")
        # per frequency channel, the position stream that drives it
        sec_id = torch.repeat_interleave(
            torch.arange(len(mrope_sections), device=x.device),
            torch.tensor(mrope_sections, device=x.device))
        # angle[b,s,c] = pos[sec_id[c],b,s] * freqs[c]
        angle = pos[sec_id].permute(1, 2, 0) * freqs
    else:
        angle = pos[..., None] * freqs                      # [B,S,D/2]
    cos = torch.cos(angle)[:, :, None, :]                   # [B,S,1,D/2]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, d: int, H: int, K: int, hd: int,
                   qk_norm: bool = False, device=None) -> Params:
    device = init_device(gen, device)
    p: Params = {
        "wq": dense_init(gen, (d, H * hd), device=device),
        "wk": dense_init(gen, (d, K * hd), device=device),
        "wv": dense_init(gen, (d, K * hd), device=device),
        "wo": dense_init(gen, (H * hd, d), device=device),
    }
    if qk_norm:
        p["q_norm"] = init_rmsnorm(hd, device)
        p["k_norm"] = init_rmsnorm(hd, device)
    return p


def _qkv(p: Params, x: torch.Tensor, H: int, K: int, hd: int,
         qk_norm: bool, eps: float
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
    k = (x @ p["wk"].to(x.dtype)).reshape(B, S, K, hd)
    v = (x @ p["wv"].to(x.dtype)).reshape(B, S, K, hd)
    if qk_norm:
        q = rms_norm(p["q_norm"], q, eps)
        k = rms_norm(p["k_norm"], k, eps)
    return q, k, v


def repeat_kv(k: torch.Tensor, H: int) -> torch.Tensor:
    """GQA: repeat kv heads to H ([B,S,K,D] → [B,S,H,D]); head ``h``
    reads kv head ``h // (H/K)``."""
    K = k.shape[2]
    if K == H:
        return k
    return k.repeat_interleave(H // K, dim=2)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset=0,
                    kv_len=None) -> torch.Tensor:
    """Reference attention, GQA-aware.  q [B,Sq,H,D], k/v [B,Sk,K,D].

    ``q_offset``: absolute position of q[0] (for decode: cache length);
    the causal mask is ``k_pos <= q_pos``.  ``kv_len``: valid prefix
    length of k/v (the rest is padding to ignore).  Fully masked rows
    give zeros.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kr = repeat_kv(k, H).float()
    vr = repeat_kv(v, H).float()
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kr) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if kv_len is not None:
        mask &= k_pos < kv_len
    s = s.masked_fill(~mask[None, None], _NEG_INF)
    w = torch.softmax(s, dim=-1)
    w = torch.where(torch.isnan(w), 0.0, w)       # fully-masked rows
    o = torch.einsum("bhqs,bshd->bqhd", w, vr)
    return o.to(q.dtype)


def _chunk_pairs(Sq: int, Sk: int, cq: int, ck: int, causal: bool,
                 causal_skip: bool) -> List[Tuple[int, int]]:
    """Static chunk-pair schedule."""
    nq, nk = Sq // cq, Sk // ck
    if causal and causal_skip:
        # only lower-triangular chunk pairs: ~2x fewer FLOPs than masking
        # a full quadratic sweep
        off = (Sk - Sq) // ck
        return [(i, j) for i in range(nq) for j in range(0, i + off + 1)]
    return [(i, j) for i in range(nq) for j in range(nk)]


def _split_pairs(Sq, Sk, cq, ck, causal, causal_skip):
    """(off-diagonal pairs, diagonal pairs) for the two-pass schedule."""
    pairs = _chunk_pairs(Sq, Sk, cq, ck, causal, causal_skip)
    diag, offd = [], []
    for i, j in pairs:
        # masking needed iff the k-chunk straddles the diagonal: some k
        # position exceeds the chunk's smallest absolute q position
        last_k = j * ck + ck - 1
        first_q_abs = i * cq + (Sk - Sq)
        if causal and last_k > first_q_abs:
            diag.append((i, j))
        else:
            offd.append((i, j))
    return offd, diag


def _causal_mask(i, j, cq, ck, Sq, Sk, device) -> torch.Tensor:
    """[cq, ck] keep-mask of chunk pair (i, j): bottom-right aligned,
    ``k_pos <= q_pos + (Sk - Sq)``."""
    q_pos = i * cq + torch.arange(cq, device=device)[:, None] + (Sk - Sq)
    k_pos = j * ck + torch.arange(ck, device=device)[None, :]
    return k_pos <= q_pos


def _flash_fwd_scan(q, kr, vr, causal, cq, ck, causal_skip):
    """Online softmax over chunk pairs.  q [B,Sq,H,D]; kr/vr [B,Sk,H,D].

    Off-diagonal pairs run first without a mask, then the diagonal
    pairs with it, as in the reference.  The softmax scale is folded
    into q once, in q's dtype.  ``p`` is cast to v's dtype before the
    PV product, as the reference feeds bfloat16 p to the MXU.

    Returns (out float32 [B,Sq,H,D], lse [B,H,Sq]).
    """
    B, Sq, H, D = q.shape
    Sk = kr.shape[1]
    qs = q * torch.tensor(1.0 / math.sqrt(D), dtype=q.dtype)
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)

    def body(i, j, masked):
        iq, jk = slice(i * cq, i * cq + cq), slice(j * ck, j * ck + ck)
        vc = vr[:, jk]
        s = torch.einsum("bqhd,bshd->bhqs", qs[:, iq].float(),
                         kr[:, jk].float())
        if masked:
            keep = _causal_mask(i, j, cq, ck, Sq, Sk, q.device)
            s = s.masked_fill(~keep[None, None], _NEG_INF)
        mc, lc, ac = m[:, :, iq], l[:, :, iq], acc[:, :, iq]
        m_new = torch.maximum(mc, s.amax(dim=-1))
        if masked:
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None]).to(vc.dtype)
            p = torch.where(torch.isneginf(s), 0.0, p).to(vc.dtype)
        else:
            p = torch.exp(s - m_new[..., None]).to(vc.dtype)
        corr = torch.exp(mc - m_new)
        corr = torch.where(torch.isneginf(mc), 0.0, corr)
        pf = p.float()
        l[:, :, iq] = lc * corr + pf.sum(dim=-1)
        acc[:, :, iq] = ac * corr[..., None] + torch.einsum(
            "bhqs,bshd->bhqd", pf, vc.float())
        m[:, :, iq] = m_new

    offd, diag = _split_pairs(Sq, Sk, cq, ck, causal, causal_skip)
    for i, j in offd:
        body(i, j, masked=False)
    for i, j in diag:
        body(i, j, masked=causal)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).permute(0, 2, 1, 3)   # → [B,Sq,H,D]
    lse = torch.where(l > 0.0, m + torch.log(l_safe), float("inf"))
    return out, lse


def _flash_fwd(q, k, v, causal, cq, ck, causal_skip):
    H = q.shape[2]
    kr, vr = repeat_kv(k, H), repeat_kv(v, H)
    out, lse = _flash_fwd_scan(q, kr, vr, causal, cq, ck, causal_skip)
    return out.to(q.dtype), lse


def _flash_bwd_scan(q, k, v, out, lse, dout, causal, cq, ck, causal_skip):
    """Recompute-based flash backward (no saved per-pair history)."""
    B, Sq, H, D = q.shape
    kr, vr = repeat_kv(k, H), repeat_kv(v, H)
    Sk = kr.shape[1]
    K = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    # the scale is folded into the small [.,S,H,D] tensors once:
    #   s = (q·scale)·k ;  ds = p·(do'·v − δ') with do' = do·scale
    qs = q * torch.tensor(scale, dtype=q.dtype)
    dos = dout * torch.tensor(scale, dtype=dout.dtype)
    # delta'_i = rowsum(do'_i * out_i)  [B,H,Sq]
    delta = torch.einsum("bqhd,bqhd->bhq", dos.float(), out.float())
    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=q.device)

    def body(i, j, masked):
        iq, jk = slice(i * cq, i * cq + cq), slice(j * ck, j * ck + ck)
        kc, doc = kr[:, jk], dout[:, iq]
        s = torch.einsum("bqhd,bshd->bhqs", qs[:, iq].float(), kc.float())
        if masked:
            keep = _causal_mask(i, j, cq, ck, Sq, Sk, q.device)
            s = s.masked_fill(~keep[None, None], _NEG_INF)
        p = torch.exp(s - lse[:, :, iq, None])       # masked → exp(-inf)=0
        if masked:
            p = torch.where(torch.isneginf(s), 0.0, p)
        pd = p.to(doc.dtype).float()
        dv[:, jk] += torch.einsum("bhqs,bqhd->bshd", pd, doc.float())
        dp = torch.einsum("bqhd,bshd->bhqs", dos[:, iq].float(),
                          vr[:, jk].float())
        ds = p * (dp - delta[:, :, iq, None])
        dsd = ds.to(kc.dtype).float()
        dq[:, iq] += torch.einsum("bhqs,bshd->bqhd", dsd, kc.float())
        dk[:, jk] += torch.einsum("bhqs,bqhd->bshd", dsd, q[:, iq].float())

    offd, diag = _split_pairs(Sq, Sk, cq, ck, causal, causal_skip)
    for i, j in offd:
        body(i, j, masked=False)
    for i, j in diag:
        body(i, j, masked=causal)
    if K != H:                                    # fold GQA repeats back
        G = H // K
        dk = dk.reshape(B, Sk, K, G, D).sum(3)
        dv = dv.reshape(B, Sk, K, G, D).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    """The reference's ``custom_vjp``: the forward saves (q, k, v, out,
    lse); the backward recomputes each chunk pair's scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, cq, ck, causal_skip):
        out, lse = _flash_fwd(q, k, v, causal, cq, ck, causal_skip)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.schedule = (causal, cq, ck, causal_skip)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_scan(q, k, v, out, lse, dout.contiguous(),
                                     *ctx.schedule)
        return dq, dk, dv, None, None, None, None


def flash_attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        chunk_q: int = 512, chunk_k: int = 512,
                        causal_skip: bool = True) -> torch.Tensor:
    """Chunked online-softmax attention in plain torch with a recompute
    backward (a ``torch.autograd.Function``).

    The name is the reference's (``repro.models.layers``), kept so a
    reader finds the counterpart: this is the plain-torch chunked
    formulation, not a kernel.  It never materialises ``[Sq, Sk]``; the
    backward recomputes per chunk pair, so residuals are O(S·H·D);
    ``causal_skip`` schedules only lower-triangular chunk pairs.  The
    causal mask is bottom-right aligned (``k_pos <= q_pos + Sk - Sq``),
    which agrees with :func:`naive_attention` when ``Sq == Sk``.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"flash_attention_xla: chunks ({cq}, {ck}) do not "
                         f"divide the sequence lengths ({Sq}, {Sk})")
    return _FlashAttention.apply(q, k, v, causal, cq, ck, causal_skip)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len) -> torch.Tensor:
    """Single-token attention against a (padded) KV cache.

    q [B,1,H,D]; caches [B,Smax,K,D]; ``cache_len``: the valid prefix
    (including the token just written), a scalar or ``[B]`` (the ragged
    path: one prefix a row).  The softmax over the padded axis is
    masked; a row whose prefix is empty gives zeros.

    Numerics mirror :func:`_flash_fwd_scan` op for op, as the
    reference's do: the scale folded into q in the cache's dtype, the
    scores in float32, ``p`` rounded to v's dtype *before* the
    normalising sum, ``out = pv / l``.  Decode must reproduce the
    prefill path's rounding, or ulp-level drift in the hidden state
    flips near-tied MoE routes and decode leaves teacher forcing.

    The products are grouped by KV head: q is viewed as ``[B, K, H/K,
    D]`` against the cache's K heads, which gives the products of the
    reference's ``repeat_kv`` form (head ``h`` reads KV head ``h //
    (H/K)``) without writing the repeated cache.  Only the one layer's
    cache that is passed in is widened to float32 (a bfloat16 product
    is exact in float32).
    """
    B, _, H, D = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    dtype = k_cache.dtype
    qs = q.to(dtype) * torch.tensor(1.0 / math.sqrt(D), dtype=dtype)
    qg = qs.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.ndim == 1:                      # ragged: per-row valid prefix [B]
        cl = cl[:, None, None, None]
    mask = torch.arange(Smax, device=q.device)[None, None, None, :] < cl
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None]).to(v_cache.dtype)
    p = torch.where(torch.isneginf(s), 0.0, p).to(v_cache.dtype)
    pf = p.float()
    l = pf.sum(dim=-1)
    pv = torch.einsum("bkgs,bskd->bkgd", pf, v_cache.float())
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (pv / l_safe[..., None]).reshape(B, 1, H, D)
    return o.to(q.dtype)


def write_at(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``c[:, pos] = new[:, 0]`` in place, for every row at one scalar
    position, clamped into the cache as ``dynamic_update_slice`` clamps
    its start.  c [B, Smax, ...]; new [B, 1, ...]."""
    idx = pos.clamp(max=c.shape[1] - 1).reshape(1).long()
    c.index_copy_(1, idx, new.to(c.dtype))


def write_rows(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``c[b, pos[b]] = new[b, 0]`` in place, each row at its own
    position.  A row whose position lies past the cache keeps its
    entries, as the reference's scatter drops an out-of-range write (a
    free slot of the serve engine runs on past ``max_len``)."""
    Smax = c.shape[1]
    rows = torch.arange(c.shape[0], device=c.device)
    inside = pos < Smax
    idx = torch.where(inside, pos, Smax - 1).long()
    keep = inside.reshape((-1,) + (1,) * (new.dim() - 2))
    c[rows, idx] = torch.where(keep, new[:, 0].to(c.dtype), c[rows, idx])


def attention_block(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
                    cfg, causal: bool = True) -> torch.Tensor:
    """Full self-attention sublayer (projections + rope + attention)."""
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    q, k, v = _qkv(p, x, H, K, hd, cfg.qk_norm, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections,
                   cfg.use_rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections,
                   cfg.use_rope)
    if cfg.attn_impl == "naive":
        o = naive_attention(q, k, v, causal=causal)
    else:
        o = flash_attention_xla(q, k, v, causal=causal,
                                chunk_q=cfg.attn_chunk_q,
                                chunk_k=cfg.attn_chunk_k,
                                causal_skip=cfg.causal_skip)
    B, S = x.shape[:2]
    return o.reshape(B, S, H * hd) @ p["wo"].to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GeLU)
# ---------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, d: int, ff: int, act: str = "silu",
             device=None) -> Params:
    device = init_device(gen, device)
    p = {"w_up": dense_init(gen, (d, ff), device=device),
         "w_down": dense_init(gen, (ff, d), device=device)}
    if act == "silu":
        p["w_gate"] = dense_init(gen, (d, ff), device=device)
    return p


def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``act="silu"``) or a plain GELU MLP; GELU is the tanh
    form, ``jax.nn.gelu``'s default."""
    up = x @ p["w_up"].to(x.dtype)
    if act == "silu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based scatter dispatch; einsum reference)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, d: int, E: int, ff: int, n_shared: int,
             act: str = "silu", device=None) -> Params:
    """Router ``[d,E]`` and expert weights ``w_up``/``w_gate`` ``[E,d,ff]``,
    ``w_down`` ``[E,ff,d]`` (the reference's keys); ``n_shared`` shared
    experts are one MLP of width ``ff * n_shared`` under ``shared``."""
    device = init_device(gen, device)
    p: Params = {
        "router": dense_init(gen, (d, E), scale=0.02, device=device),
        "w_up": dense_init(gen, (E, d, ff), device=device),
        "w_down": dense_init(gen, (E, ff, d), device=device),
    }
    if act == "silu":
        p["w_gate"] = dense_init(gen, (E, d, ff), device=device)
    if n_shared:
        p["shared"] = init_mlp(gen, d, ff * n_shared, act, device=device)
    return p


def _router(p: Params, x: torch.Tensor, top_k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (gates [...,k], expert_idx [...,k], aux_loss scalar)."""
    logits = x.float() @ p["router"]                          # [..., E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    # Switch-style load-balance loss: E * mean_e(frac_tokens_e * mean_prob_e)
    E = probs.shape[-1]
    onehot = F.one_hot(idx[..., 0], E).float()
    frac = onehot.reshape(-1, E).mean(dim=0)
    mprob = probs.reshape(-1, E).mean(dim=0)
    aux = E * (frac * mprob).sum()
    return gates, idx, aux


def moe_capacity(tokens_per_group: int, E: int, top_k: int,
                 capacity_factor: float) -> int:
    c = int(math.ceil(tokens_per_group * top_k / E * capacity_factor))
    return max(8, -(-c // 8) * 8)          # ≥8 and a multiple of 8


def moe_scatter(p: Params, x: torch.Tensor, *, top_k: int,
                capacity_factor: float, act: str = "silu",
                n_shared: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based MoE with scatter dispatch.

    x: [B, S, d].  Groups are sequences (S > 1) or the whole batch
    (decode).  Assignments beyond an expert's capacity are dropped,
    first come first served.  Returns (y [B,S,d], aux_loss).
    """
    B, S, d = x.shape
    E = p["w_up"].shape[0]
    xg = x.reshape(1, B, d) if S == 1 else x                # [G, T, d]
    G, T, _ = xg.shape
    C = moe_capacity(T, E, top_k, capacity_factor)

    gates, idx, aux = _router(p, xg, top_k)                 # [G,T,k]
    flat_e = idx.reshape(G, T * top_k)                      # [G, Tk]
    gate_flat = gates.reshape(G, T * top_k)
    # position of each assignment within its expert (first come first served)
    onehot = F.one_hot(flat_e, E)                           # [G,Tk,E]
    pos_in_e = ((onehot.cumsum(dim=1) - 1) * onehot).sum(dim=-1)
    keep = pos_in_e < C
    pos_c = torch.where(keep, pos_in_e, C - 1)

    x_rep = xg.repeat_interleave(top_k, dim=1)              # [G,Tk,d]
    x_rep = torch.where(keep[..., None], x_rep, 0)
    gidx = torch.arange(G, device=x.device)[:, None].expand(G, T * top_k)
    buf = torch.zeros((G, E, C, d), dtype=x.dtype, device=x.device)
    buf.index_put_((gidx, flat_e, pos_c), x_rep, accumulate=True)

    out_buf = _expert_ffn(p, buf, act)

    y_tok = out_buf[gidx, flat_e, pos_c]                    # gather back
    y_tok = y_tok * (gate_flat * keep)[..., None].to(x.dtype)
    y = y_tok.reshape(G, T, top_k, d).sum(dim=2)            # combine
    y = y.reshape(B, S, d)
    if n_shared:
        y = y + mlp(p["shared"], x, act)
    return y, aux


def _expert_ffn(p: Params, buf: torch.Tensor, act: str) -> torch.Tensor:
    """Every expert's FFN on its buffer: [G,E,C,d] x [E,d,f] → [G,E,C,d]."""
    up = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(buf.dtype))
    if act == "silu":
        gt = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(buf.dtype))
        h = F.silu(gt) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    return torch.einsum("gecf,efd->gecd", h, p["w_down"].to(buf.dtype))


def moe_einsum(p: Params, x: torch.Tensor, *, top_k: int,
               capacity_factor: float, act: str = "silu",
               n_shared: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference MoE: dense one-hot dispatch/combine einsums (Mesh-TF
    style), the oracle the scatter path is held to.

    O(T·E·C) memory.  The combine weights are float32 (the gates), so,
    as in the reference, a bfloat16 ``x`` gives a float32 ``y``.
    """
    B, S, d = x.shape
    E = p["w_up"].shape[0]
    xg = x.reshape(1, B, d) if S == 1 else x
    G, T, _ = xg.shape
    C = moe_capacity(T, E, top_k, capacity_factor)

    gates, idx, aux = _router(p, xg, top_k)
    # dispatch[g,t,e,c] — position via per-expert cumsum over (t,k) order
    flat_e = idx.reshape(G, T * top_k)
    onehot = F.one_hot(flat_e, E)
    pos = ((onehot.cumsum(dim=1) - 1) * onehot).sum(dim=-1)
    keep = pos < C
    disp = (F.one_hot(flat_e, E).to(xg.dtype)[..., None]
            * F.one_hot(torch.where(keep, pos, C), C + 1).to(
                xg.dtype)[..., None, :-1])                  # [G,Tk,E,C]
    comb = disp * gates.reshape(G, T * top_k)[..., None, None]
    disp = disp.reshape(G, T, top_k, E, C).sum(dim=2)
    comb = comb.reshape(G, T, top_k, E, C).sum(dim=2)

    buf = torch.einsum("gtec,gtd->gecd", disp, xg)
    out_buf = _expert_ffn(p, buf, act)
    y = torch.einsum("gtec,gecd->gtd", comb,
                     out_buf.to(comb.dtype)).reshape(B, S, d)
    if n_shared:
        y = y + mlp(p["shared"], x, act)
    return y, aux


def moe_layer(p: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The config's MoE dispatch (``moe_dispatch``: scatter or einsum).
    The reference's expert-parallel ``moe_shard_map`` needs a mesh,
    which the port does not have yet."""
    fn = moe_scatter if cfg.moe_dispatch == "scatter" else moe_einsum
    return fn(p, x, top_k=cfg.moe_top_k,
              capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
              n_shared=cfg.moe_num_shared)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ---------------------------------------------------------------------------


def init_mamba2(gen: torch.Generator, cfg, device=None) -> Params:
    """Mamba2 weights with the reference's *split* projections (z, x, B,
    C, dt) and convolutions (x, B, C)."""
    device = init_device(gen, device)
    d, di = cfg.d_model, cfg.ssm_d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups

    def w(shape, scale=None):
        return dense_init(gen, shape, scale, device=device)
    return {
        "w_z": w((d, di)),
        "w_x": w((d, di)),
        "w_B": w((d, G * N)),
        "w_C": w((d, G * N)),
        "w_dt": w((d, H)),
        "conv_x": w((cfg.ssm_conv, di), 0.5),
        "conv_B": w((cfg.ssm_conv, G * N), 0.5),
        "conv_C": w((cfg.ssm_conv, G * N), 0.5),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=torch.float32,
                                          device=device)),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=device),
        "norm": init_rmsnorm(di, device),
        "out_proj": w((di, d)),
    }


def causal_conv1d(w: torch.Tensor, x: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via shift-and-sum, then SiLU.  w [k, C];
    x [B, S, C]; ``tail``: [B, k-1, C] carry-in from earlier tokens
    (zeros when None).  Sums in float32; the result has x's dtype."""
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)                # [B, S+k-1, C]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + S].float() * w[i]
    return F.silu(out).to(x.dtype)


def _initial_state(init_state, b, h, p, n, device) -> torch.Tensor:
    if init_state is None:
        return torch.zeros((b, h, p, n), dtype=torch.float32, device=device)
    return init_state.float()


def ssd_reference(x, dt, A, B, C, D, *, init_state=None):
    """Sequential SSD recurrence — the ground-truth oracle.

    x [b,l,h,p]; dt [b,l,h]; A [h] (negative); B,C [b,l,g,n] (g=1); D [h].
    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;  y_t = C_t · h_t + D x_t.
    Returns (y [b,l,h,p], final_state [b,h,p,n]).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    hs = _initial_state(init_state, b, h, p, n, x.device)
    Bf, Cf = B[:, :, 0].float(), C[:, :, 0].float()
    ys = []
    for t in range(l):
        dtt = dt[:, t].float()                              # [b,h]
        dA = torch.exp(dtt * A)
        dBx = torch.einsum("bhp,bn,bh->bhpn", x[:, t].float(), Bf[:, t], dtt)
        hs = hs * dA[..., None, None] + dBx
        ys.append(torch.einsum("bhpn,bn->bhp", hs, Cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else x.new_zeros((b, 0, h, p),
                                                      dtype=torch.float32)
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), hs


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int = 128, init_state=None):
    """Chunked SSD (state-space duality) — the parallel formulation.

    The intra-chunk term is attention-like (quadratic in the chunk
    only); inter-chunk states pass through a short loop over chunks.
    A ragged tail is padded with ``dt = 0`` tokens, which leave the
    state unchanged, and their rows are sliced off.  Returns
    (y, final_state).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    if l % Q:
        pad = Q - l % Q
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        y, hfin = ssd_chunked(x, dt, A, B, C, D, chunk=chunk,
                              init_state=init_state)
        return y[:, :l], hfin
    nc = l // Q
    xf = x.float().reshape(b, nc, Q, h, p)
    dtf = dt.float().reshape(b, nc, Q, h)
    Bf = B[:, :, 0].float().reshape(b, nc, Q, n)
    Cf = C[:, :, 0].float().reshape(b, nc, Q, n)

    a = dtf * A[None, None, None, :]                 # [b,nc,Q,h] (negative)
    a_cs = a.cumsum(dim=2)                           # inclusive
    a_tot = a_cs[:, :, -1]                           # [b,nc,h]

    # intra-chunk: y_q += sum_{k<=q} exp(a_cs_q - a_cs_k) (C_q·B_k) dt_k x_k
    cb = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)     # [b,nc,Q,Q]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    # masked before the exp (the reference masks after it): above the
    # diagonal the exponent is positive and overflows, and the exp's
    # gradient there, inf · 0, is NaN; exp(-inf) = 0 keeps the values
    seg = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]
    decay = torch.exp(seg.masked_fill(~mask[None, None, :, :, None],
                                      _NEG_INF))
    w = cb[..., None] * decay                        # [b,nc,Q,Q,h]
    y_intra = torch.einsum("bcqkh,bckh,bckhp->bcqhp", w, dtf, xf)

    # chunk states: S_c = sum_k exp(a_tot - a_cs_k) dt_k B_k x_k → [b,nc,h,p,n]
    edecay = torch.exp(a_tot[:, :, None, :] - a_cs)  # [b,nc,Q,h]
    states = torch.einsum("bckh,bckh,bckhp,bckn->bchpn", edecay, dtf, xf, Bf)

    hs = _initial_state(init_state, b, h, p, n, x.device)
    h_in = []
    for c in range(nc):                              # state entering chunk c
        h_in.append(hs)
        hs = hs * torch.exp(a_tot[:, c])[:, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                  # [b,nc,h,p,n]

    # inter-chunk: y_q += C_q · h_in * exp(a_cs_q)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cf, torch.exp(a_cs),
                           h_in)
    y = (y_intra + y_inter).reshape(b, l, h, p)
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), hs


def mamba2_block(p: Params, x: torch.Tensor, cfg, *, ssm_state=None,
                 conv_tail=None, return_state: bool = False):
    """Full Mamba2 sublayer.  x [B,S,d] → y [B,S,d]; with
    ``return_state`` also the SSD's final state [B,H,P,N] and the conv
    tails {x,B,C} of [B, k-1, ·] (the inputs' last k-1 tokens before the
    conv).  ``conv_tail``: dict {x,B,C} of carry-ins (or None)."""
    B_, S, d = x.shape
    di, H = cfg.ssm_d_inner, cfg.ssm_heads
    N, G, P = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    z = x @ p["w_z"].to(x.dtype)
    xin = x @ p["w_x"].to(x.dtype)
    Bc = x @ p["w_B"].to(x.dtype)
    Cc = x @ p["w_C"].to(x.dtype)
    dt_raw = x @ p["w_dt"].to(x.dtype)
    km1 = cfg.ssm_conv - 1
    new_tail = ({"x": xin[:, -km1:], "B": Bc[:, -km1:], "C": Cc[:, -km1:]}
                if return_state else None)
    tails = conv_tail or {"x": None, "B": None, "C": None}
    xin = causal_conv1d(p["conv_x"], xin, tail=tails["x"])
    Bc = causal_conv1d(p["conv_B"], Bc, tail=tails["B"])
    Cc = causal_conv1d(p["conv_C"], Cc, tail=tails["C"])

    xh = xin.reshape(B_, S, H, P)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Bm = Bc.reshape(B_, S, G, N)
    Cm = Cc.reshape(B_, S, G, N)
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, p["D"],
                                 chunk=cfg.ssm_chunk, init_state=ssm_state)
    y = y.reshape(B_, S, di)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, final_state, new_tail
    return out


def _conv_decode(w: torch.Tensor, tail: torch.Tensor, new: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token depthwise conv: (out [B,1,C], new_tail [B,k-1,C])."""
    full = torch.cat([tail, new], dim=1)                     # [B,k,C]
    out = F.silu((full.float() * w[None]).sum(dim=1, keepdim=True))
    return out.to(new.dtype), full[:, 1:]


def mamba2_decode_step(p: Params, x: torch.Tensor, cfg, *,
                       ssm_state: torch.Tensor,
                       conv_tail: Dict[str, torch.Tensor]):
    """Single-token recurrent update.  x [B,1,d] → (y [B,1,d], the new
    state [B,H,P,N] in float32, the new conv tails {x,B,C})."""
    B_, _, d = x.shape
    di, H = cfg.ssm_d_inner, cfg.ssm_heads
    N, G, P = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    z = x @ p["w_z"].to(x.dtype)
    dt_raw = x @ p["w_dt"].to(x.dtype)
    xin, tail_x = _conv_decode(p["conv_x"], conv_tail["x"],
                               x @ p["w_x"].to(x.dtype))
    Bc, tail_B = _conv_decode(p["conv_B"], conv_tail["B"],
                              x @ p["w_B"].to(x.dtype))
    Cc, tail_C = _conv_decode(p["conv_C"], conv_tail["C"],
                              x @ p["w_C"].to(x.dtype))
    new_tail = {"x": tail_x, "B": tail_B, "C": tail_C}

    xh = xin.reshape(B_, H, P)
    dt = F.softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Bm = Bc.reshape(B_, G, N)[:, 0]
    Cm = Cc.reshape(B_, G, N)[:, 0]
    dA = torch.exp(dt * A)                                   # [B,H]
    dBx = torch.einsum("bhp,bn,bh->bhpn", xh.float(), Bm.float(), dt)
    hnew = ssm_state.float() * dA[..., None, None] + dBx
    y = torch.einsum("bhpn,bn->bhp", hnew, Cm.float())
    y = y + xh.float() * p["D"][None, :, None]
    y = y.reshape(B_, 1, di).to(x.dtype)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = y @ p["out_proj"].to(x.dtype)
    return out, hnew, new_tail


# ---------------------------------------------------------------------------
# embedding / unembedding / loss
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, V: int, d: int, device=None) -> Params:
    return {"table": embed_init(gen, (V, d), device=device)}


def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table (tokens must lie in ``[0, V)``: the reference's
    ``jnp.take`` would clamp, torch raises), cast to ``dtype``."""
    return F.embedding(tokens, p["table"]).to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor, dtype) -> torch.Tensor:
    """Logits in x's dtype (a bfloat16 forward rounds them to bfloat16),
    then cast to ``dtype``."""
    return (x @ table.t().to(x.dtype)).to(dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL.  logits [B,S,V] (any float dtype), labels [B,S]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def chunked_loss(table: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int, logits_dtype) -> torch.Tensor:
    """Cross-entropy without materializing [B,S,V]: a loop over S chunks
    (``chunk`` ≤ 0 or ≥ S: one pass)."""
    B, S, d = x.shape
    if chunk <= 0 or S <= chunk:
        return cross_entropy(unembed(table, x, logits_dtype), labels)
    if S % chunk:
        raise ValueError(f"chunked_loss: chunk {chunk} does not divide the "
                         f"sequence length {S}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        lf = unembed(table, x[:, sl], logits_dtype).float()
        gold = lf.gather(-1, labels[:, sl].long()[..., None])[..., 0]
        tot = tot + (torch.logsumexp(lf, dim=-1) - gold).sum()
    return tot / (B * S)


def next_token_labels(batch: Dict[str, Any]) -> torch.Tensor:
    """``batch["labels"]``, else the tokens shifted left by one with the
    last token repeated (the reference's default)."""
    labels = batch.get("labels")
    if labels is None:
        tokens = batch["tokens"]
        labels = torch.cat([tokens[:, 1:], tokens[:, -1:]], dim=1)
    return labels


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``, ``"float32"``) as a torch
    dtype."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"not a torch dtype: {name!r}")
    return dtype
