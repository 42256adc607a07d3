"""Neural building blocks — the PyTorch port of ``repro.models.layers``.

The forward path of the model zoo: norms (:func:`rms_norm`,
:func:`layer_norm`), rotary embeddings with M-RoPE, GQA attention
(:func:`naive_attention`, the oracle, and :func:`flash_attention_xla`,
the chunked online-softmax formulation with a recompute backward, which
on the card takes the hand-written flash kernels for bf16), the
SwiGLU/GELU MLP, capacity-based MoE (scatter dispatch and the one-hot
einsum oracle, with shared experts; the expert-parallel
:func:`moe_shard_map` under a mesh) and the dropless :func:`moe_held`
over the experts one device holds, the Mamba2 block on the SSD scans
(:func:`ssd_reference`, :func:`ssd_chunked`), and the embedding, the
unembedding and the (chunked) cross-entropy; and the decode path
(:func:`decode_attention` over a padded KV cache, :func:`mamba2_decode_step`
with :func:`_conv_decode`); and :func:`maybe_remat`, the per-layer
rematerialization the families apply under grad.

Conventions are the reference's: parameters are plain dicts of float32
tensors made by the matching ``init_*`` functions (from an explicit
``torch.Generator``, on its device unless ``device`` is given; the
``meta`` device gives the tree's shapes without data), activations
``[B, S, ...]``, attention heads ``[B, S, H, D]`` with ``K`` kv heads
(``H % K == 0``).  Weights are cast to the activations' dtype at each
product (``x @ w.to(x.dtype)``), so a bfloat16 forward rounds every
product to bfloat16 where the reference does.  The reference's
``constrain`` sharding annotations stand at its sites (q/k/v, the
attention scores, the MLP, the experts' buffers, the Mamba2
projections); they act only on DTensors under bound logical
rules (``repro_torch.distributed.logical``), so a plain forward is
unchanged.  Under rules the regions that sharding propagation cannot
carry run on each rank's shards (``logical.local``): the attention
(heads on 'model', the GQA kv heads each rank's q heads read), the
decode attention over a sequence-sharded cache (the flash-decode
combine), the prompt's and the decode's cache writes, the
vocabulary-parallel cross-entropy, the SSD scan and the convolutions,
and the MoE layer (:func:`moe_shard_map`: each rank its own experts, or
batch-sharded with every expert gathered where the experts do not
split over the mesh).  JAX's ``lax.scan`` loops become
Python loops; products that the
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

from repro_torch.distributed.logical import (Placed, active_rules,
                                             constrain, is_dtensor, local,
                                             mesh_coordinate, mesh_copy,
                                             mesh_mean, mesh_reduce,
                                             mesh_size, mesh_sum, sharded,
                                             spec_of)
from repro_torch.kernels.decode_attention import ops as decode_kernel
from repro_torch.models import tracing
from repro_torch.models.tracing import repeated, traced_source

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


def _scalar(value: float, like: torch.Tensor) -> float:
    """``value`` rounded to ``like``'s dtype on the host, as a Python
    float: a product with it has the bits of one with a 0-d tensor of
    that dtype, launches nothing to make it, and traces as a constant."""
    return float(torch.tensor(value, dtype=like.dtype))


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


@traced_source
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


@traced_source
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


def token_positions(tokens: torch.Tensor) -> torch.Tensor:
    """``[B, S]`` positions 0..S-1 of every row of ``tokens`` (under
    logical rules, each rank's rows)."""
    return local(lambda t: torch.arange(t.shape[1], device=t.device)[
        None].expand(t.shape[0], t.shape[1]),
        [("batch", None)], ("batch", None))(tokens)


def rope_freqs(hd: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                         device=device) / hd))


@traced_source
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
        sec_id = torch.tensor([i for i, n in enumerate(mrope_sections)
                               for _ in range(n)], device=x.device)
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


@traced_source
def _qkv(p: Params, x: torch.Tensor, H: int, K: int, hd: int,
         qk_norm: bool, eps: float
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    B, S, _ = x.shape
    q = constrain((x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd),
                  "batch", None, "heads", None)
    k = constrain((x @ p["wk"].to(x.dtype)).reshape(B, S, K, hd),
                  "batch", None, "kv_heads", None)
    v = constrain((x @ p["wv"].to(x.dtype)).reshape(B, S, K, hd),
                  "batch", None, "kv_heads", None)
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


@traced_source
def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset=0,
                    kv_len=None) -> torch.Tensor:
    """Reference attention, GQA-aware.  q [B,Sq,H,D], k/v [B,Sk,K,D].

    ``q_offset``: absolute position of q[0] (for decode: cache length);
    the causal mask is ``k_pos <= q_pos``.  ``kv_len``: valid prefix
    length of k/v (the rest is padding to ignore).  Fully masked rows
    give zeros.  Under logical rules each rank attends with its own
    heads (:func:`heads_local`).
    """
    if sharded(q):
        return heads_local(lambda q_, k_, v_: naive_attention(
            q_, k_, v_, causal, q_offset, kv_len), q, k, v)
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    kr = repeat_kv(k, H).float()
    vr = repeat_kv(v, H).float()
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), kr) / math.sqrt(D)
    s = constrain(s, "batch", "heads", None, None)
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


def _flash_kernels():
    """The flash kernels' wrapper, imported at the call: it imports this
    module."""
    from repro_torch.kernels.flash_attention import ops
    return ops


@traced_source
def _flash_fwd_scan(q, k, v, causal, cq, ck, causal_skip, need_lse=True):
    """Online softmax over chunk pairs.  q [B,Sq,H,D]; k/v [B,Sk,K,D].

    Where the operands show the card's bf16 kernels can take them
    (``kernels.flash_attention.ops.takes_kernels``: CUDA bf16, head size
    64 or 128, Sq == Sk under the causal mask) the ``wgmma`` kernel runs
    instead, GQA-native, and returns (out in q's dtype, lse or None
    without ``need_lse``); counter ``flash.kernel`` reads 1, else 0.

    Otherwise the plain scan, :func:`_flash_fwd_plain`.
    """
    kernels = _flash_kernels()
    if kernels.takes_kernels(q, k, v, causal):
        tracing.count("flash.kernel", 1)
        return kernels.attention_fwd(q, k, v, causal, need_lse)
    tracing.count("flash.kernel", 0)
    return _flash_fwd_plain(q, k, v, causal, cq, ck, causal_skip)


def _flash_fwd_plain(q, k, v, causal, cq, ck, causal_skip):
    """The plain scan over ``repeat_kv``'d k and v: off-diagonal pairs
    run first without a mask, then the diagonal pairs with it, as in the
    reference.  The softmax scale is folded into q once, in q's dtype.
    ``p`` is cast to v's dtype before the PV product, as the reference
    feeds bfloat16 p to the MXU.  Returns (out float32 [B,Sq,H,D], lse
    [B,H,Sq])."""
    B, Sq, H, D = q.shape
    kr, vr = repeat_kv(k, H), repeat_kv(v, H)
    Sk = kr.shape[1]
    qs = q * _scalar(1.0 / math.sqrt(D), q)
    m = torch.full((B, H, Sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)

    def body(i, j, masked):
        iq, jk = slice(i * cq, i * cq + cq), slice(j * ck, j * ck + ck)
        vc = vr[:, jk]
        s = torch.einsum("bqhd,bshd->bhqs", qs[:, iq].float(),
                         kr[:, jk].float())
        s = constrain(s, "batch", "heads", None, None)
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
    for i, j in repeated(offd):
        body(i, j, masked=False)
    for i, j in repeated(diag):
        body(i, j, masked=causal)
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe[..., None]).permute(0, 2, 1, 3)   # → [B,Sq,H,D]
    lse = torch.where(l > 0.0, m + torch.log(l_safe), float("inf"))
    return out, lse


def _flash_fwd(q, k, v, causal, cq, ck, causal_skip, need_lse=True):
    out, lse = _flash_fwd_scan(q, k, v, causal, cq, ck, causal_skip,
                               need_lse)
    return out.to(q.dtype), lse


@traced_source
def _flash_bwd_scan(q, k, v, out, lse, dout, causal, cq, ck, causal_skip):
    """Recompute-based flash backward (no saved per-pair history).

    Dispatched as :func:`_flash_fwd_scan`: on the card's bf16 kernels
    (a delta pass, then dK/dV and dQ kernels with no atomics; counter
    ``flash.kernel`` 1), else the plain scan :func:`_flash_bwd_plain`
    (0)."""
    kernels = _flash_kernels()
    if kernels.takes_kernels(q, k, v, causal):
        tracing.count("flash.kernel", 1)
        return kernels.attention_bwd(q, k, v, out, lse, dout, causal)
    tracing.count("flash.kernel", 0)
    return _flash_bwd_plain(q, k, v, out, lse, dout, causal, cq, ck,
                            causal_skip)


def _flash_bwd_plain(q, k, v, out, lse, dout, causal, cq, ck, causal_skip):
    """The plain scan's backward over ``repeat_kv``'d k and v, its
    gradients folded back to the kv heads."""
    B, Sq, H, D = q.shape
    kr, vr = repeat_kv(k, H), repeat_kv(v, H)
    Sk = kr.shape[1]
    K = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    # the scale is folded into the small [.,S,H,D] tensors once:
    #   s = (q·scale)·k ;  ds = p·(do'·v − δ') with do' = do·scale
    qs = q * _scalar(scale, q)
    dos = dout * _scalar(scale, dout)
    # delta'_i = rowsum(do'_i * out_i)  [B,H,Sq]
    delta = torch.einsum("bqhd,bqhd->bhq", dos.float(), out.float())
    dq = torch.zeros((B, Sq, H, D), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, Sk, H, D), dtype=torch.float32, device=q.device)

    def body(i, j, masked):
        iq, jk = slice(i * cq, i * cq + cq), slice(j * ck, j * ck + ck)
        kc, doc = kr[:, jk], dout[:, iq]
        s = torch.einsum("bqhd,bshd->bhqs", qs[:, iq].float(), kc.float())
        s = constrain(s, "batch", "heads", None, None)
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
    for i, j in repeated(offd):
        body(i, j, masked=False)
    for i, j in repeated(diag):
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
    def forward(ctx, q, k, v, causal, cq, ck, causal_skip, need_lse):
        out, lse = _flash_fwd(q, k, v, causal, cq, ck, causal_skip,
                              need_lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.schedule = (causal, cq, ck, causal_skip)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_scan(q, k, v, out, lse, dout.contiguous(),
                                     *ctx.schedule)
        return dq, dk, dv, None, None, None, None, None


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

    On the card, bfloat16 operands with a head size of 64 or 128 (and
    ``Sq == Sk`` under the causal mask) take the hand-written kernels
    instead, forward and backward (:func:`_flash_fwd_scan`); the forward
    then writes the log-sum-exp only when a gradient will be taken.
    ``chunk_q``, ``chunk_k`` and ``causal_skip`` steer the plain scans
    alone (the kernels' tiles are their own), and every other input
    (CPU tensors, float32, other head sizes) takes those scans.
    """
    Sq, Sk = q.shape[1], k.shape[1]
    cq, ck = min(chunk_q, Sq), min(chunk_k, Sk)
    if Sq % cq or Sk % ck:
        raise ValueError(f"flash_attention_xla: chunks ({cq}, {ck}) do not "
                         f"divide the sequence lengths ({Sq}, {Sk})")
    need_lse = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    if sharded(q):
        return heads_local(lambda q_, k_, v_: _FlashAttention.apply(
            q_, k_, v_, causal, cq, ck, causal_skip, need_lse), q, k, v)
    return _FlashAttention.apply(q, k, v, causal, cq, ck, causal_skip,
                                 need_lse)


def heads_local(fn: Callable, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor) -> torch.Tensor:
    """``fn(q, k, v)`` on each rank's heads under logical rules.

    q [B,S,H,D] is split by "batch" and "heads", k/v [B,S,K,D] by
    "batch" and "kv_heads".  When the q heads are split but the kv heads
    are not (GQA with K below the 'model' axis: the kv projections are
    replicated), each rank takes the kv heads its q heads read, as the
    reference's Megatron treatment does, so ``fn`` sees H/m q heads
    over the matching kv heads; their gradients are each rank's part
    and are summed over 'model'."""
    rules = active_rules()
    H, K = q.shape[2], k.shape[2]
    qa = ("batch", None, "heads", None)
    if rules.get("heads") is None or rules.get("kv_heads") is not None \
            or K == H:
        kva = ("batch", None, "kv_heads", None)
        return local(fn, [qa, kva, kva], qa)(q, k, v)
    G = H // K

    def own_heads(q_, k_, v_):
        hl = q_.shape[2]
        first = mesh_coordinate(rules["heads"]) * hl
        lo, hi = first // G, (first + hl - 1) // G + 1     # a run of heads
        return fn(q_, k_.narrow(2, lo, hi - lo), v_.narrow(2, lo, hi - lo))
    kva = ("batch", None, None, None)
    return local(own_heads, [qa, kva, kva], qa)(q, k, v)


@traced_source
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
    (H/K)``) without writing the repeated cache.  On the CPU only the one
    layer's cache that is passed in is widened to float32 (a bfloat16
    product is exact in float32); a CUDA tensor takes the split-KV kernel
    (``repro_torch.kernels.decode_attention``), which reads each row's
    live prefix once in the cache's dtype and follows these numerics tile
    by tile.
    """
    if sharded(k_cache):
        return _decode_attention_sharded(q, k_cache, v_cache, cache_len)
    return _decode_attention(q, k_cache, v_cache, cache_len)


def _decode_attention(q, k_cache, v_cache, cache_len, first: int = 0,
                      seq_axis=None) -> torch.Tensor:
    """:func:`decode_attention` on one rank's cache positions ``first``
    onward; with ``seq_axis`` (under rules: the mesh axes that split the
    cache's positions) the ranks combine their softmax parts, as flash
    decoding does.  A CUDA tensor takes the hand-written kernel
    (:func:`_decode_attention_kernel`), a CPU tensor the plain form
    (:func:`_decode_attention_plain`)."""
    if q.device.type == "cuda":
        return _decode_attention_kernel(q, k_cache, v_cache, cache_len,
                                        first, seq_axis)
    return _decode_attention_plain(q, k_cache, v_cache, cache_len, first,
                                   seq_axis)


def _decode_attention_plain(q, k_cache, v_cache, cache_len, first: int = 0,
                            seq_axis=None) -> torch.Tensor:
    """:func:`_decode_attention` in plain torch ops: the whole padded cache
    widened to float32, masked past each row's prefix."""
    B, _, H, D = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    dtype = k_cache.dtype
    qs = q.to(dtype) * _scalar(1.0 / math.sqrt(D), k_cache)
    qg = qs.reshape(B, K, G, D).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    s = constrain(s, "batch", "heads", None, None)
    cl = torch.as_tensor(cache_len, device=q.device)
    if cl.ndim == 1:                      # ragged: per-row valid prefix [B]
        cl = cl[:, None, None, None]
    k_pos = torch.arange(first, first + Smax, device=q.device)
    mask = k_pos[None, None, None, :] < cl
    s = torch.where(mask, s, _NEG_INF)
    m = mesh_reduce(s.amax(dim=-1), "max", seq_axis)
    m_safe = torch.where(torch.isneginf(m), 0.0, m)
    p = torch.exp(s - m_safe[..., None]).to(v_cache.dtype)
    p = torch.where(torch.isneginf(s), 0.0, p).to(v_cache.dtype)
    pf = p.float()
    l = mesh_reduce(pf.sum(dim=-1), "sum", seq_axis)
    pv = mesh_reduce(torch.einsum("bkgs,bskd->bkgd", pf, v_cache.float()),
                     "sum", seq_axis)
    l_safe = torch.where(l == 0.0, 1.0, l)
    o = (pv / l_safe[..., None]).reshape(B, 1, H, D)
    return o.to(q.dtype)


def _decode_attention_kernel(q, k_cache, v_cache, cache_len, first: int,
                             seq_axis) -> torch.Tensor:
    """:func:`_decode_attention` through the split-KV kernel
    (``repro_torch.kernels.decode_attention``), which reads each row's
    prefix once in the cache's dtype.  With ``seq_axis`` the kernel gives
    this rank's merged ``(m, l, acc)`` and the ranks combine them: the
    max of ``m``, each rank's ``l`` and ``acc`` rescaled by ``exp(m_rank
    - m)`` and summed, then ``acc / l`` (0 where ``l`` is 0)."""
    if seq_axis is None:
        return decode_kernel.decode_attention(q, k_cache, v_cache, cache_len,
                                              first=first)
    m, l, acc = decode_kernel.decode_attention_partials(
        q, k_cache, v_cache, cache_len, first=first)
    m_all = mesh_reduce(m, "max", seq_axis)
    w = torch.where(torch.isneginf(m), 0.0, torch.exp(
        m - torch.where(torch.isneginf(m_all), 0.0, m_all)))
    l = mesh_reduce(l * w, "sum", seq_axis)
    pv = mesh_reduce(acc * w[..., None], "sum", seq_axis)
    l_safe = torch.where(l == 0.0, 1.0, l)
    B, _, H, D = q.shape
    return (pv / l_safe[..., None]).reshape(B, 1, H, D).to(q.dtype)


def _split_axes(t, dim: int):
    """The mesh axes (outer first) over which a ``DTensor``'s ``dim`` is
    split, or None."""
    names = tuple(n for n, p in zip(t.device_mesh.mesh_dim_names,
                                    t.placements)
                  if p.is_shard() and p.dim == dim % t.ndim)
    return names or None


def _decode_attention_sharded(q, k_cache, v_cache, cache_len):
    """Decode attention on each rank's part of the cache.  A cache split
    by kv heads takes the q heads that read them; one split by position
    (GQA with K below the 'model' axis) takes every q head, and the
    ranks combine their softmax parts over the positions (flash
    decoding); the cache's placements are kept, so no rank gathers it."""
    seq = _split_axes(k_cache, 1)
    heads = "heads" if _split_axes(k_cache, 2) else None
    qa = ("batch", None, heads, None)

    def attend(q_, k_, v_, cl_):
        first = mesh_coordinate(seq) * k_.shape[1] if seq else 0
        return _decode_attention(q_, k_, v_, cl_, first, seq)
    cla = ("batch",) if getattr(cache_len, "ndim", 0) == 1 else None
    return local(attend, [qa, None, None, cla], qa)(
        q, k_cache, v_cache, cache_len)


@traced_source
def write_at(c: torch.Tensor, new: torch.Tensor, pos: torch.Tensor) -> None:
    """``c[:, pos] = new[:, 0]`` in place, for every row at one scalar
    position, clamped into the cache as ``dynamic_update_slice`` clamps
    its start.  c [B, Smax, ...]; new [B, 1, ...]."""
    if sharded(c):
        return _write_at_sharded(c, new, pos)
    idx = pos.clamp(max=c.shape[1] - 1).reshape(1).long()
    c.index_copy_(1, idx, new.to(c.dtype))


def _write_at_sharded(c, new, pos) -> None:
    """:func:`write_at` into a ``DTensor`` cache, in place on each
    rank's shard: ``new`` is laid out as the cache but for positions,
    and a cache split by position is written only by the rank that
    holds ``pos`` (the others keep their rows)."""
    from torch.distributed.tensor import Replicate
    seq = _split_axes(c, 1)
    want = [Replicate() if (p.is_shard() and p.dim == 1) else p
            for p in c.placements]
    new_l = new.redistribute(c.device_mesh, want).to_local()
    pos_l = pos.to_local() if is_dtensor(pos) else pos
    c_l = c.to_local()
    sl = c_l.shape[1]
    idx = pos_l.clamp(max=c.shape[1] - 1) - mesh_coordinate(seq) * sl
    inside = (idx >= 0) & (idx < sl)
    idx = idx.clamp(0, sl - 1).reshape(1).long()
    old = c_l.index_select(1, idx)
    c_l.index_copy_(1, idx, torch.where(inside, new_l.to(c.dtype), old))


@traced_source
def write_prefix(c: torch.Tensor, new: torch.Tensor) -> None:
    """``c[:, :, :S] = new`` in place, ``S = new.shape[2]``: a prompt's
    keys or values [L, B, S, ...] into a cache [L, B, Smax, ...].  Into
    a ``DTensor`` cache each rank writes its shard: ``new`` is laid out
    as the cache but for positions, and a cache split by position takes
    from each rank only the positions it holds (a slice assignment
    would write a gathered copy, not the shards)."""
    if not sharded(c):
        c[:, :, :new.shape[2]] = new
        return
    from torch.distributed.tensor import Replicate
    seq = _split_axes(c, 2)
    want = [Replicate() if (p.is_shard() and p.dim == 2) else p
            for p in c.placements]
    new_l = new.redistribute(c.device_mesh, want).to_local()
    c_l = c.to_local()
    first = mesh_coordinate(seq) * c_l.shape[2]
    n = min(new.shape[2] - first, c_l.shape[2])
    if n > 0:
        c_l[:, :, :n] = new_l[:, :, first:first + n]


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
    return out_proj(o.reshape(B, S, H * hd), p["wo"])


@traced_source
def out_proj(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A sublayer's output projection ``y @ w`` in y's dtype.  Under
    logical rules a y split over its last dim (the heads, the inner
    channels) meets w's rows split alike, and the ranks' partial
    products are summed here (Megatron's row-parallel product), so the
    residual stream leaves replicated over 'model'.  A y that arrives
    whole (the flash-decode attention's output) is split to meet w's
    rows where the partial products' sum moves fewer bytes than
    gathering w would."""
    if not sharded(y):
        return y @ w.to(y.dtype)
    from torch.distributed.tensor import Replicate, Shard
    red = _split_axes(y, -1)
    rows = _split_axes(w, 0)
    if red is None and rows is not None:
        out = y.to_local().numel() // y.shape[-1] * w.shape[-1]
        if out < w.to_local().numel():
            y = y.redistribute(y.device_mesh, [
                Shard(y.ndim - 1) if n in rows else p for n, p in
                zip(y.device_mesh.mesh_dim_names, y.placements)])
            red = rows
    names = y.device_mesh.mesh_dim_names
    w_pl = [Shard(0) if red and n in red else Replicate() for n in names]
    out_pl = [Replicate() if red and n in red else p
              for n, p in zip(names, y.placements)]
    return local(lambda y_, w_: mesh_sum(y_ @ w_.to(y_.dtype), red),
                 [None, None], Placed(out_pl))(
        y, w.redistribute(y.device_mesh, w_pl))


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


@traced_source
def mlp(p: Params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    """SwiGLU (``act="silu"``) or a plain GELU MLP; GELU is the tanh
    form, ``jax.nn.gelu``'s default."""
    up = constrain(x @ p["w_up"].to(x.dtype), "batch", None, "ff")
    if act == "silu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return constrain(out_proj(h, p["w_down"]), "batch", None, None)


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based scatter dispatch; einsum reference)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, d: int, E: int, ff: int, n_shared: int,
             act: str = "silu", device=None, held: int = 0) -> Params:
    """Router ``[d,E]`` and expert weights ``w_up``/``w_gate`` ``[E,d,ff]``,
    ``w_down`` ``[E,ff,d]`` (the reference's keys); ``n_shared`` shared
    experts are one MLP of width ``ff * n_shared`` under ``shared``.
    ``held`` (0: all E): only experts ``[0, held)`` have weights here,
    the router still scores all E (:func:`moe_held`)."""
    device = init_device(gen, device)
    n = held or E
    p: Params = {
        "router": dense_init(gen, (d, E), scale=0.02, device=device),
        "w_up": dense_init(gen, (n, d, ff), device=device),
        "w_down": dense_init(gen, (n, ff, d), device=device),
    }
    if act == "silu":
        p["w_gate"] = dense_init(gen, (n, d, ff), device=device)
    if n_shared:
        p["shared"] = init_mlp(gen, d, ff * n_shared, act, device=device)
    return p


def _router(p: Params, x: torch.Tensor, top_k: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Return (gates [...,k], expert_idx [...,k], aux_loss scalar)."""
    gates, idx, probs = _route(p, x, top_k)
    return gates, idx, _balance_loss(*_balance_stats(idx, probs))


def _route(p: Params, x: torch.Tensor, top_k: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(gates [...,k] renormalized, expert_idx [...,k], probs [...,E])."""
    logits = x.float() @ p["router"]                          # [..., E]
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, top_k, dim=-1)
    return gates / gates.sum(dim=-1, keepdim=True), idx, probs


def _balance_stats(idx: torch.Tensor, probs: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per expert, the share of tokens whose first choice it is and its
    mean router probability (each [E])."""
    E = probs.shape[-1]
    onehot = F.one_hot(idx[..., 0], E).float()
    return onehot.reshape(-1, E).mean(dim=0), probs.reshape(-1, E).mean(dim=0)


def _balance_loss(frac: torch.Tensor, mprob: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e(frac_e * mean_prob_e)."""
    return frac.shape[-1] * (frac * mprob).sum()


@traced_source
def moe_held(p: Params, x: torch.Tensor, cfg
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless MoE over the experts this device holds.

    Every token is routed over all ``moe_num_experts`` (:func:`_route`);
    the assignments to a held expert (``p["w_up"]`` has ``held`` of
    them: experts ``[0, held)``) are all kept, with no capacity, sorted
    by expert, and each expert's SwiGLU runs as 2-D products on its own
    rows.  The outputs, scaled by their gates, are summed back onto
    their tokens (``index_put`` with ``accumulate``: a token's held
    assignments in expert order), and the shared expert is added once.
    What the experts not held here would add is left out: that is
    another device's part.  The aux loss is over all E router outputs.
    The experts' row counts are read on the host, once a call.  ``x``
    may be wider than the config's ``dtype`` (a float32 residual
    stream): the router scores it as it is, the experts' products run
    in ``dtype``, and the gated sum and ``y`` keep ``x``'s dtype.
    Returns (y [B,S,d], aux_loss)."""
    B, S, d = x.shape
    E, k = cfg.moe_num_experts, cfg.moe_top_k
    held = p["w_up"].shape[0]
    cd = dtype_of(cfg.dtype)
    xt = x.reshape(B * S, d)
    gates, idx, probs = _route(p, xt, k)                    # [T,k], [T,E]
    aux = _balance_loss(*_balance_stats(idx, probs))
    flat_e = idx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)              # by expert
    counts = torch.bincount(flat_e, minlength=E)[:held].tolist()
    n = sum(counts)
    tracing.count("moe.held_assignments", n)
    if n:
        tracing.count("moe.held_load_max", max(counts) * held / n)
    a = order[:n]                                           # held, by expert
    tok = a // k
    rows = xt[tok].to(cd)
    outs = []
    for e, r in enumerate(rows.split(counts)):
        if not counts[e]:
            continue
        h = F.silu(r @ p["w_gate"][e].to(r.dtype)) * (r @ p["w_up"][e].to(
            r.dtype))
        outs.append(h @ p["w_down"][e].to(r.dtype))
    y = torch.zeros_like(xt)
    if outs:
        ya = torch.cat(outs).to(x.dtype) * gates.reshape(-1)[a][:, None].to(
            x.dtype)
        y = y.index_put((tok,), ya, accumulate=True)
    y = y.reshape(B, S, d)
    if cfg.moe_num_shared:
        y = y + mlp(p["shared"], x.to(cd), cfg.act)
    return y, aux


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
    buf = constrain(buf, None, "experts", None, None)

    out_buf = constrain(_expert_ffn(p, buf, act), None, "experts", None, None)

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


@traced_source
def moe_shard_map(p: Params, x: torch.Tensor, cfg, rules
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE: the reference's ``moe_shard_map``, in a
    :func:`~repro_torch.distributed.logical.local` region.

    Each rank of the ``experts`` axis owns E/|axis| experts
    (``w_up``/``w_gate``/``w_down`` sharded over it).  Activations are
    batch-sharded (replicated when the batch does not divide), so every
    rank routes all of its tokens, scatters only the assignments that
    target one of its experts into a ``[G, E_loc, C, d]`` buffer, runs
    its experts, and the ranks' partial outputs are summed over the
    axis (``mesh_sum``).  The position within an expert is counted over
    the global expert id, so every rank agrees on the capacity drops;
    capacity comes from the rank's own T (decode: its batch is one
    group).  The dispatch reads x and the router through ``mesh_copy``,
    so their gradients are summed over the axis.  The aux loss is the
    batch's (:func:`_balanced_aux`; the reference returns the first
    batch shard's, ``ROADMAP.md`` queue 3).  Shared experts are added
    outside the region."""
    ep_axis = rules["experts"]
    E = p["w_up"].shape[0]
    E_loc = E // mesh_size(ep_axis)
    top_k = cfg.moe_top_k
    keys = [k for k in ("router", "w_up", "w_gate", "w_down") if k in p]

    def local_fn(x_loc, *ws):
        w = dict(zip(keys, ws))
        B, S, d = x_loc.shape
        xg = x_loc.reshape(1, B, d) if S == 1 else x_loc    # [G, T, d]
        G, T, _ = xg.shape
        C = moe_capacity(T, E, top_k, cfg.moe_capacity_factor)
        stats = _balance_stats(*_route(w, xg, top_k)[1:])
        xc = mesh_copy(xg, ep_axis)
        gates, idx, _ = _route({"router": mesh_copy(w["router"], ep_axis)},
                               xc, top_k)
        flat_g = idx.reshape(G, T * top_k)                  # global ids
        flat_e = flat_g - mesh_coordinate(ep_axis) * E_loc  # local ids
        gate_flat = gates.reshape(G, T * top_k)
        onehot = F.one_hot(flat_g, E)
        pos = ((onehot.cumsum(dim=1) - 1) * onehot).sum(dim=-1)
        keep = (pos < C) & (flat_e >= 0) & (flat_e < E_loc)
        e_c = torch.where(keep, flat_e, 0)
        pos_c = torch.where(keep, pos, C - 1)
        x_rep = torch.where(keep[..., None],
                            xc.repeat_interleave(top_k, dim=1), 0)
        gidx = torch.arange(G, device=xg.device)[:, None].expand(
            G, T * top_k)
        buf = torch.zeros((G, E_loc, C, d), dtype=xg.dtype, device=xg.device)
        buf = buf.index_put((gidx, e_c, pos_c), x_rep, accumulate=True)
        out_buf = _expert_ffn(w, buf, cfg.act)
        y_tok = out_buf[gidx, e_c, pos_c]
        y_tok = y_tok * (gate_flat * keep)[..., None].to(xg.dtype)
        y = y_tok.reshape(G, T, top_k, d).sum(dim=2)
        return (mesh_sum(y, ep_axis).reshape(B, S, d),) + stats

    w_axes = [(None, None) if k == "router" else ("experts", None, None)
              for k in keys]
    y, aux = _balanced_aux(local_fn, x, [p[k] for k in keys], w_axes, rules)
    if cfg.moe_num_shared:
        y = y + mlp(p["shared"], x, cfg.act)
    return y, aux


def _balanced_aux(fn, x, weights, w_axes, rules):
    """``(y, aux)`` of ``fn(x, *weights) → (y, frac, mprob)`` run in a
    ``local`` region on batch-sharded x: the load-balance statistics are
    averaged over the batch axes that split x (equal shards), so the aux
    loss is the whole batch's, as one device computes it."""
    x_axes = ("batch", None, None)
    y, frac, mprob = local(fn, [x_axes] + w_axes,
                           [x_axes, (None,), (None,)])(x, *weights)
    if spec_of(x_axes, rules, x.shape)[0] is not None:
        frac = mesh_mean(frac, rules["batch"])
        mprob = mesh_mean(mprob, rules["batch"])
    return y, _balance_loss(frac, mprob)


@traced_source
def moe_layer(p: Params, x: torch.Tensor, cfg
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The config's MoE dispatch (``moe_dispatch``: scatter, einsum, or
    :func:`moe_held`'s dropless one over the held experts).

    Under logical rules on a mesh, the reference's choice: the
    expert-parallel :func:`moe_shard_map` when ``experts`` is bound to
    an axis that divides E and the dispatch is scatter; otherwise the
    layer runs on each rank's batch rows with every expert's weights
    gathered.  Either way the aux loss is the whole batch's."""
    if cfg.moe_dispatch == "dropless":
        if sharded(x):
            raise NotImplementedError(
                "moe_layer: dropless dispatch runs on one device's held "
                "experts; under logical rules use scatter")
        return moe_held(p, x, cfg)
    fn = moe_scatter if cfg.moe_dispatch == "scatter" else moe_einsum

    def run(p_, x_):
        return fn(p_, x_, top_k=cfg.moe_top_k,
                  capacity_factor=cfg.moe_capacity_factor, act=cfg.act,
                  n_shared=cfg.moe_num_shared)
    if not sharded(x):
        return run(p, x)
    rules = active_rules()
    ep_axis = rules.get("experts")
    if (isinstance(ep_axis, str) and cfg.moe_dispatch == "scatter"
            and p["w_up"].shape[0] % mesh_size(ep_axis) == 0):
        return moe_shard_map(p, x, cfg, rules)
    from . import tree
    leaves = tree.flatten(p)

    def gathered(x_, *w):
        pw = tree.unflatten(p, w)
        B, S, d = x_.shape
        xg = x_.reshape(1, B, d) if S == 1 else x_
        y, _ = run(pw, x_)
        return (y,) + _balance_stats(*_route(pw, xg, cfg.moe_top_k)[1:])
    return _balanced_aux(gathered, x, leaves,
                         [(None,) * w.ndim for w in leaves], rules)


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ---------------------------------------------------------------------------


def init_mamba2(gen: torch.Generator, cfg, device=None) -> Params:
    """Mamba2 weights with the reference's *split* projections (z, x, B,
    C, dt) and convolutions (x, B, C); with ``ssm_conv_bias`` a bias a
    convolution (``conv_x_bias``, ``conv_B_bias``, ``conv_C_bias``)."""
    device = init_device(gen, device)
    d, di = cfg.d_model, cfg.ssm_d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups

    def w(shape, scale=None):
        return dense_init(gen, shape, scale, device=device)
    p = {
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
    if cfg.ssm_conv_bias:
        p.update({f"conv_{c}_bias": w((n,), 0.5)
                  for c, n in (("x", di), ("B", G * N), ("C", G * N))})
    return p


@traced_source
def causal_conv1d(w: torch.Tensor, x: torch.Tensor,
                  tail: Optional[torch.Tensor] = None,
                  channels: Optional[str] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv via shift-and-sum, plus ``bias`` [C] if
    given, then SiLU.  w [k, C]; x [B, S, C]; ``tail``: [B, k-1, C]
    carry-in from earlier tokens (zeros when None).  Sums in float32;
    the result has x's dtype.  Under logical rules it runs on each
    rank's rows and ``channels`` (a logical axis, or None: every
    channel)."""
    if sharded(x):
        xa = ("batch", None, channels)
        return local(lambda w_, x_, t_, b_: causal_conv1d(w_, x_, t_,
                                                          bias=b_),
                     [(None, channels), xa, xa, (channels,)], xa)(
            w, x, tail, bias)
    k = w.shape[0]
    if tail is None:
        tail = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xp = torch.cat([tail, x], dim=1)                # [B, S+k-1, C]
    S = x.shape[1]
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + S].float() * w[i]
    if bias is not None:
        out = out + bias
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


@traced_source
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


def _ssd_scan(xh, dt, A, Bm, Cm, D, chunk: int, init_state):
    """:func:`ssd_chunked`; under logical rules on each rank's rows and
    SSD heads (the heads are independent; B and C are every rank's)."""
    if not sharded(xh):
        return ssd_chunked(xh, dt, A, Bm, Cm, D, chunk=chunk,
                           init_state=init_state)
    xa, ha = ("batch", None, "ssm_heads", None), ("ssm_heads",)
    ga, sa = ("batch", None, None, None), ("batch", "ssm_heads", None, None)
    return local(lambda x_, dt_, a_, b_, c_, d_, h_: ssd_chunked(
        x_, dt_, a_, b_, c_, d_, chunk=chunk, init_state=h_),
        [xa, ("batch", None, "ssm_heads"), ha, ga, ga, ha, sa],
        [xa, sa])(xh, dt, A, Bm, Cm, D, init_state)


@traced_source
def mamba2_block(p: Params, x: torch.Tensor, cfg, *, ssm_state=None,
                 conv_tail=None, return_state: bool = False):
    """Full Mamba2 sublayer.  x [B,S,d] → y [B,S,d]; with
    ``return_state`` also the SSD's final state [B,H,P,N] and the conv
    tails {x,B,C} of [B, k-1, ·] (the inputs' last k-1 tokens before the
    conv).  ``conv_tail``: dict {x,B,C} of carry-ins (or None)."""
    B_, S, d = x.shape
    di, H = cfg.ssm_d_inner, cfg.ssm_heads
    N, G, P = cfg.ssm_state, cfg.ssm_groups, cfg.ssm_head_dim
    z = constrain(x @ p["w_z"].to(x.dtype), "batch", None, "inner")
    xin = constrain(x @ p["w_x"].to(x.dtype), "batch", None, "inner")
    Bc = x @ p["w_B"].to(x.dtype)
    Cc = x @ p["w_C"].to(x.dtype)
    dt_raw = constrain(x @ p["w_dt"].to(x.dtype),
                       "batch", None, "ssm_heads")
    km1 = cfg.ssm_conv - 1
    new_tail = ({"x": xin[:, -km1:], "B": Bc[:, -km1:], "C": Cc[:, -km1:]}
                if return_state else None)
    tails = conv_tail or {"x": None, "B": None, "C": None}
    xin = causal_conv1d(p["conv_x"], xin, tail=tails["x"], channels="inner",
                        bias=p.get("conv_x_bias"))
    Bc = causal_conv1d(p["conv_B"], Bc, tail=tails["B"],
                       bias=p.get("conv_B_bias"))
    Cc = causal_conv1d(p["conv_C"], Cc, tail=tails["C"],
                       bias=p.get("conv_C_bias"))

    xh = constrain(xin.reshape(B_, S, H, P), "batch", None, "ssm_heads",
                   None)
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    Bm = Bc.reshape(B_, S, G, N)
    Cm = Cc.reshape(B_, S, G, N)
    y, final_state = _ssd_scan(xh, dt, A, Bm, Cm, p["D"], cfg.ssm_chunk,
                               ssm_state)
    y = y.reshape(B_, S, di)
    y = rms_norm(p["norm"], y * F.silu(z), cfg.norm_eps)
    out = out_proj(y, p["out_proj"])
    if return_state:
        return out, final_state, new_tail
    return out


def _conv_decode(w: torch.Tensor, tail: torch.Tensor, new: torch.Tensor,
                 bias: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-token depthwise conv (plus ``bias``, if given, before the
    SiLU): (out [B,1,C], new_tail [B,k-1,C])."""
    full = torch.cat([tail, new], dim=1)                     # [B,k,C]
    out = (full.float() * w[None]).sum(dim=1, keepdim=True)
    if bias is not None:
        out = out + bias
    return F.silu(out).to(new.dtype), full[:, 1:]


@traced_source
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
                               x @ p["w_x"].to(x.dtype),
                               p.get("conv_x_bias"))
    Bc, tail_B = _conv_decode(p["conv_B"], conv_tail["B"],
                              x @ p["w_B"].to(x.dtype),
                              p.get("conv_B_bias"))
    Cc, tail_C = _conv_decode(p["conv_C"], conv_tail["C"],
                              x @ p["w_C"].to(x.dtype),
                              p.get("conv_C_bias"))
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
    out = out_proj(y, p["out_proj"])
    return out, hnew, new_tail


# ---------------------------------------------------------------------------
# embedding / unembedding / loss
# ---------------------------------------------------------------------------


def init_embed(gen: torch.Generator, V: int, d: int, device=None) -> Params:
    return {"table": embed_init(gen, (V, d), device=device)}


@traced_source
def embed(p: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    """Rows of the table (tokens must lie in ``[0, V)``: the reference's
    ``jnp.take`` would clamp, torch raises), cast to ``dtype``.  Under
    logical rules each rank looks up the tokens its slice of a
    vocabulary-split table holds, and the ranks' rows are summed over
    'model' (Megatron's vocabulary-parallel embedding), so the
    activations leave replicated."""
    table = p["table"]
    if not sharded(table):
        return F.embedding(tokens, table).to(dtype)
    vocab = _split_axes(table, 0)

    def lookup(t, w):
        if vocab is None:
            return F.embedding(t, w).to(dtype)
        idx = t.long() - mesh_coordinate(vocab) * w.shape[0]
        inside = (idx >= 0) & (idx < w.shape[0])
        rows = F.embedding(idx.clamp(0, w.shape[0] - 1), w)
        return mesh_sum((rows * inside[..., None]).to(dtype), vocab)
    return local(lookup, [("batch",) + (None,) * (tokens.ndim - 1), None],
                 ("batch",) + (None,) * tokens.ndim)(tokens, table)


@traced_source
def unembed(table: torch.Tensor, x: torch.Tensor, dtype,
            logits_scaling: float = 1.0) -> torch.Tensor:
    """Logits in x's dtype (a bfloat16 forward rounds them to bfloat16),
    divided by ``logits_scaling`` unless it is 1, then cast to
    ``dtype``."""
    y = x @ table.t().to(x.dtype)
    if logits_scaling != 1.0:
        y = y / logits_scaling
    return y.to(dtype)


@traced_source
def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each token's NLL [B,S] in float32.  logits [B,S,V] (any float
    dtype), labels [B,S].  Under logical rules the vocabulary may be
    split over 'model': each rank reduces its slice and the ranks
    combine the max, the sum and the gold logit (Megatron's
    vocabulary-parallel cross-entropy)."""
    if sharded(logits):
        axis = active_rules().get("vocab")
        if axis is not None and logits.shape[-1] % mesh_size(axis):
            axis = None
        return local(lambda l_, y_: _VocabParallelNLL.apply(l_, y_, axis),
                     [("batch", None, "vocab"), ("batch", None)],
                     ("batch", None))(logits, labels)
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long()[..., None])[..., 0]
    return lse - gold


class _VocabParallelNLL(torch.autograd.Function):
    """Token NLL of one rank's vocabulary slice [b,s,V/m]: the forward
    all-reduces the max, the exponentials' sum and the gold logit over
    the bound "vocab" axis; the backward, ``softmax − onehot``, is each
    rank's own slice."""

    @staticmethod
    def forward(ctx, logits, labels, axis):
        lf = logits.float()
        vl = lf.shape[-1]
        m = mesh_reduce(lf.amax(dim=-1), "max", axis)
        se = mesh_reduce(torch.exp(lf - m[..., None]).sum(dim=-1), "sum",
                         axis)
        lse = m + torch.log(se)
        idx = labels.long() - mesh_coordinate(axis) * vl
        inside = (idx >= 0) & (idx < vl)
        idx = idx.clamp(0, vl - 1)
        gold = lf.gather(-1, idx[..., None])[..., 0] * inside
        gold = mesh_reduce(gold, "sum", axis)
        ctx.save_for_backward(logits, lse, idx, inside)
        return lse - gold

    @staticmethod
    def backward(ctx, dnll):
        logits, lse, idx, inside = ctx.saved_tensors
        p = torch.exp(logits.float() - lse[..., None])
        onehot = F.one_hot(idx, p.shape[-1]) * inside[..., None]
        grad = (p - onehot) * dnll[..., None]
        return grad.to(logits.dtype), None, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL.  logits [B,S,V] (any float dtype), labels [B,S]."""
    nll = token_nll(logits, labels)
    if mask is not None:
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


@traced_source
def chunked_loss(table: torch.Tensor, x: torch.Tensor, labels: torch.Tensor,
                 chunk: int, logits_dtype,
                 logits_scaling: float = 1.0) -> torch.Tensor:
    """Cross-entropy without materializing [B,S,V]: a loop over S chunks
    (``chunk`` ≤ 0 or ≥ S: one pass), of the logits :func:`unembed`
    gives with ``logits_scaling``."""
    B, S, d = x.shape
    if chunk <= 0 or S <= chunk:
        return cross_entropy(unembed(table, x, logits_dtype, logits_scaling),
                             labels)
    if S % chunk:
        raise ValueError(f"chunked_loss: chunk {chunk} does not divide the "
                         f"sequence length {S}")
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(S // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        lf = unembed(table, x[:, sl], logits_dtype, logits_scaling).float()
        if sharded(lf):
            tot = tot + token_nll(lf, labels[:, sl]).sum()
            continue
        # the gather before the logsumexp: their backward then runs in
        # the order that keeps one chunk's gradient fewer alive (1 GB
        # at llama3.2-1b's B2 x S4096)
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
