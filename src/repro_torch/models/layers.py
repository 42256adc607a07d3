"""Neural building blocks — the PyTorch port of ``repro.models.layers``.

Only the subset the nn scope reaches: :func:`rms_norm`, GQA attention
(:func:`naive_attention`, the oracle, and :func:`flash_attention_xla`,
the chunked online-softmax formulation with a recompute backward),
capacity-based MoE dispatch (:func:`init_moe`, :func:`moe_scatter`) and
the Mamba2 SSD scans (:func:`ssd_reference`, :func:`ssd_chunked`).

Conventions are the reference's: parameters are plain dicts of float32
tensors made by the matching ``init_*`` functions (from an explicit
``torch.Generator``), activations ``[B, S, ...]``, attention heads
``[B, S, H, D]`` with ``K`` kv heads (``H % K == 0``).  The reference's
``constrain`` sharding annotations are left out: the port has no mesh
yet.  JAX's ``lax.scan`` loops become Python loops; products that the
reference takes with ``preferred_element_type=float32`` are taken on
float32 copies of the operands, which gives the same products (a
bfloat16 product is exact in float32) summed in float32.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

_NEG_INF = float("-inf")

# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Normal float32 weights on the generator's device, scaled by
    ``1/sqrt(fan_in)`` unless ``scale`` is given."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rms_norm(p: Params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, cast back to
    ``x.dtype``."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


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


# ---------------------------------------------------------------------------
# Mixture of Experts (capacity-based scatter dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen: torch.Generator, d: int, E: int, ff: int, n_shared: int,
             act: str = "silu") -> Params:
    """Router ``[d,E]`` and expert weights ``w_up``/``w_gate`` ``[E,d,ff]``,
    ``w_down`` ``[E,ff,d]`` (the reference's keys).  Shared experts
    (``n_shared > 0``) are not ported yet."""
    if n_shared:
        raise NotImplementedError("init_moe: shared experts (n_shared > 0) "
                                  "are not ported yet")
    p: Params = {
        "router": dense_init(gen, (d, E), scale=0.02),
        "w_up": dense_init(gen, (E, d, ff)),
        "w_down": dense_init(gen, (E, ff, d)),
    }
    if act == "silu":
        p["w_gate"] = dense_init(gen, (E, d, ff))
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
    if n_shared:
        raise NotImplementedError("moe_scatter: shared experts (n_shared "
                                  "> 0) are not ported yet")
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

    # expert FFN: [G,E,C,d] x [E,d,f]
    up = torch.einsum("gecd,edf->gecf", buf, p["w_up"].to(x.dtype))
    if act == "silu":
        gt = torch.einsum("gecd,edf->gecf", buf, p["w_gate"].to(x.dtype))
        h = F.silu(gt) * up
    else:
        h = F.gelu(up, approximate="tanh")     # jax.nn.gelu's default
    out_buf = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(x.dtype))

    y_tok = out_buf[gidx, flat_e, pos_c]                    # gather back
    y_tok = y_tok * (gate_flat * keep)[..., None].to(x.dtype)
    y = y_tok.reshape(G, T, top_k, d).sum(dim=2)            # combine
    return y.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# Mamba2 SSD (state-space duality)
# ---------------------------------------------------------------------------


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
    decay = torch.exp(a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :])
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(mask[None, None, :, :, None], decay, 0.0)
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
