"""Plain reference of a Granite 4.0-H hybrid (``granitemoehybrid``), float32.

The layers repeat a period of ``attn_every``: attention at block-local
index ``attn_offset``, a Mamba2 mixer elsewhere, and after every mixer a
mixture of experts with a shared expert.  With the four μP scalars of
the published config (e = ``embedding_multiplier``, r =
``residual_multiplier``, a = ``attention_multiplier``, l =
``logits_scaling``):

* ``x = e · table[tokens]``;
* each layer ``h = x + r · mixer(RMSNorm(x))``, then
  ``x = h + r · (moe(RMSNorm(h)) + shared(RMSNorm(h)))``;
* Mamba2: the projections z, x, B, C and dt (no bias); a depthwise
  causal convolution of width ``ssm_conv`` with a bias, then SiLU, over
  x, B and C; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
  SSD recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
  ``y_t = C_t h_t + D x_t`` per head (one group of B and C), computed by
  :func:`bench.reference.mamba2.ssd`; the gated norm
  ``RMSNorm(y * silu(z))``; the output projection;
* attention: grouped-query, causal, no position encoding, no bias, the
  softmax of ``a · q·k`` (in place of 1/sqrt(head_dim));
* the router: the softmax of ``h · W_router`` over all E experts, its
  top-k renormalised (the same as the published softmax over the top-k
  logits); each routed expert and the shared one a SwiGLU
  ``(silu(h Wg) * (h Wu)) Wd``;
* the logits ``RMSNorm(x) · tableᵀ / l`` through the tied table, and the
  mean next-token NLL, plus 0.01 × the Switch load-balance loss
  ``E · Σ_e frac_e · mean_prob_e`` (frac over first choices) summed
  over the layers.

Departures from the published model, each the configuration's cut:

* **the held share**: only experts ``[0, moe_experts_held)`` of each
  layer have weights here; a token's assignments to the others are left
  out (their part of the output lies on other chips of the expert-
  parallel deployment), while the router keeps its E outputs, its top-k
  and its renormalisation over the top-k;
* **the depth**: ``num_layers`` of the published 40 (whole periods);
* **the aux coefficient** 0.01, the port's (the published config
  states ``router_aux_loss_coef`` for its own training recipe);
* **the SSD chunk**: this file's :data:`CHUNK` and the program's
  ``ssm_chunk`` (128) against the published 256; the chunked SSD is
  exact for any chunk length, so it changes no result;
* **the weights**: drawn from the seed (normal std 1/sqrt(fan_in)
  projections, embedding std 0.02, router std 0.02, norms ones, Mamba2's
  published A, dt and D, convolutions and their biases uniform in
  ±1/sqrt(width), as ``nn.Conv1d`` draws them), not the checkpoint.

The weights' layout is the program's superblock tree: every leaf of a
period stacked over the periods, and within a period over the layers of
its kind.  Each layer is recomputed in the backward; the Mamba2 mixer
and the attention are recomputed a batch row at a time inside it.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .common import (LeafSpec, Numerics, checkpointed, get_path, make_tree,
                     mean_nll, output_table, rms_norm)
from .mamba2 import ssd

#: The reference's own SSD chunk length.
CHUNK = 64

#: The Mamba2 mixer's leaves, in the order :func:`_mamba` takes them.
_MAMBA = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B", "conv_C",
          "conv_x_bias", "conv_B_bias", "conv_C_bias", "A_log", "D",
          "dt_bias", "norm.scale", "out_proj")
_ATTN = ("wq", "wk", "wv", "wo")
_MOE = ("router", "w_up", "w_gate", "w_down", "shared.w_up",
        "shared.w_gate", "shared.w_down")


def _dims(m: Dict[str, Any]):
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return d, di, di // m["ssm_head_dim"], m["ssm_state"] * m["ssm_groups"]


def _layout(m: Dict[str, Any]):
    """(periods, period, attention layers a period, Mamba2 layers a
    period); every layer has experts."""
    P = m["attn_every"]
    if m["num_layers"] % P or m.get("moe_every", 1) != 1 \
            or m.get("moe_offset", 0) or m.get("moe_first_dense", 0):
        raise ValueError("granite_hybrid: whole periods, an MoE on every "
                         "layer")
    n_attn = sum(j == m["attn_offset"] for j in range(P))
    return m["num_layers"] // P, P, n_attn, P - n_attn


def _held(m: Dict[str, Any]) -> int:
    return m.get("moe_experts_held") or m["moe_num_experts"]


def leaves(m: Dict[str, Any]) -> List[LeafSpec]:
    nb, P, na, ns = _layout(m)
    V, k = m["vocab_size"], m["ssm_conv"]
    d, di, H, gn = _dims(m)
    Hq, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    E, ff = m["moe_num_experts"], m["moe_d_ff"]
    fs = ff * m["moe_num_shared"]
    n = _held(m)

    def w(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))
    conv = ("uniform", -1.0 / math.sqrt(k), 1.0 / math.sqrt(k))
    mb, at, mo = "blocks.mamba.", "blocks.attn.", "blocks.moe."
    out: List[LeafSpec] = [
        ("embed.table", (V, d), ("normal", 0.02)),
        ("blocks.ln1", (nb, P, d), ("ones",)),
        ("blocks.ln2", (nb, P, d), ("ones",)),
        (mb + "w_z", (nb, ns, d, di), w(d)),
        (mb + "w_x", (nb, ns, d, di), w(d)),
        (mb + "w_B", (nb, ns, d, gn), w(d)),
        (mb + "w_C", (nb, ns, d, gn), w(d)),
        (mb + "w_dt", (nb, ns, d, H), w(d)),
        (mb + "conv_x", (nb, ns, k, di), conv),
        (mb + "conv_B", (nb, ns, k, gn), conv),
        (mb + "conv_C", (nb, ns, k, gn), conv),
        (mb + "conv_x_bias", (nb, ns, di), conv),
        (mb + "conv_B_bias", (nb, ns, gn), conv),
        (mb + "conv_C_bias", (nb, ns, gn), conv),
        (mb + "A_log", (nb, ns, H), ("uniform", 1.0, 16.0)),
        (mb + "D", (nb, ns, H), ("ones",)),
        (mb + "dt_bias", (nb, ns, H), ("log_uniform", 1e-3, 1e-1)),
        (mb + "norm.scale", (nb, ns, di), ("ones",)),
        (mb + "out_proj", (nb, ns, di, d), w(di)),
        (at + "wq", (nb, na, d, Hq * hd), w(d)),
        (at + "wk", (nb, na, d, K * hd), w(d)),
        (at + "wv", (nb, na, d, K * hd), w(d)),
        (at + "wo", (nb, na, Hq * hd, d), w(Hq * hd)),
        (mo + "router", (nb, P, d, E), ("normal", 0.02)),
        (mo + "w_up", (nb, P, n, d, ff), w(d)),
        (mo + "w_gate", (nb, P, n, d, ff), w(d)),
        (mo + "w_down", (nb, P, n, ff, d), w(ff)),
        (mo + "shared.w_up", (nb, P, d, fs), w(d)),
        (mo + "shared.w_gate", (nb, P, d, fs), w(d)),
        (mo + "shared.w_down", (nb, P, fs, d), w(fs)),
        ("final_norm.scale", (d,), ("ones",)),
    ]
    if not m.get("tie_embeddings", True):
        out.append(("unembed.table", (V, d), ("normal", 0.02)))
    return out


def post_init(path: str, t: torch.Tensor) -> torch.Tensor:
    """A leaf's drawn values made into its initial ones."""
    if path.endswith("A_log"):                 # A ~ U(1, 16) → log A
        return torch.log(t)
    if path.endswith("dt_bias"):               # softplus(dt_bias) = dt
        return t + torch.log(-torch.expm1(-t))
    return t


def make_params(m: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    return make_tree(leaves(m), seed, device, post=post_init)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution with a bias, then SiLU: x [B, S, C],
    w [k, C], b [C]."""
    k, C = w.shape
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), w.t()[:, None, :],
                 bias=b, groups=C)
    return F.silu(y.transpose(1, 2))


def _mamba(m, nm: Numerics, h, w_z, w_x, w_B, w_C, w_dt, conv_x, conv_B,
           conv_C, b_x, b_B, b_C, A_log, D, dt_bias, norm, out_proj):
    """The Mamba2 mixer of one sequence: h [S, d] → [S, d]."""
    S = h.shape[0]
    _d, di, H, _gn = _dims(m)
    P = m["ssm_head_dim"]
    h = h[None]
    z = nm.mm(h, w_z)
    xs = _conv(nm.mm(h, w_x), conv_x, b_x)
    Bm = _conv(nm.mm(h, w_B), conv_B, b_B)
    Cm = _conv(nm.mm(h, w_C), conv_C, b_C)
    dt = F.softplus(nm.mm(h, w_dt) + dt_bias)                # [1, S, H]
    xh = xs.view(1, S, H, P)
    X, Ad, Bp, Cp = xh * dt[..., None], dt * -torch.exp(A_log), Bm, Cm
    pad = (-S) % CHUNK
    if pad:
        X, Ad = F.pad(X, (0, 0, 0, 0, 0, pad)), F.pad(Ad, (0, 0, 0, pad))
        Bp, Cp = F.pad(Bp, (0, 0, 0, pad)), F.pad(Cp, (0, 0, 0, pad))
    y = ssd(X, Ad, Bp, Cp, nm, CHUNK)[:, :S] + xh * D[:, None]
    y = rms_norm(y.reshape(1, S, di) * F.silu(z), norm, m["norm_eps"])
    return nm.mm(y, out_proj)[0]


def _attention(m, nm: Numerics, q, k, v):
    """Causal grouped-query attention of one sequence, no position
    encoding: q [S, H, hd], k/v [S, K, hd]; the scores scaled by
    ``attention_multiplier``."""
    S, H, _hd = q.shape
    rep = H // k.shape[1]
    kr = k.repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    s = nm.einsum("qhd,khd->hqk", q, kr) * m["attention_multiplier"]
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return nm.einsum("hqk,khd->qhd", p, vr)


def _swiglu(nm: Numerics, x, w_up, w_gate, w_down):
    return nm.mm(F.silu(nm.mm(x, w_gate)) * nm.mm(x, w_up), w_down)


def _moe(m, nm: Numerics, h, router, w_up, w_gate, w_down, s_up, s_gate,
         s_down):
    """The routed experts held here and the shared expert: h [B, S, d] →
    (y [B, S, d], the layer's load-balance loss).  Each held expert takes
    the tokens whose top-k holds it, gated by the renormalised top-k
    probability; the others' assignments add nothing here."""
    B, S, d = h.shape
    E, k = m["moe_num_experts"], m["moe_top_k"]
    x = h.reshape(B * S, d)
    probs = torch.softmax(nm.mm(x, router), dim=-1)         # [T, E]
    top, idx = probs.topk(k, dim=-1)
    gates = top / top.sum(dim=-1, keepdim=True)
    frac = F.one_hot(idx[:, 0], E).float().mean(dim=0)
    aux = E * (frac * probs.mean(dim=0)).sum()
    y = torch.zeros_like(x)
    for e in range(w_up.shape[0]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel():
            out = _swiglu(nm, x[tok], w_up[e], w_gate[e], w_down[e])
            y = y.index_put((tok,), out * gates[tok, slot, None],
                            accumulate=True)
    y = y + _swiglu(nm, x, s_up, s_gate, s_down)
    return y.view(B, S, d), aux


def _layer(m, nm: Numerics, mixer: str, x, ln1, ln2, *w):
    """One layer: (x, its load-balance loss)."""
    B, S, d = x.shape
    eps, r = m["norm_eps"], m["residual_multiplier"]
    h = rms_norm(x, ln1, eps)
    if mixer == "ssm":
        mw, w = w[:len(_MAMBA)], w[len(_MAMBA):]
        y = torch.stack([checkpointed(
            lambda h_, *w_: _mamba(m, nm, h_, *w_), h[b], *mw)
            for b in range(B)])
    else:
        (wq, wk, wv, wo), w = w[:len(_ATTN)], w[len(_ATTN):]
        H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        q = nm.mm(h, wq).view(B, S, H, hd)
        k = nm.mm(h, wk).view(B, S, K, hd)
        v = nm.mm(h, wv).view(B, S, K, hd)
        o = torch.stack([checkpointed(
            lambda a, b_, c: _attention(m, nm, a, b_, c), q[b], k[b], v[b])
            for b in range(B)])
        y = nm.mm(o.reshape(B, S, H * hd), wo)
    x = x + r * y
    y, aux = _moe(m, nm, rms_norm(x, ln2, eps), *w)
    return x + r * y, aux


def hidden(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
           nm: Numerics):
    """(the final normed hidden state [B, S, d], the summed
    load-balance losses)."""
    nb, P, _na, _ns = _layout(m)
    x = p["embed"]["table"][tokens.long()] * m["embedding_multiplier"]
    bl = p["blocks"]
    aux = x.new_zeros(())
    for b in range(nb):
        used = {"ssm": 0, "attn": 0}
        for j in range(P):
            mixer = "attn" if j == m["attn_offset"] else "ssm"
            i = used[mixer]
            used[mixer] += 1
            keys, sub = ((_MAMBA, "mamba") if mixer == "ssm"
                         else (_ATTN, "attn"))
            mix = [get_path(bl[sub], key)[b, i] for key in keys]
            moe = [get_path(bl["moe"], key)[b, j] for key in _MOE]
            x, a = checkpointed(
                lambda x_, *w_, mixer=mixer: _layer(m, nm, mixer, x_, *w_),
                x, bl["ln1"][b, j], bl["ln2"][b, j], *mix, *moe)
            aux = aux + a
    return rms_norm(x, p["final_norm"]["scale"], m["norm_eps"]), aux


def loss(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
         labels: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """Mean next-token NLL over every position of the batch, plus 0.01 ×
    the layers' load-balance losses."""
    h, aux = hidden(m, p, tokens, nm)
    return mean_nll(h / m["logits_scaling"], output_table(p), labels,
                    nm) + 0.01 * aux


def logits(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
           nm: Numerics, positions: torch.Tensor) -> torch.Tensor:
    """Logits [len(positions), V] of one sequence ``tokens [S]``."""
    h, _ = hidden(m, p, tokens[None], nm)
    return nm.mm(h[0, positions], output_table(p).t()) / m["logits_scaling"]


def train_flops(m: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one training step on this chip's share: 6 × the
    parameters a token touches × tokens, plus causal attention's two
    products (3 × 2·B·S²·H·hd an attention layer) and the chunked SSD's
    products at the program's chunk length Q (× 3 a Mamba2 layer), as
    in :func:`bench.reference.mamba2.train_flops`.  A token touches
    every leaf but the routed experts (the tied table once, as the
    output product; the router; the shared expert) and, of the routed
    experts, the expected share of its top-k held here: top_k × held / E
    experts' worth a layer (1.25 at 10 of 72 with 9 held), not what a
    given batch routed.  Recomputation is not counted."""
    nb, P, na, ns = _layout(m)
    routed = {"blocks.moe.w_up", "blocks.moe.w_gate", "blocks.moe.w_down"}
    n = sum(math.prod(shape) for path, shape, _ in leaves(m)
            if path not in routed)
    if not m.get("tie_embeddings", True):
        n -= m["vocab_size"] * m["d_model"]
    d, _di, H, N = _dims(m)
    expert = 3 * d * m["moe_d_ff"]
    n += (m["num_layers"] * m["moe_top_k"] * _held(m)
          / m["moe_num_experts"] * expert)
    tokens = batch * seq
    attn = 3 * 2 * batch * seq * seq * m["num_heads"] * m["head_dim"]
    P_, Q = m["ssm_head_dim"], m["ssm_chunk"]
    pairs = tokens // Q * Q * (Q + 1) // 2
    ssd_fwd = (2 * pairs * N + 2 * pairs * H * P_
               + 2 * tokens * H * P_ * N + 2 * tokens * H * P_ * N)
    return (6.0 * n * tokens + attn * na * nb
            + 3 * ssd_fwd * ns * nb)
