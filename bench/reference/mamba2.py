"""Plain reference of a Mamba2 language model (SSD), float32.

Each of the pre-norm blocks: RMSNorm; the input projections z, x, B, C
and dt (the published ``in_proj``, split); a depthwise causal
convolution of width ``ssm_conv`` and SiLU over x, B and C, without a
bias; ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the SSD
recurrence ``h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t``,
``y_t = C_t h_t + D x_t`` per head (one group of B and C); the gated
norm ``RMSNorm(y * silu(z))``; the output projection; a residual.  A
final RMSNorm and the tied embedding give the logits.

The SSD is computed by the Mamba2 paper's minimal chunked algorithm
(arXiv:2405.21060, listing 1: ``segsum``, the diagonal blocks, the
chunk states, their recurrence and the off-diagonal blocks), with
chunks of :data:`CHUNK`, exact to rounding for any chunk length.
Weights follow the published initialisation: ``A`` uniform in [1, 16],
``dt`` log-uniform in [1e-3, 1e-1] through the inverse softplus, ``D``
ones, the projections normal with std 1/sqrt(fan_in), the convolutions
uniform in ±1/sqrt(width).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .common import (LeafSpec, Numerics, checkpointed, make_tree, mean_nll,
                     output_table, rms_norm)

#: The reference's own SSD chunk length.
CHUNK = 64


def _dims(m: Dict[str, Any]):
    d = m["d_model"]
    di = m["ssm_expand"] * d
    return d, di, di // m["ssm_head_dim"], m["ssm_state"] * m["ssm_groups"]


def leaves(m: Dict[str, Any]) -> List[LeafSpec]:
    L, V, k = m["num_layers"], m["vocab_size"], m["ssm_conv"]
    d, di, H, gn = _dims(m)

    def w(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))
    conv = ("uniform", -1.0 / math.sqrt(k), 1.0 / math.sqrt(k))
    out: List[LeafSpec] = [
        ("embed.table", (V, d), ("normal", 0.02)),
        ("blocks.ln.scale", (L, d), ("ones",)),
        ("blocks.mamba.w_z", (L, d, di), w(d)),
        ("blocks.mamba.w_x", (L, d, di), w(d)),
        ("blocks.mamba.w_B", (L, d, gn), w(d)),
        ("blocks.mamba.w_C", (L, d, gn), w(d)),
        ("blocks.mamba.w_dt", (L, d, H), w(d)),
        ("blocks.mamba.conv_x", (L, k, di), conv),
        ("blocks.mamba.conv_B", (L, k, gn), conv),
        ("blocks.mamba.conv_C", (L, k, gn), conv),
        ("blocks.mamba.A_log", (L, H), ("uniform", 1.0, 16.0)),
        ("blocks.mamba.D", (L, H), ("ones",)),
        ("blocks.mamba.dt_bias", (L, H), ("log_uniform", 1e-3, 1e-1)),
        ("blocks.mamba.norm.scale", (L, di), ("ones",)),
        ("blocks.mamba.out_proj", (L, di, d), w(di)),
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


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution and SiLU: x [B, S, C], w [k, C]."""
    k, C = w.shape
    y = F.conv1d(F.pad(x.transpose(1, 2), (k - 1, 0)), w.t()[:, None, :],
                 groups=C)
    return F.silu(y.transpose(1, 2))


def segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = sum(x[..., j+1 : i+1])`` for j <= i, -inf
    above the diagonal."""
    T = x.shape[-1]
    x = x[..., None].expand(*x.shape, T)
    below = torch.ones(T, T, dtype=torch.bool, device=x.device).tril(-1)
    x = x.masked_fill(~below, 0.0)
    out = x.cumsum(dim=-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    return out.masked_fill(~keep, float("-inf"))


def ssd(X, A, B, C, nm: Numerics, chunk: int = CHUNK) -> torch.Tensor:
    """Y of the SSD with zero initial state.  X [b, l, h, p] (x · dt),
    A [b, l, h] (A · dt), B and C [b, l, n] (one group)."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    c = l // chunk
    X = X.reshape(b, c, chunk, h, p)
    A = A.reshape(b, c, chunk, h).permute(0, 3, 1, 2)        # b h c l
    B = B.reshape(b, c, chunk, n)
    C = C.reshape(b, c, chunk, n)
    A_cs = A.cumsum(-1)
    Lm = torch.exp(segsum(A))                                # b h c l s
    CB = nm.einsum("bcln,bcsn->bcls", C, B)
    Y_diag = nm.einsum("bhcls,bcshp->bclhp",
                       CB[:, None] * Lm, X)
    decay = torch.exp(A_cs[..., -1:] - A_cs)                 # b h c l
    states = nm.einsum("bcln,bhcl,bclhp->bchpn", B, decay, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cs[..., -1], (1, 0))))
    states = nm.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)[:, :-1]
    Y_off = nm.einsum("bcln,bchpn,bhcl->bclhp", C, states, torch.exp(A_cs))
    return (Y_diag + Y_off).reshape(b, l, h, p)


def _block(m, nm: Numerics, x, ln, w_z, w_x, w_B, w_C, w_dt, conv_x, conv_B,
           conv_C, A_log, D, dt_bias, norm, out_proj):
    Bsz, S, _ = x.shape
    _d, di, H, _gn = _dims(m)
    P, eps = m["ssm_head_dim"], m["norm_eps"]
    h = rms_norm(x, ln, eps)
    z = nm.mm(h, w_z)
    xs = _conv(nm.mm(h, w_x), conv_x)
    Bm = _conv(nm.mm(h, w_B), conv_B)
    Cm = _conv(nm.mm(h, w_C), conv_C)
    dt = F.softplus(nm.mm(h, w_dt) + dt_bias)                # [B, S, H]
    A = -torch.exp(A_log)
    xh = xs.view(Bsz, S, H, P)
    pad = (-S) % CHUNK
    X, Ad, Bp, Cp = xh * dt[..., None], dt * A, Bm, Cm
    if pad:
        X, Ad = F.pad(X, (0, 0, 0, 0, 0, pad)), F.pad(Ad, (0, 0, 0, pad))
        Bp, Cp = F.pad(Bp, (0, 0, 0, pad)), F.pad(Cp, (0, 0, 0, pad))
    y = ssd(X, Ad, Bp, Cp, nm)[:, :S] + xh * D[:, None]
    y = rms_norm(y.reshape(Bsz, S, di) * F.silu(z), norm, eps)
    return x + nm.mm(y, out_proj)


_BLOCK_KEYS = ("w_z", "w_x", "w_B", "w_C", "w_dt", "conv_x", "conv_B",
               "conv_C", "A_log", "D", "dt_bias")


def hidden(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
           nm: Numerics) -> torch.Tensor:
    x = p["embed"]["table"][tokens.long()]
    b = p["blocks"]
    mb = b["mamba"]
    for i in range(m["num_layers"]):
        x = checkpointed(
            lambda x_, *w: _block(m, nm, x_, *w), x, b["ln"]["scale"][i],
            *(mb[k][i] for k in _BLOCK_KEYS), mb["norm"]["scale"][i],
            mb["out_proj"][i])
    return rms_norm(x, p["final_norm"]["scale"], m["norm_eps"])


def loss(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
         labels: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """Mean next-token NLL over every position of the batch."""
    return mean_nll(hidden(m, p, tokens, nm), output_table(p), labels, nm)


def logits(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
           nm: Numerics, positions: torch.Tensor) -> torch.Tensor:
    h = hidden(m, p, tokens[None], nm)[0]
    return nm.mm(h[positions], output_table(p).t())


def train_flops(m: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·tokens (a tied table is
    the output head, so it counts), plus, a layer, the products the
    chunked SSD needs at the program's chunk length Q, forward and
    backward (× 3): C·Bᵀ and its masked product with x over each
    chunk's Q(Q+1)/2 causal pairs, the chunk states, and C · state.
    Recomputation is not counted."""
    n = sum(math.prod(shape) for _, shape, _ in leaves(m))
    if not m.get("tie_embeddings", True):
        n -= m["vocab_size"] * m["d_model"]
    _d, _di, H, N = _dims(m)
    P, Q = m["ssm_head_dim"], m["ssm_chunk"]
    tokens = batch * seq
    pairs = tokens // Q * Q * (Q + 1) // 2
    ssd_fwd = (2 * pairs * N            # C·Bᵀ
               + 2 * pairs * H * P      # its masked product with x
               + 2 * tokens * H * P * N     # chunk states
               + 2 * tokens * H * P * N)    # C · state
    return 6.0 * n * tokens + 3 * ssd_fwd * m["num_layers"]
