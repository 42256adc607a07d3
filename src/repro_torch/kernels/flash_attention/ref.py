"""Plain PyTorch versions of the flash-attention kernels.

:data:`flash_attention_ref` is the port's ``naive_attention`` (the
reference's oracle, ``repro.kernels.flash_attention.ref``), whose causal
mask ``k_pos <= q_pos`` counts both positions from 0 — the Pallas
kernel's convention.

:func:`flash_fwd_lse_ref` and :func:`flash_bwd_ref` are the algorithm of
the bf16 forward with its log-sum-exp and of its backward (the models'
attention on the card, ``models.layers._flash_fwd_scan`` and
``_flash_bwd_scan``), tile by tile as the kernels take them and GQA-native
(each kv head's query heads read it in place, never repeated): the
forward over key tiles of :data:`FWD_BK`; dK and dV a key tile of
:data:`KV_BK` at a time over the group's query heads and query tiles of
:data:`KV_BQ`; dQ a query tile of :data:`Q_BQ` at a time over key tiles of
:data:`Q_BK`.  They round where the kernels round, which is where the
scans round: P to the operands' type before the row sum and the P·V
product (forward) and before dV's product (backward), dS before dQ's and
dK's; scores, sums and accumulators in float32.  Like the kernels they
scale the float32 scores and dS, where the scans fold the scale into q
and dO in the operands' type (the same numbers at D = 64, a power of
two).  Sums run in another order than the kernels' tensor cores take.
"""
import math
from typing import Tuple

import torch

from ...models.layers import naive_attention as flash_attention_ref

#: The forward's key tile.
FWD_BK = 128
#: dK/dV: keys a block, query rows a tile of its loop.
KV_BK, KV_BQ = 128, 64
#: dQ: query rows a block, keys a tile of its loop.
Q_BQ, Q_BK = 128, 64

__all__ = ["flash_attention_ref", "flash_fwd_lse_ref", "flash_bwd_ref",
           "TOL", "row_gap", "lse_gap", "gaps", "over"]

#: The kernels (and this module's algorithm) against the plain scans,
#: each forward and backward on its own forward's out and lse: the
#: largest :func:`row_gap` each output may show, and lse's largest
#: absolute gap (:func:`lse_gap`).  Both sides round P and dS to bf16 at
#: the same places; at head size 128 the scans fold the softmax scale
#: into q and dO in bf16 where the kernels scale float32, and their
#: float32 sums run in other orders, so a row lies about one bf16 ulp of
#: its largest element apart (out, dk, dv ≤ 1.2e-2, lse ≤ 5e-3 on the
#: CPU tests' shapes, and ≤ 1.3e-2 and 5.1e-3 from the kernels on an
#: H100 at internlm2-1.8b's and granite-4.0-h-small's train layers).  dq
#: lies further, ≤ 9e-2 (6.8e-2 on the H100): a query's first keys give
#: a gradient near zero by cancellation (its dS sums to 0), where the two
#: roundings of dS differ by a share of the terms, not of the sum.  A
#: key tile left out for late rows, or a diagonal mask one off on the
#: tiles after the first, reads ≥ 0.3 on every output and ≥ 4e-2 on lse
#: (``tests/test_torch_flash_train.py``).
TOL = {"out": 3e-2, "dq": 0.2, "dk": 3e-2, "dv": 3e-2, "lse": 1.6e-2}


def row_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest, over rows, of a row's largest |got - want| as a share
    of the row's scale: its largest |want|, or the whole tensor's root
    mean square where that is larger.  A row is every index but the last:
    a query of one head for out and dq, a key of one kv head for dk and
    dv, so a fault in a few late rows counts against those rows' own
    size.  The floor keeps a row that is near zero by cancellation from
    counting rounding noise against a value near 0."""
    if want.numel() == 0:
        return 0.0
    diff = (got.float() - want.float()).abs().amax(-1)
    rms = want.float().square().mean().sqrt()
    scale = want.float().abs().amax(-1).clamp_min(rms)
    return (diff / torch.where(scale > 0, scale, 1.0)).max().item()


def gaps(got: dict, want: dict) -> dict:
    """Each named output's gap to ``want``'s (names of :data:`TOL`):
    lse's :func:`lse_gap`, the others' :func:`row_gap`."""
    return {n: (lse_gap if n == "lse" else row_gap)(got[n], want[n])
            for n in got}


def over(gap: dict) -> dict:
    """The gaps of :func:`gaps` that exceed :data:`TOL`."""
    return {n: g for n, g in gap.items() if not g <= TOL[n]}


def lse_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of two log-sum-exps, a row with no key
    (+inf on both sides) reading 0."""
    same = torch.isinf(want) & (got == want)
    diff = torch.where(same, 0.0, (got.float() - want.float()).abs())
    return diff.max().item() if diff.numel() else 0.0


def _grouped(x: torch.Tensor, K: int) -> torch.Tensor:
    """[B, S, H, D] → float32 [B, K, G, S, D]: head ``h`` is kv head
    ``h // G``'s ``h % G``-th query head."""
    B, S, H, D = x.shape
    return x.float().reshape(B, S, K, H // K, D).permute(0, 2, 3, 1, 4)


def _heads(x: torch.Tensor) -> torch.Tensor:
    """[B, S, K, D] → float32 [B, K, 1, S, D]."""
    return x.float().permute(0, 2, 1, 3)[:, :, None]


def _keep(q0: int, nq: int, k0: int, nk: int, causal: bool,
          device) -> torch.Tensor:
    """[nq, nk] keep-mask of queries ``q0..`` against keys ``k0..``: the
    kernels' top-left causal mask ``k_pos <= q_pos``."""
    if not causal:
        return torch.ones((nq, nk), dtype=torch.bool, device=device)
    q_pos = torch.arange(q0, q0 + nq, device=device)[:, None]
    return torch.arange(k0, k0 + nk, device=device)[None, :] <= q_pos


def flash_fwd_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in q's type ``[B, Sq, H, D]``, lse float32 ``[B, H, Sq]``):
    online softmax over key tiles; a row with no key gives zeros and
    lse +inf."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg, kg, vg = _grouped(q, K), _heads(k), _heads(v)
    shape = qg.shape[:-1]
    m = torch.full(shape, float("-inf"), device=q.device)
    l = torch.zeros(shape, device=q.device)
    acc = torch.zeros(qg.shape, device=q.device)
    for k0 in range(0, Sk, FWD_BK):
        k1 = min(Sk, k0 + FWD_BK)
        s = (qg @ kg[..., k0:k1, :].transpose(-1, -2)) * scale
        s = s.masked_fill(~_keep(0, Sq, k0, k1 - k0, causal, q.device),
                          float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        m_use = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.exp(s - m_use[..., None]).to(q.dtype).float()
        corr = torch.exp(m - m_use)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p @ vg[..., k0:k1, :]
        m = m_new
    out = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    lse = torch.where(l > 0.0, m + torch.log(torch.where(l > 0.0, l, 1.0)),
                      float("inf"))
    return (out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype),
            lse.reshape(B, H, Sq))


def flash_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in q's, k's and v's types, from the forward's ``out``
    and ``lse`` (:func:`flash_fwd_lse_ref`'s contract) and ``dout``."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    qg, dog = _grouped(q, K), _grouped(dout, K)
    kg, vg = _heads(k), _heads(v)
    lse_g = lse.reshape(B, K, G, Sq)
    delta = (dout.float() * out.float()).sum(-1)             # [B, Sq, H]
    delta_g = delta.permute(0, 2, 1).reshape(B, K, G, Sq)

    def probs(s, q0, k0, transposed):
        """P from float32 scores of queries ``q0..`` and keys ``k0..``
        ([.., keys, queries] if ``transposed``)."""
        nq, nk = (s.shape[-1], s.shape[-2]) if transposed else \
            (s.shape[-2], s.shape[-1])
        rows = lse_g[..., q0:q0 + nq]
        keep = _keep(q0, nq, k0, nk, causal, s.device)
        if transposed:
            p = torch.exp(s * scale - rows[..., None, :])
            return p.masked_fill(~keep.T, 0.0)
        p = torch.exp(s * scale - rows[..., None])
        return p.masked_fill(~keep, 0.0)

    # dK/dV: each key tile over the group's heads and the query tiles at
    # or after it (causal); the group's sum in one float32 accumulator
    dk = torch.zeros((B, K, Sk, D), device=q.device)
    dv = torch.zeros((B, K, Sk, D), device=q.device)
    for k0 in range(0, Sk, KV_BK):
        k1 = min(Sk, k0 + KV_BK)
        kt, vt = kg[..., k0:k1, :], vg[..., k0:k1, :]
        for q0 in range((k0 // KV_BQ) * KV_BQ if causal else 0, Sq, KV_BQ):
            q1 = min(Sq, q0 + KV_BQ)
            qt, dot = qg[..., q0:q1, :], dog[..., q0:q1, :]
            pt = probs(kt @ qt.transpose(-1, -2), q0, k0, True)
            dv[..., k0:k1, :] += (pt.to(v.dtype).float() @ dot).sum(2)
            dpt = vt @ dot.transpose(-1, -2)
            dst = pt * (dpt - delta_g[..., None, q0:q1]) * scale
            dk[..., k0:k1, :] += (dst.to(k.dtype).float() @ qt).sum(2)

    # dQ: each query tile over the key tiles up to its diagonal (causal)
    dq = torch.zeros(qg.shape, device=q.device)
    for q0 in range(0, Sq, Q_BQ):
        q1 = min(Sq, q0 + Q_BQ)
        qt, dot = qg[..., q0:q1, :], dog[..., q0:q1, :]
        for k0 in range(0, min(Sk, q1) if causal else Sk, Q_BK):
            k1 = min(Sk, k0 + Q_BK)
            kt, vt = kg[..., k0:k1, :], vg[..., k0:k1, :]
            p = probs(qt @ kt.transpose(-1, -2), q0, k0, False)
            dp = dot @ vt.transpose(-1, -2)
            ds = p * (dp - delta_g[..., q0:q1, None]) * scale
            dq[..., q0:q1, :] += ds.to(q.dtype).float() @ kt
    return (dq.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype),
            dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))
