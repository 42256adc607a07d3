"""Plain PyTorch version of the decode-attention kernel: its split-and-
combine algorithm, tile by tile.

The positions of a padded cache are cut into splits of ``split_len``,
and each split into tiles of :data:`TILE`.  A split runs the online
softmax of ``models.layers._flash_fwd_scan`` over its tiles (q scaled by
1/sqrt(D) in the cache's dtype, float32 scores, the running max updated
per tile, ``p`` rounded to the cache's dtype before both the sum ``l``
and the product with v, the correction applied to ``l`` and the
accumulator) and keeps its ``(m, l, acc)``; the splits are then merged
by log-sum-exp in order (weights ``exp(m_j - max m)``) and ``out = acc /
l``, 0 where ``l`` is 0.  Positions at or past a row's length (less
``first``, clamped to ``[0, Smax]``) take no part.  The kernel computes
the same; its sums run in another order.
"""
import math
from typing import Tuple, Union

import torch

#: Positions a tile (csrc's TILE).
TILE = 32
#: ``(atol, rtol)`` of the kernel against this version, and of either
#: against the port's plain form (``models.layers._decode_attention``),
#: for each cache dtype.  With unit-normal q, k and v the outputs are
#: softmax averages of about sqrt(e / n) over n live positions: a median
#: |out| of some 0.05 at the chat pool's lengths and 0.006 over 32,768.
#: The forms part by the outputs' rounding to the cache's type, an ulp or
#: so, which rtol covers (two ulps at the top of a binade: 2 * 2**-7 in
#: bfloat16, 2 * 2**-10 in float16), and by a weight ``p`` that rounds the
#: other way against another running max, which moves an output by a
#: small share of that weight's ulp; float32 by its sums' order alone.
#: atol covers outputs near 0: about a ninth of the 32,768-position
#: row's rms output (0.009) in bfloat16, a seventieth in float16, a
#: nine-hundredth in float32.  Leaving one of that row's 128 splits out,
#: or merging them unweighted, moves its outputs by 3e-3 or more, which
#: fails each.
TOL = {torch.float32: (1e-5, 1e-5), torch.float16: (1.25e-4, 2e-3),
       torch.bfloat16: (1e-3, 1.6e-2)}


def row_lengths(cache_len, B: int, first: int, smax: int,
                device) -> torch.Tensor:
    """Each row's positions in this cache: ``cache_len`` (a scalar or
    ``[B]``) less ``first``, clamped to ``[0, Smax]``, as int64 ``[B]``."""
    n = torch.as_tensor(cache_len, device=device).long().expand(B)
    return (n - first).clamp(0, smax)


def positions_read(cache_len, B: int, first: int, smax: int, split_len: int,
                   device=None) -> torch.Tensor:
    """The positions each row's live splits span (the kernel's reading of
    a row): its length in this cache rounded up to a whole split, the
    last split ending at ``smax``; int32 ``[B]``."""
    n = row_lengths(cache_len, B, first, smax, device)
    return torch.minimum(-(-n // split_len) * split_len,
                         torch.tensor(smax)).to(torch.int32)


def split_partials(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, cache_len, *, first: int = 0,
                   split_len: int = 256) -> Tuple[torch.Tensor, ...]:
    """Each split's ``(m, l, acc)``: ``[n, B, K, G]``, ``[n, B, K, G]`` and
    ``[n, B, K, G, D]`` float32 for the ``n = ceil(Smax / split_len)``
    splits; a split with no live position keeps ``(-inf, 0, 0)``."""
    B, _, H, D = q.shape
    Smax, K = k_cache.shape[1], k_cache.shape[2]
    G = H // K
    dtype = k_cache.dtype
    scale = float(torch.tensor(1.0 / math.sqrt(D), dtype=dtype))
    qg = (q.to(dtype) * scale).reshape(B, K, G, D).float()
    lens = row_lengths(cache_len, B, first, Smax, q.device)
    ms, ls, accs = [], [], []
    for s0 in range(0, Smax, split_len):
        m = torch.full((B, K, G), float("-inf"), device=q.device)
        l = torch.zeros((B, K, G), device=q.device)
        acc = torch.zeros((B, K, G, D), device=q.device)
        for t0 in range(s0, min(s0 + split_len, Smax), TILE):
            t1 = min(t0 + TILE, s0 + split_len, Smax)
            s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache[:, t0:t1].float())
            live = (torch.arange(t0, t1, device=q.device)[None]
                    < lens[:, None])[:, None, None, :]
            s = torch.where(live, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.where(live, torch.exp(s - m_safe[..., None]), 0.0)
            p = p.to(v_cache.dtype).float()
            corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bkgs,bskd->bkgd", p, v_cache[:, t0:t1].float())
            m = m_new
        ms.append(m)
        ls.append(l)
        accs.append(acc)
    if not ms:                                   # no positions at all
        return (torch.full((0, B, K, G), float("-inf"), device=q.device),
                torch.zeros((0, B, K, G), device=q.device),
                torch.zeros((0, B, K, G, D), device=q.device))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def merge(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The splits' (or ranks') ``(m, l, acc)`` along the first axis merged
    in order by log-sum-exp, unnormalised: ``(max m, Σ w l, Σ w acc)``
    with ``w = exp(m_j - max m)`` (0 for a part with nothing live)."""
    M = m.amax(dim=0) if m.shape[0] else torch.full(
        m.shape[1:], float("-inf"), device=m.device)
    M_safe = torch.where(torch.isneginf(M), 0.0, M)
    L = torch.zeros_like(M)
    A = torch.zeros(acc.shape[1:], device=acc.device)
    for j in range(m.shape[0]):
        w = torch.where(torch.isneginf(m[j]), 0.0, torch.exp(m[j] - M_safe))
        L = L + w * l[j]
        A = A + w[..., None] * acc[j]
    return M, L, A


def normalise(l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """``acc / l``, 0 where ``l`` is 0, as ``[B, 1, H, D]`` float32."""
    B, K, G, D = acc.shape
    o = acc / torch.where(l == 0.0, 1.0, l)[..., None]
    return o.reshape(B, 1, K * G, D)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, cache_len, *,
                         first: int = 0, split_len: int = 256,
                         partials: bool = False, out_dtype=None
                         ) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Decode attention of q ``[B, 1, H, D]`` over the caches ``[B, Smax,
    K, D]`` at positions ``first`` onward, ``cache_len`` a scalar or
    ``[B]``.  Returns ``[B, 1, H, D]`` in ``out_dtype`` (q's by default),
    or with ``partials`` the merged float32 ``(m, l, acc)`` (``[B, K,
    G]``, ``[B, K, G]``, ``[B, K, G, D]``) unnormalised."""
    M, L, A = merge(*split_partials(q, k_cache, v_cache, cache_len,
                                    first=first, split_len=split_len))
    if partials:
        return M, L, A
    return normalise(L, A).to(out_dtype or q.dtype)
