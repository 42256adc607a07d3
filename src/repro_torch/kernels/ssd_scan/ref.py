"""Plain PyTorch version of the SSD chunk kernel, plus the port's SSD
oracles (``repro.kernels.ssd_scan.ref`` re-exports the same two).

:func:`ssd_chunk_ref` is ``_ssd_chunk_kernel``'s arithmetic over every
(batch, chunk, head) at once: the inclusive cumsum of ``dt·A``, the
intra-chunk output ``y = (tril(C·Bᵀ ∘ exp(Δcs)) · dt) @ x``, the chunk
state ``Σ_k exp(a_tot − cs_k)·dt_k·x_k ⊗ B_k`` and ``exp(cs)``.
"""
import torch

from ...models.layers import ssd_chunked, ssd_reference


def ssd_chunk_ref(x, dt, A, B, C, *, chunk: int = 128):
    """x [b,l,h,p]; dt [b,l,h]; A [h]; B/C [b,l,n] (group folded).

    Returns (y_intra [b,l,h,p] in x.dtype, states [b,l/Q,h,p,n] float32,
    exp_a_cs [b,l,h] float32), Q = min(chunk, l).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    nc = l // Q
    xf = x.float().reshape(b, nc, Q, h, p)
    dtf = dt.float().reshape(b, nc, Q, h)
    Bf = B.float().reshape(b, nc, Q, n)
    Cf = C.float().reshape(b, nc, Q, n)
    a_cs = (dtf * A.float()).cumsum(dim=2)               # [b,nc,Q,h]
    cb = torch.einsum("bcqn,bckn->bcqk", Cf, Bf)         # [b,nc,Q,Q]
    keep = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=x.device))[None, None, :, :, None]
    # exp only below the diagonal: above it the exponent is positive
    diff = a_cs[:, :, :, None, :] - a_cs[:, :, None, :, :]
    decay = torch.exp(diff.masked_fill(~keep, float("-inf")))
    w = cb[..., None] * decay * dtf[:, :, None, :, :]    # [b,nc,Q,Q,h]
    y = torch.einsum("bcqkh,bckhp->bcqhp", w, xf)
    edecay = torch.exp(a_cs[:, :, -1:, :] - a_cs) * dtf  # [b,nc,Q,h]
    states = torch.einsum("bckhp,bckn->bchpn", xf * edecay[..., None], Bf)
    return (y.reshape(b, l, h, p).to(x.dtype), states,
            torch.exp(a_cs).reshape(b, l, h))


__all__ = ["ssd_chunk_ref", "ssd_chunked", "ssd_reference"]
