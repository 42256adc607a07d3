"""Plain PyTorch version of the matmul kernel: float32 product, cast to
the inputs' type (``repro.kernels.matmul.ref.matmul_ref``'s arithmetic)."""
import torch


def matmul_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x.float() @ y.float()).to(x.dtype)


def bf16_ulp_error(out: torch.Tensor, x: torch.Tensor,
                   y: torch.Tensor) -> float:
    """Largest distance of a bfloat16 product ``out`` from the float32
    product of ``x`` and ``y`` rounded once to bfloat16, in bfloat16 ulps
    of the float32 product's magnitude.

    A kernel that accumulates in float32 and rounds once on store is
    within one ulp: the two float32 sums differ only in the order of
    their additions, which can move a value across one rounding
    boundary.  A kernel that accumulates in bfloat16 is many ulps off.
    Magnitudes below 2**-10 of the product's root mean square count as
    that floor, so entries that cancel to near zero are held to the
    float32 sums' own rounding and not to a vanishing ulp.
    """
    ref32 = x.float() @ y.float()
    floor = 2.0 ** -10 * ref32.pow(2).mean().sqrt()
    mag = torch.maximum(ref32.abs(), floor)
    _, exp = torch.frexp(mag)            # mag = m * 2**exp, m in [0.5, 1)
    ulp = torch.ldexp(torch.ones_like(mag), exp - 8)   # 8 significant bits
    diff = (out.float() - ref32.to(torch.bfloat16).float()).abs()
    return (diff / ulp).max().item() if diff.numel() else 0.0
