"""Public wrapper of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``repro.kernels.rmsnorm.ops.rmsnorm`` (the Pallas kernel
``rmsnorm_pallas``).  A CUDA tensor launches the CUDA kernel or raises;
a CPU tensor takes the plain version in ``ref.py``.  There is no other
fallback.  The Pallas row block ``br`` was a TPU tiling knob and has no
counterpart here: the kernel runs one block per row.
"""
import ctypes

import torch

from .. import _build
from .ref import rmsnorm_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``).
launches = 0

_SYMBOLS = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_SIGNATURES = {sym: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
               + [ctypes.c_float, ctypes.c_void_p]
               for sym in _SYMBOLS.values()}
_INT_MAX = 2 ** 31 - 1


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    global launches
    out = torch.empty_like(x)
    d = x.shape[-1]
    rows = x.numel() // d if d else 0
    if rows == 0:
        return out
    lib = _build.load("rmsnorm", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, _SYMBOLS[x.dtype])(
            x.data_ptr(), scale.data_ptr(), out.data_ptr(), rows, d, eps,
            stream)
    _build.check(lib, code, "rmsnorm")
    launches += 1
    return out


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x, scale, eps)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


@_rmsnorm.register_fake
def _(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.empty_like(x)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` in float32 math, in
    ``x.dtype``.

    Takes a contiguous float32 or bfloat16 ``x`` of shape ``[..., d]``
    and a contiguous float32 ``scale`` of shape ``[d]`` on the same
    device; any number of rows and any ``d``.
    """
    if x.dim() < 1 or scale.dim() != 1 or scale.shape[0] != x.shape[-1]:
        raise ValueError(f"rmsnorm: scale {tuple(scale.shape)} does not "
                         f"match the last axis of x {tuple(x.shape)}")
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"rmsnorm: x dtype {x.dtype}; want float32 or "
                        f"bfloat16")
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm: scale dtype {scale.dtype}; want float32")
    if x.device != scale.device:
        raise ValueError(f"rmsnorm: operands on {x.device} and "
                         f"{scale.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm: operands must be contiguous")
    if x.shape[-1] and x.numel() // x.shape[-1] > _INT_MAX:
        raise ValueError("rmsnorm: more rows than the kernel's grid takes")
    return _rmsnorm(x, scale, float(eps))
