"""Public wrapper of the matmul kernel (``csrc/matmul.cu``).

Replaces ``repro.kernels.matmul.ops.matmul`` (the Pallas kernel
``matmul_pallas``).  The device of the operands decides the route: a
CUDA tensor launches the CUDA kernel or raises, a CPU tensor takes the
plain version in ``ref.py``.  There is no other fallback.  On the card
the kernel has two variants of its own, chosen by :func:`variant`: the
tensor cores fed by TMA (``"wgmma"``) and the CUDA cores (``"simt"``).
"""
import ctypes

import torch

from .. import _build
from .ref import matmul_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``),
#: in all and by variant.
launches = 0
launches_by_variant = {"wgmma": 0, "simt": 0}

_SYMBOLS = {("simt", torch.float32): "matmul_f32",
            ("simt", torch.bfloat16): "matmul_bf16",
            ("wgmma", torch.bfloat16): "matmul_bf16_wgmma"}
_SIGNATURES = {sym: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
               + [ctypes.c_void_p] for sym in _SYMBOLS.values()}
_INT_MAX = 2 ** 31 - 1


def variant(M: int, K: int, N: int, dtype: torch.dtype, x_ptr: int,
            y_ptr: int) -> str:
    """The kernel variant a CUDA product takes: ``"wgmma"`` (tensor
    cores, TMA loads) for bfloat16 when TMA can read both operands —
    K > 0, row strides of a multiple of 16 bytes (K and N multiples of
    8) and 16-byte aligned base pointers — else ``"simt"`` (CUDA
    cores, any shape; float32 always, as TF32 would miss its 1e-4)."""
    if (dtype == torch.bfloat16 and K > 0 and K % 8 == 0 and N % 8 == 0
            and x_ptr % 16 == 0 and y_ptr % 16 == 0):
        return "wgmma"
    return "simt"


def _launch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    global launches
    (M, K), N = x.shape, y.shape[1]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return out
    which = variant(M, K, N, x.dtype, x.data_ptr(), y.data_ptr())
    lib = _build.load("matmul", _SIGNATURES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, _SYMBOLS[which, x.dtype])(
            x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, stream)
    _build.check(lib, code, "matmul")
    launches += 1
    launches_by_variant[which] += 1
    return out


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x, y)
    if x.device.type == "cpu":
        return matmul_ref(x, y)
    raise ValueError(f"matmul: no kernel for device {x.device}")


@_matmul.register_fake
def _(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x.new_empty((x.shape[0], y.shape[1]))


def matmul(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``x[M,K] @ y[K,N]`` with a float32 accumulator, in ``x.dtype``.

    Takes contiguous 2-D float32 or bfloat16 operands of one type on one
    device; any M, N, K (ragged edges are masked in the kernel, or
    zero-filled by its TMA loads).
    """
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[0]:
        raise ValueError(f"matmul: shapes {tuple(x.shape)} @ "
                         f"{tuple(y.shape)} do not multiply")
    if x.dtype not in (torch.float32, torch.bfloat16) or y.dtype != x.dtype:
        raise TypeError(f"matmul: dtypes {x.dtype}, {y.dtype}; want both "
                        f"float32 or both bfloat16")
    if x.device != y.device:
        raise ValueError(f"matmul: operands on {x.device} and {y.device}")
    if not (x.is_contiguous() and y.is_contiguous()):
        raise ValueError("matmul: operands must be contiguous")
    if max(*x.shape, y.shape[1]) > _INT_MAX:
        raise ValueError("matmul: a dimension exceeds the kernel's int32 "
                         "indexing")
    return _matmul(x, y)
