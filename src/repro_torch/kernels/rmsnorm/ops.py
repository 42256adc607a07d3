"""Public wrapper of the RMSNorm kernel (``csrc/rmsnorm.cu``).

Replaces ``repro.kernels.rmsnorm.ops.rmsnorm`` (the Pallas kernel
``rmsnorm_pallas``).  A CUDA tensor launches the CUDA kernel or raises;
a CPU tensor takes the plain version in ``ref.py``.  There is no other
fallback.  The Pallas row block ``br`` (a TPU tiling knob) becomes the
rows a block of 256 threads takes: a run-time knob, one of the
instantiations in :data:`TILES` (1 by default: one block a row),
resolved through :mod:`repro_torch.kernels.tuning` (kept per device
until the registry's generation moves) and validated on every device.  The plain version ignores it.
"""
import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, tuning
from .ref import rmsnorm_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``).
launches = 0

#: The kernel's one variant (f32 and bf16 share its body and its knob).
VARIANT = "rows"
#: The rows a block is instantiated for (the switch of csrc's ``launch``).
TILES = {VARIANT: {"br": (1, 2, 4, 8)}}

_SYMBOLS = {torch.float32: "rmsnorm_f32", torch.bfloat16: "rmsnorm_bf16"}
_SIGNATURES = {
    **{sym: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
       for sym in _SYMBOLS.values()},
    "rmsnorm_smem_bytes": [ctypes.c_int],
    "shared_memory_optin": _build.SMEM_OPTIN_SIGNATURE}
_INT_MAX = 2 ** 31 - 1
_MEMO = tuning.Memo()


def resolve_tile(x: torch.Tensor, br: Optional[int] = None
                 ) -> Tuple[str, Dict[str, int]]:
    """(device key, knobs) of a call on ``x``: ``br`` resolved (an
    explicit one first) and validated against :data:`TILES` and, on the
    card, the device's shared memory; raises ``ValueError`` outside the
    set."""
    key = x.get_device()
    if br is None:
        got = _MEMO.get(key)
        if got is not None:
            return got
    dev = tuning.device_key(x.device)
    cfg = tuning.resolve("rmsnorm", VARIANT, device=dev, br=br)
    tuning.validate_blocks("rmsnorm", VARIANT, cfg, TILES[VARIANT])
    if x.is_cuda:
        lib = _build.load("rmsnorm", _SIGNATURES)
        tuning.validate_blocks(
            "rmsnorm", VARIANT, cfg, TILES[VARIANT],
            smem_bytes=lib.rmsnorm_smem_bytes(cfg["br"]),
            smem_limit=_build.shared_memory_optin(lib, key))
    return (dev, cfg) if br is not None else _MEMO.put(key, (dev, cfg))


def _launch(x: torch.Tensor, scale: torch.Tensor, eps: float, br: int
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
            br, stream)
    _build.check(lib, code, "rmsnorm")
    launches += 1
    return out


@torch.library.custom_op("repro_torch::rmsnorm", mutates_args=())
def _rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float, br: int
             ) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x, scale, eps, br)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    raise ValueError(f"rmsnorm: no kernel for device {x.device}")


@_rmsnorm.register_fake
def _(x: torch.Tensor, scale: torch.Tensor, eps: float, br: int
      ) -> torch.Tensor:
    return torch.empty_like(x)


@register_flop_formula(torch.ops.repro_torch.rmsnorm)
def _rmsnorm_flops(x_shape, scale_shape, eps, br, *, out_shape=None,
                   **kwargs) -> int:
    """``FlopCounterMode``'s count of ``rmsnorm_ref``: 0.  It counts
    products only, and the norm is elementwise work and a row sum; the
    formula says so rather than invent a count the counter would not
    give the plain version."""
    return 0


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-6, br: Optional[int] = None) -> torch.Tensor:
    """``x * rsqrt(mean(x^2, -1) + eps) * scale`` in float32 math, in
    ``x.dtype``.

    Takes a contiguous float32 or bfloat16 ``x`` of shape ``[..., d]``
    and a contiguous float32 ``scale`` of shape ``[d]`` on the same
    device; any number of rows and any ``d``.  ``br`` forces the rows a
    block takes (:data:`TILES`); unset, it comes from the tuning
    registry.
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
    dev, cfg = resolve_tile(x, br)
    tuning.note("rmsnorm", dev, VARIANT, cfg)
    return _rmsnorm(x, scale, float(eps), cfg["br"])
