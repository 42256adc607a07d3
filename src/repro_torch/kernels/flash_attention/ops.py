"""Public wrapper of the flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.ops.flash_attention`` (the
Pallas kernel ``flash_attention_pallas``).  A CUDA tensor launches the
CUDA kernel or raises; a CPU tensor takes the plain version in
``ref.py``.  There is no other fallback.  The kernel picks its own tiles
and masks ragged sequence edges, so there are no ``bq``/``bk`` knobs
(the reference wrapper clamped them to the head counts).  On the card
it has two variants of its own, chosen by :func:`variant`: the tensor
cores fed by TMA for bfloat16 (``"wgmma"``) and a register-tiled
CUDA-core body for float32 (``"ffma"``).  A call without keys writes
zeros from the variant's C entry, with no kernel launch.
"""
import ctypes
import math

import torch

from .. import _build
from .ref import flash_attention_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``),
#: in all and by variant.
launches = 0
launches_by_variant = {"wgmma": 0, "ffma": 0}

#: Head sizes the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
#: Grid limit of the head and batch axes (gridDim.y and .z).
_MAX_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1

#: Key ranges a float32 query tile is split into (csrc's F_SPLITS): the
#: ``ffma`` variant's scratch holds each range's (O, m, l).
FFMA_SPLITS = 4

_SYMBOLS = {("ffma", torch.float32): "flash_attention_f32_ffma",
            ("wgmma", torch.bfloat16): "flash_attention_bf16"}
_SIGNATURES = {
    "flash_attention_f32_ffma": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bf16": [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p]}


def variant(dtype: torch.dtype) -> str:
    """The kernel variant a CUDA call takes: ``"wgmma"`` (tensor cores,
    TMA loads) for bfloat16 and ``"ffma"`` (CUDA cores, each score one
    fmaf chain over d, the float32 reference's order) for float32."""
    return "wgmma" if dtype == torch.bfloat16 else "ffma"


def _launch(q, k, v, causal: bool) -> torch.Tensor:
    global launches
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    which = variant(q.dtype)
    if which == "wgmma" and Sk and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: bfloat16 operands must start on "
                         "16 bytes (the kernel's TMA loads)")
    # the ffma variant's key ranges: (O, m, l) each; held until the launch
    # is enqueued, after which the stream orders any reuse
    scratch = [torch.empty(FFMA_SPLITS * B * Sq * H * (D + 2),
                           dtype=torch.float32, device=q.device)] \
        if which == "ffma" else []
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = getattr(lib, _SYMBOLS[which, q.dtype])(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            *(t.data_ptr() for t in scratch), B, Sq, Sk, H, K, D,
            int(causal), 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "flash_attention")
    if Sk:   # without keys the C entry writes zeros and launches nothing
        launches += 1
        launches_by_variant[which] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool) -> torch.Tensor:
    if q.device.type == "cuda":
        return _launch(q, k, v, causal)
    if q.device.type == "cpu":
        # contiguous, as the kernel writes it
        return flash_attention_ref(q, k, v, causal=causal).contiguous()
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


@_flash_attention.register_fake
def _(q, k, v, causal):
    return torch.empty_like(q)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Online-softmax attention, forward only.  q ``[B,Sq,H,D]``, k/v
    ``[B,Sk,K,D]`` with ``H % K == 0`` (grouped kv heads), one dtype
    (float32 or bfloat16), contiguous, on one device; D in
    :data:`HEAD_DIMS`; any Sq and Sk.  The causal mask keeps ``k_pos <=
    q_pos``, both counted from 0.  Returns ``[B,Sq,H,D]`` in q's dtype.
    On the card, bfloat16 operands with keys must start on 16 bytes (a
    view at an odd offset raises ``ValueError``); float32 takes any
    contiguous one (16-byte copies where all three start on 16 bytes,
    4-byte ones otherwise).
    """
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}; want "
                         f"[B,Sq,H,D] and two [B,Sk,K,D]")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} in batch or head size")
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"flash_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {D}; the kernel "
                         f"takes {HEAD_DIMS}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; want all float32 or all bfloat16")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: operands on {q.device}, "
                         f"{k.device} and {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: operands must be contiguous")
    if B > _MAX_GRID_YZ or H > _MAX_GRID_YZ or max(Sq, k.shape[1]) > \
            _INT_MAX:
        raise ValueError("flash_attention: batch or head count exceeds the "
                         "kernel's grid")
    return _flash_attention(q, k, v, bool(causal))
