"""Public wrapper of the flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces ``repro.kernels.flash_attention.ops.flash_attention`` (the
Pallas kernel ``flash_attention_pallas``).  A CUDA tensor launches the
CUDA kernel or raises; a CPU tensor takes the plain version in
``ref.py``.  There is no other fallback.  On the card it has two
variants of its own, chosen by :func:`variant`: the tensor cores fed by
TMA for bfloat16 (``"wgmma"``) and a register-tiled CUDA-core body for
float32 (``"ffma"``).  A call without keys writes zeros from the
variant's C entry, with no kernel launch.

The ``ffma`` variant's tile (``bq`` query rows by ``bk`` keys) is a
run-time knob, one of the instantiations in :data:`TILES`, resolved
through :mod:`repro_torch.kernels.tuning` (kept per device and head
size until the registry's generation moves) and validated on every
device (the reference wrapper clamped its blocks to the head
counts; the kernel masks ragged sequence edges instead).  The ``wgmma``
variant's 128 x 128 tile is fixed: no family tunes it, and a ``bq`` or
``bk`` given for a bfloat16 call raises.  The plain version ignores the
tile.

The models' attention (``models.layers._flash_fwd_scan`` and
``_flash_bwd_scan``) runs on the bf16 kernels where
:func:`takes_kernels` says so: :func:`attention_fwd`, the ``wgmma``
variant writing each row's log-sum-exp too, and :func:`attention_bwd`,
its GQA-native, deterministic backward (a delta pass, a dK/dV kernel and
a dQ kernel).  Both are operators registered with
``torch.library.Library`` (CUDA, CPU and Meta kernels); a CPU tensor
takes their plain versions in ``ref.py`` (:func:`flash_fwd_lse_ref`,
:func:`flash_bwd_ref`), the kernels' algorithm tile by tile.
"""
import ctypes
import math
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, tuning
from .ref import flash_attention_ref, flash_bwd_ref, flash_fwd_lse_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``),
#: in all and by variant: the forward's two, and the backward's three
#: kernels (each of its calls launches all three).
launches = 0
launches_by_variant = {"wgmma": 0, "ffma": 0, "bwd_delta": 0, "bwd_dkdv": 0,
                       "bwd_dq": 0}
#: The backward's kernels, by ``launches_by_variant`` key.
BWD_VARIANTS = ("bwd_delta", "bwd_dkdv", "bwd_dq")

#: Head sizes the kernel is instantiated for.
HEAD_DIMS = (16, 32, 64, 128)
#: Head sizes the bf16 backward is instantiated for: the models'
#: attention takes the kernels at these alone.
TRAIN_HEAD_DIMS = (64, 128)
#: Grid limit of the head and batch axes (gridDim.y and .z).
_MAX_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1

#: Key ranges a float32 query tile is split into (csrc's F_SPLITS): the
#: ``ffma`` variant's scratch holds each range's (O, m, l).
FFMA_SPLITS = 4
#: The tiles the ``ffma`` variant is instantiated for, at every head size
#: (the switch of csrc's ``launch_ffma_tile``): every (bq, bk) of the
#: product of these sets.
TILES = {"ffma": {"bq": (64, 128), "bk": (32, 64)}}
#: The ``wgmma`` variant's fixed tile, passed through the custom op.
WGMMA_TILE = {"bq": 128, "bk": 128}

_SYMBOLS = {("ffma", torch.float32): "flash_attention_f32_ffma",
            ("wgmma", torch.bfloat16): "flash_attention_bf16"}
_SIGNATURES = {
    "flash_attention_f32_ffma": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "flash_attention_bf16": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_bf16_bwd": [ctypes.c_void_p] * 10
    + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p],
    "flash_attention_smem_bytes": [ctypes.c_int] * 3,
    "shared_memory_optin": _build.SMEM_OPTIN_SIGNATURE}
_MEMO = tuning.Memo()


def variant(dtype: torch.dtype) -> str:
    """The kernel variant a CUDA call takes: ``"wgmma"`` (tensor cores,
    TMA loads) for bfloat16 and ``"ffma"`` (CUDA cores, each score one
    fmaf chain over d, the float32 reference's order) for float32."""
    return "wgmma" if dtype == torch.bfloat16 else "ffma"


def resolve_tile(q: torch.Tensor, bq: Optional[int] = None,
                 bk: Optional[int] = None
                 ) -> Tuple[str, str, Dict[str, int]]:
    """(device key, variant, tile) of a call on ``q``: the ``ffma``
    tile resolved (explicit ``bq``/``bk`` first) and validated against
    :data:`TILES` and, on the card, the device's shared memory; the
    ``wgmma`` variant's fixed tile.  Raises ``ValueError`` for a tile
    outside the set, or for any tile given to a bfloat16 call."""
    which = variant(q.dtype)
    if which == "wgmma":
        if bq is not None or bk is not None:
            raise ValueError("flash_attention: the bfloat16 (wgmma) "
                             "variant's 128 x 128 tile is fixed; bq and bk "
                             "tune the float32 (ffma) variant")
        return tuning.device_key(q.device), which, dict(WGMMA_TILE)
    named = bq is not None or bk is not None
    D = q.shape[-1]
    key = (q.get_device(), D)
    if not named:
        got = _MEMO.get(key)
        if got is not None:
            return got
    dev = tuning.device_key(q.device)
    cfg = tuning.resolve("flash_attention", which, device=dev, bq=bq, bk=bk)
    tuning.validate_blocks("flash_attention", which, cfg, TILES[which])
    if q.is_cuda:
        lib = _build.load("flash_attention", _SIGNATURES)
        index = q.device.index if q.device.index is not None \
            else torch.cuda.current_device()
        tuning.validate_blocks(
            "flash_attention", which, cfg, TILES[which],
            smem_bytes=lib.flash_attention_smem_bytes(D, cfg["bq"],
                                                      cfg["bk"]),
            smem_limit=_build.shared_memory_optin(lib, index))
    return (dev, which, cfg) if named else \
        _MEMO.put(key, (dev, which, cfg))


def _launch(q, k, v, causal: bool, bq: int, bk: int) -> torch.Tensor:
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
            *(t.data_ptr() for t in scratch),
            *((None,) if which == "wgmma" else ()), B, Sq, Sk, H, K, D,
            int(causal), 1.0 / math.sqrt(D),
            *((bq, bk) if which == "ffma" else ()), stream)
    _build.check(lib, code, "flash_attention")
    if Sk:   # without keys the C entry writes zeros and launches nothing
        launches += 1
        launches_by_variant[which] += 1
    return out


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, bq: int, bk: int) -> torch.Tensor:
    if q.device.type == "cuda":
        return _launch(q, k, v, causal, bq, bk)
    if q.device.type == "cpu":
        # contiguous, as the kernel writes it
        return flash_attention_ref(q, k, v, causal=causal).contiguous()
    raise ValueError(f"flash_attention: no kernel for device {q.device}")


@_flash_attention.register_fake
def _(q, k, v, causal, bq, bk):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_attention_flops(q_shape, k_shape, v_shape, causal, bq, bk, *,
                           out_shape=None, **kwargs) -> int:
    """``FlopCounterMode``'s count of the plain version (two batched
    products, scores and output, over every (query, key) pair whatever
    the causal mask drops): 4·B·H·Sq·Sk·D."""
    B, Sq, H, D = q_shape
    return 4 * B * H * Sq * k_shape[1] * D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: Optional[int] = None,
                    bk: Optional[int] = None) -> torch.Tensor:
    """Online-softmax attention, forward only.  q ``[B,Sq,H,D]``, k/v
    ``[B,Sk,K,D]`` with ``H % K == 0`` (grouped kv heads), one dtype
    (float32 or bfloat16), contiguous, on one device; D in
    :data:`HEAD_DIMS`; any Sq and Sk.  The causal mask keeps ``k_pos <=
    q_pos``, both counted from 0.  Returns ``[B,Sq,H,D]`` in q's dtype.
    On the card, bfloat16 operands with keys must start on 16 bytes (a
    view at an odd offset raises ``ValueError``); float32 takes any
    contiguous one (16-byte copies where all three start on 16 bytes,
    4-byte ones otherwise).  ``bq``/``bk`` force the float32 variant's
    tile (:data:`TILES`); unset, they come from the tuning registry.
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
    dev, which, cfg = resolve_tile(q, bq, bk)
    if which == "ffma":
        tuning.note("flash_attention", dev, which, cfg)
    return _flash_attention(q, k, v, bool(causal), cfg["bq"], cfg["bk"])


# ---------------------------------------------------------------------------
# the models' attention: the forward with its log-sum-exp, and the backward
# ---------------------------------------------------------------------------


def kernels_fit(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> bool:
    """Whether the kernels (:func:`attention_fwd`, :func:`attention_bwd`)
    compute attention over operands of these types and shapes: bfloat16,
    a head size in :data:`TRAIN_HEAD_DIMS`, queries and keys, and under
    the causal mask as many queries as keys: the kernels' mask is
    top-left (``k_pos <= q_pos``) and the scans' bottom-right, which
    agree only there."""
    return (q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in TRAIN_HEAD_DIMS
            and q.shape[1] > 0 and k.shape[1] > 0
            and (not causal or q.shape[1] == k.shape[1]))


def takes_kernels(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool) -> bool:
    """Whether the models' attention over these operands runs on the
    kernels: CUDA tensors that :func:`kernels_fit`.  A trace's fake CUDA
    tensors (the dry run's) take the same branch, through the operators'
    Meta kernels, so a traced step holds what the card runs."""
    return q.is_cuda and kernels_fit(q, k, v, causal)


def _ready(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on 16 bytes (the kernels' TMA loads), copied
    where it is not."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _fwd_lse_cuda(q, k, v, causal, need_lse):
    global launches
    q, k, v = _ready(q), _ready(k), _ready(v)
    B, Sq, H, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq) if need_lse else (0,), dtype=torch.float32,
                      device=q.device)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if need_lse else None, B, Sq, k.shape[1], H,
            k.shape[2], D, int(causal), 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "flash_attention_fwd_lse")
    launches += 1
    launches_by_variant["wgmma"] += 1
    return out, lse


def _fwd_lse_cpu(q, k, v, causal, need_lse):
    out, lse = flash_fwd_lse_ref(q, k, v, causal)
    return out, lse if need_lse else lse.new_empty((0,))


def _fwd_lse_meta(q, k, v, causal, need_lse):
    B, Sq, H, _ = q.shape
    return (torch.empty_like(q),
            q.new_empty((B, H, Sq) if need_lse else (0,),
                        dtype=torch.float32))


def _bwd_cuda(q, k, v, out, lse, dout, causal):
    global launches
    q, k, v, out, dout = (_ready(t) for t in (q, k, v, out, dout))
    lse = lse.contiguous()
    B, Sq, H, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    lib = _build.load("flash_attention", _SIGNATURES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        code = lib.flash_attention_bf16_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, Sq, k.shape[1], H, k.shape[2],
            D, int(causal), 1.0 / math.sqrt(D), stream)
    _build.check(lib, code, "flash_attention_bwd")
    launches += len(BWD_VARIANTS)
    for name in BWD_VARIANTS:
        launches_by_variant[name] += 1
    return dq, dk, dv


def _bwd_cpu(q, k, v, out, lse, dout, causal):
    return flash_bwd_ref(q, k, v, out, lse, dout, causal)


def _bwd_meta(q, k, v, out, lse, dout, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("flash_attention_fwd_lse(Tensor q, Tensor k, Tensor v, "
            "bool causal, bool need_lse) -> (Tensor, Tensor)")
_LIB.define("flash_attention_bwd(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor lse, Tensor dout, bool causal) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.impl("flash_attention_fwd_lse", _fwd_lse_cuda, "CUDA")
_LIB.impl("flash_attention_fwd_lse", _fwd_lse_cpu, "CPU")
_LIB.impl("flash_attention_fwd_lse", _fwd_lse_meta, "Meta")
_LIB.impl("flash_attention_bwd", _bwd_cuda, "CUDA")
_LIB.impl("flash_attention_bwd", _bwd_cpu, "CPU")
_LIB.impl("flash_attention_bwd", _bwd_meta, "Meta")


def kept_pairs(Sq: int, Sk: int, causal: bool) -> int:
    """The (query, key) pairs attention weighs: every one, or under the
    kernels' causal mask (``k_pos <= q_pos``) those on or below the
    diagonal."""
    if not causal:
        return Sq * Sk
    n = min(Sq, Sk)
    return n * (n + 1) // 2 + (Sq - n) * Sk


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd_lse)
def _fwd_lse_flops(q_shape, k_shape, v_shape, causal, need_lse, *,
                   out_shape=None, **kwargs) -> int:
    """The forward's own work: two products (scores and P·V) a kept
    pair, 4·B·H·D·pairs."""
    B, Sq, H, D = q_shape
    return 4 * B * H * D * kept_pairs(Sq, k_shape[1], causal)


@register_flop_formula(torch.ops.repro_torch.flash_attention_bwd)
def _bwd_flops(q_shape, k_shape, v_shape, out_shape_, lse_shape,
               dout_shape, causal, *, out_shape=None, **kwargs) -> int:
    """The backward's own work: five products a kept pair (S, dP, dV, dK,
    dQ) and delta's row sums, 10·B·H·D·pairs + 2·B·Sq·H·D.  The dQ
    kernel's second S and dP, the price of summing with no atomics, are
    not the function's work and are not counted."""
    B, Sq, H, D = q_shape
    return 10 * B * H * D * kept_pairs(Sq, k_shape[1], causal) + \
        2 * B * Sq * H * D


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, need_lse: bool
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(out ``[B, Sq, H, D]`` in q's type, lse float32 ``[B, H, Sq]`` or
    None without ``need_lse``) for operands :func:`takes_kernels` takes,
    or CPU tensors (the plain version)."""
    out, lse = torch.ops.repro_torch.flash_attention_fwd_lse(
        q, k, v, bool(causal), bool(need_lse))
    return out, lse if need_lse else None


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) shaped and typed as q, k and v, from the forward's
    ``out`` and ``lse`` (:func:`attention_fwd`) and the output's
    gradient ``dout``."""
    return torch.ops.repro_torch.flash_attention_bwd(
        q, k, v, out, lse, dout, bool(causal))
