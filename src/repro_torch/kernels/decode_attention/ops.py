"""Public wrapper of the decode-attention kernel
(``csrc/decode_attention.cu``).

Replaces no Pallas kernel: the JAX package's decode attention
(``repro.models.layers.decode_attention``) is plain jnp.  The kernel is
the body of ``repro_torch.models.layers.decode_attention`` for every
CUDA tensor, because that layer held the serve engine's decode step on
the card.  A CUDA tensor launches the kernel or raises; a CPU tensor
takes the plain version in ``ref.py`` (the same split-and-combine
algorithm, tile by tile).  There is no other fallback.

The grid is sized from the shapes alone and no length is read on the
host: each block reads its row's length on the device.  The positions a
block takes, :func:`split_len`, start from :data:`SPLIT` and halve (to
one tile) while the grid would give the card's multiprocessors fewer
than two blocks each.  A call is two launches: the splits and their
merge.  Both entries are the operators ``repro_torch::decode_attention``
and ``repro_torch::decode_attention_partials``, registered with
``torch.library.Library`` (CUDA, CPU and Meta kernels), so that every
call, eager, traced or counted, takes the one dispatch path and none
imports ``torch._dynamo`` (a ``torch.library.custom_op`` body would, at
its first call).  Each call also gives the positions it read a row (each
row's live splits), which :func:`logging_reads` collects.
"""
import contextlib
import ctypes
import math
from typing import Iterator, List, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build
from .ref import TILE, decode_attention_ref, positions_read

#: Kernel launches made by this process (read by ``chip_smoke.py``).
launches = 0

#: Positions a split block starts from (:func:`split_len`).
SPLIT = 256
#: Cache dtypes the kernel is instantiated for.
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
#: The largest head size (csrc's MAX_D); D must also be a multiple of 8.
MAX_D = 256
#: Multiprocessors the CPU path sizes its splits for (an H100's), so that
#: it computes what the card would.
CPU_SMS = 132
#: Grid limit of the kv-head and batch axes (gridDim.y and .z).
_MAX_GRID_YZ = 65535
_INT32 = 2 ** 31

# the merge's output modes (csrc's OUT_*)
_OUT_CACHE_TYPE, _OUT_F32, _OUT_PARTIALS = 0, 1, 2

_SYMBOLS = {torch.float32: "decode_attention_f32",
            torch.bfloat16: "decode_attention_bf16",
            torch.float16: "decode_attention_f16"}
_SIGNATURES = {sym: [ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 5
               + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
               for sym in _SYMBOLS.values()}
_SCALES = {}
#: Each call's positions read a row (int32 ``[B]`` on its device) while
#: :func:`logging_reads` is open, else None.
_read_log: Optional[List[torch.Tensor]] = None


def heads_a_block(G: int) -> int:
    """q heads of a kv head's group that one block serves: the least of
    1, 2, 4 and 8 that holds ``G`` (a larger group takes several)."""
    return next((gb for gb in (1, 2, 4) if G <= gb), 8)


def split_len(B: int, K: int, G: int, smax: int, sms: int) -> int:
    """Positions a split block takes for ``B`` rows of ``K`` kv heads
    with groups of ``G`` over ``smax`` positions on a card of ``sms``
    multiprocessors: :data:`SPLIT`, halved down to one tile while the
    grid would hold fewer than two blocks a multiprocessor."""
    blocks = B * K * -(-G // heads_a_block(G))
    split = SPLIT
    while split > TILE and blocks * -(-smax // split) < 2 * sms:
        split //= 2
    return split


def device_split_len(device: torch.device, B: int, K: int, G: int,
                     smax: int) -> int:
    """:func:`split_len` on ``device``: its multiprocessors, or
    :data:`CPU_SMS` for the CPU."""
    if device.type == "cuda":
        sms = _build.multiprocessors(device.index if device.index is not None
                                     else torch.cuda.current_device())
    else:
        sms = CPU_SMS
    return split_len(B, K, G, smax, sms)


def _scale(D: int, dtype: torch.dtype) -> float:
    """1/sqrt(D) rounded to ``dtype``, as the plain path folds it in."""
    got = _SCALES.get((D, dtype))
    if got is None:
        got = _SCALES[D, dtype] = float(torch.tensor(1.0 / math.sqrt(D),
                                                     dtype=dtype))
    return got


def _launch(q, k, v, lens: Optional[torch.Tensor], len_scalar: int,
            first: int, split: int, mode: int
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor], torch.Tensor]:
    global launches
    B, _, H, D = q.shape
    Smax, K = k.shape[1], k.shape[2]
    out = torch.empty((B, 1, H, D), device=q.device,
                      dtype=k.dtype if mode == _OUT_CACHE_TYPE
                      else torch.float32)
    ml = torch.empty((B, H, 2), device=q.device, dtype=torch.float32) \
        if mode == _OUT_PARTIALS else None
    reads = torch.empty(B, device=q.device, dtype=torch.int32)
    if out.numel() == 0:
        if ml is not None:
            ml[..., 0], ml[..., 1] = float("-inf"), 0.0
        return out, ml, reads.zero_()
    item = k.element_size()
    if any(t.data_ptr() % 16 for t in (k, v)) or \
            any(s * item % 16 for s in k.stride()[:3]):
        raise ValueError("decode_attention: the caches must start on 16 "
                         "bytes with whole 16-byte rows (the kernel's "
                         "16-byte copies)")
    nsplit = -(-Smax // split)
    # each split's (m, l) and acc; held until the launches are enqueued,
    # after which the stream orders any reuse
    ws = torch.empty(B * H * nsplit * (D + 2), dtype=torch.float32,
                     device=q.device)
    lib = _build.load("decode_attention", _SIGNATURES)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if lens is None else lens.data_ptr(), ws.data_ptr(),
            out.data_ptr(), None if ml is None else ml.data_ptr(),
            reads.data_ptr(),
            q.stride(0), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            B, Smax, H, K, D,
            0 if lens is None or lens.dim() == 0 else lens.stride(0),
            len_scalar, first, split, mode, _scale(D, k.dtype))
    with torch.cuda.device(q.device):
        code = getattr(lib, _SYMBOLS[k.dtype])(
            *args, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, code, "decode_attention")
    launches += 2 if nsplit else 1
    return out, ml, reads


def _out_dtype(k: torch.Tensor, out_f32: bool) -> torch.dtype:
    return torch.float32 if out_f32 else k.dtype


def _reads_ref(q, k, lens, len_scalar, first, split) -> torch.Tensor:
    return positions_read(len_scalar if lens is None else lens, q.shape[0],
                          first, k.shape[1], split, q.device)


def _attention_cuda(q, k, v, lens, len_scalar, first, split, out_f32):
    out, _, reads = _launch(q, k, v, lens, len_scalar, first, split,
                            _OUT_F32 if out_f32 else _OUT_CACHE_TYPE)
    return out, reads


def _attention_cpu(q, k, v, lens, len_scalar, first, split, out_f32):
    return (decode_attention_ref(q, k, v, len_scalar if lens is None
                                 else lens, first=first, split_len=split,
                                 out_dtype=_out_dtype(k, out_f32)),
            _reads_ref(q, k, lens, len_scalar, first, split))


def _attention_meta(q, k, v, lens, len_scalar, first, split, out_f32):
    return (q.new_empty(q.shape, dtype=_out_dtype(k, out_f32)),
            q.new_empty((q.shape[0],), dtype=torch.int32))


def _partials_cuda(q, k, v, lens, len_scalar, first, split):
    out, ml, reads = _launch(q, k, v, lens, len_scalar, first, split,
                             _OUT_PARTIALS)
    return ml, out, reads


def _partials_cpu(q, k, v, lens, len_scalar, first, split):
    m, l, acc = decode_attention_ref(
        q, k, v, len_scalar if lens is None else lens, first=first,
        split_len=split, partials=True)
    B, _, H, D = q.shape
    return (torch.stack([m, l], dim=-1).reshape(B, H, 2),
            acc.reshape(B, 1, H, D),
            _reads_ref(q, k, lens, len_scalar, first, split))


def _partials_meta(q, k, v, lens, len_scalar, first, split):
    B, _, H, _ = q.shape
    return (q.new_empty((B, H, 2), dtype=torch.float32),
            q.new_empty(q.shape, dtype=torch.float32),
            q.new_empty((B,), dtype=torch.int32))


_LIB = torch.library.Library("repro_torch", "FRAGMENT")
_LIB.define("decode_attention(Tensor q, Tensor k, Tensor v, Tensor? lens, "
            "int len_scalar, int first, int split, bool out_f32) "
            "-> (Tensor, Tensor)")
_LIB.define("decode_attention_partials(Tensor q, Tensor k, Tensor v, "
            "Tensor? lens, int len_scalar, int first, int split) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.impl("decode_attention", _attention_cuda, "CUDA")
_LIB.impl("decode_attention", _attention_cpu, "CPU")
_LIB.impl("decode_attention", _attention_meta, "Meta")
_LIB.impl("decode_attention_partials", _partials_cuda, "CUDA")
_LIB.impl("decode_attention_partials", _partials_cpu, "CPU")
_LIB.impl("decode_attention_partials", _partials_meta, "Meta")


def _decode_flops(q_shape, k_shape) -> int:
    """``FlopCounterMode``'s count of the plain form in
    ``models.layers._decode_attention`` (two batched products, scores
    and output, over every position of the padded cache): 4·B·H·Smax·D."""
    B, _, H, D = q_shape
    return 4 * B * H * k_shape[1] * D


@register_flop_formula(torch.ops.repro_torch.decode_attention)
def _decode_attention_flops(q_shape, k_shape, v_shape, *args,
                            out_shape=None, **kwargs) -> int:
    return _decode_flops(q_shape, k_shape)


@register_flop_formula(torch.ops.repro_torch.decode_attention_partials)
def _decode_attention_partials_flops(q_shape, k_shape, v_shape, *args,
                                     out_shape=None, **kwargs) -> int:
    return _decode_flops(q_shape, k_shape)


def _check(q, k, v) -> int:
    """Raises on operands the kernel does not take; returns the split."""
    if q.dim() != 4 or q.shape[1] != 1 or k.dim() != 4 or \
            v.shape != k.shape or k.shape[0] != q.shape[0] or \
            k.shape[3] != q.shape[3]:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k.shape)} and {tuple(v.shape)}; want "
                         f"[B,1,H,D] and two [B,Smax,K,D]")
    B, _, H, D = q.shape
    K = k.shape[2]
    if K == 0 or H % K:
        raise ValueError(f"decode_attention: {H} query heads are not a "
                         f"multiple of {K} kv heads")
    if D % 8 or not 0 < D <= MAX_D:
        raise ValueError(f"decode_attention: head size {D}; the kernel "
                         f"takes a multiple of 8 up to {MAX_D}")
    if k.dtype not in DTYPES or v.dtype != k.dtype or \
            not q.dtype.is_floating_point:
        raise TypeError(f"decode_attention: q {q.dtype}, caches {k.dtype} "
                        f"and {v.dtype}; want caches of one of {DTYPES}")
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"decode_attention: no kernel for device "
                         f"{q.device}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"decode_attention: operands on {q.device}, "
                         f"{k.device} and {v.device}")
    if k.stride() != v.stride() or k.stride(3) != 1 or q.stride(3) != 1:
        raise ValueError("decode_attention: k and v must share strides, "
                         "and each head's D values must be contiguous")
    if B > _MAX_GRID_YZ or K * -(-(H // K) // heads_a_block(H // K)) > \
            _MAX_GRID_YZ:
        raise ValueError("decode_attention: batch or kv heads exceed the "
                         "kernel's grid")
    return device_split_len(q.device, B, K, H // K, k.shape[1])


def _lengths(cache_len, q) -> Tuple[Optional[torch.Tensor], int]:
    """``cache_len`` as the kernel reads it: an int32 tensor on q's
    device (a 0-d one, or one a row) and 0, or None and a Python int."""
    if isinstance(cache_len, torch.Tensor):
        if cache_len.dim() > 1 or cache_len.dim() == 1 and \
                cache_len.shape[0] != q.shape[0]:
            raise ValueError(f"decode_attention: cache_len "
                             f"{tuple(cache_len.shape)}; want a scalar or "
                             f"[{q.shape[0]}]")
        if cache_len.dtype != torch.int32 or cache_len.device != q.device:
            cache_len = cache_len.to(device=q.device, dtype=torch.int32)
        return cache_len, 0
    return None, min(max(int(cache_len), -_INT32), _INT32 - 1)


@contextlib.contextmanager
def logging_reads() -> Iterator[List[torch.Tensor]]:
    """While open, each call's positions read a row (its live splits:
    the row's length clamped to the cache and rounded up to a whole
    split; int32 ``[B]`` on the call's device) are appended to the list
    this yields.  Reading them waits for the calls' work."""
    global _read_log
    outer, _read_log = _read_log, []
    try:
        yield _read_log
    finally:
        _read_log = outer


def _log(reads: torch.Tensor) -> None:
    if _read_log is not None:
        _read_log.append(reads)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *, first: int = 0
                     ) -> torch.Tensor:
    """Decode attention of q ``[B, 1, H, D]`` over the caches ``[B, Smax,
    K, D]`` (``H % K == 0``; D a multiple of 8 up to :data:`MAX_D`; the
    caches bfloat16, float16 or float32, of one dtype and strides, each
    head's D values contiguous) at positions ``first`` onward, up to
    ``cache_len`` (an int, or a 0-d or ``[B]`` tensor: one length a
    row), clamped to the cache.  Returns ``[B, 1, H, D]`` in q's dtype;
    a row with no position gives zeros.  The numerics are
    ``models.layers._decode_attention``'s, tile by tile (``ref.py``)."""
    split = _check(q, k_cache, v_cache)
    lens, scalar = _lengths(cache_len, q)
    out_f32 = q.dtype != k_cache.dtype
    out, reads = torch.ops.repro_torch.decode_attention(
        q.to(k_cache.dtype), k_cache, v_cache, lens, scalar, int(first),
        split, out_f32)
    _log(reads)
    return out if out.dtype == q.dtype else out.to(q.dtype)


def decode_attention_partials(q: torch.Tensor, k_cache: torch.Tensor,
                              v_cache: torch.Tensor, cache_len, *,
                              first: int = 0) -> List[torch.Tensor]:
    """:func:`decode_attention`'s merged softmax parts, unnormalised, for
    a rank that holds positions ``first`` onward of a longer cache:
    ``[m, l, acc]`` float32 of shapes ``[B, K, G]``, ``[B, K, G]`` and
    ``[B, K, G, D]`` (``m`` is -inf and ``l``, ``acc`` 0 for a row with
    no position here)."""
    split = _check(q, k_cache, v_cache)
    lens, scalar = _lengths(cache_len, q)
    ml, acc, reads = torch.ops.repro_torch.decode_attention_partials(
        q.to(k_cache.dtype), k_cache, v_cache, lens, scalar, int(first),
        split)
    _log(reads)
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    ml = ml.reshape(B, K, H // K, 2)
    return [ml[..., 0], ml[..., 1], acc.reshape(B, K, H // K, D)]
