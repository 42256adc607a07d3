"""Public wrapper of the matmul kernel (``csrc/matmul.cu``).

Replaces ``repro.kernels.matmul.ops.matmul`` (the Pallas kernel
``matmul_pallas``).  The device of the operands decides the route: a
CUDA tensor launches the CUDA kernel or raises, a CPU tensor takes the
plain version in ``ref.py``.  There is no other fallback.  On the card
the kernel has two variants of its own, chosen by :func:`variant`: the
tensor cores fed by TMA (``"wgmma"``) and the CUDA cores (``"simt"``).

Each variant's tile (bm, bn, bk) is a run-time knob, one of the template
instantiations in :data:`TILES`, resolved through
:mod:`repro_torch.kernels.tuning` (kwarg > tune override > env >
``tuned.json`` > the builtin tile; kept per variant, device and shape
until the registry's generation moves) and validated on every device,
so a bad tile raises the same ``ValueError`` on the CPU as on the card.
The plain version ignores the tile.
"""
import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, tuning
from .ref import matmul_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``),
#: in all and by variant.
launches = 0
launches_by_variant = {"wgmma": 0, "simt": 0}

#: The tiles each variant is instantiated for (the switches of
#: ``csrc/matmul.cu``'s ``launch_wgmma`` and ``launch_simt``): every
#: (bm, bn, bk) of the product of these sets.
TILES = {"wgmma": {"bm": (64, 128), "bn": (64, 128), "bk": (64,)},
         "simt": {"bm": (64, 128), "bn": (64, 128), "bk": (16,)}}
#: The SM count the wave rule of :func:`tile` assumes for CPU tensors (an
#: H100 SXM's): the plain version ignores the tile, so this only fixes
#: what a CPU call resolves and records.
CPU_SMS = 132

_SYMBOLS = {("simt", torch.float32): "matmul_f32",
            ("simt", torch.bfloat16): "matmul_bf16",
            ("wgmma", torch.bfloat16): "matmul_bf16_wgmma"}
_SIGNATURES = {
    **{sym: [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
       for sym in _SYMBOLS.values()},
    "matmul_smem_bytes": [ctypes.c_int] * 4,
    "shared_memory_optin": _build.SMEM_OPTIN_SIGNATURE}
_INT_MAX = 2 ** 31 - 1
_MEMO = tuning.Memo()


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


def tile(M: int, N: int, sms: int, bm: int = 128) -> int:
    """``simt``'s builtin bn for an M x N product on a card of ``sms``
    streaming multiprocessors: 128 when the grid of bm x 128 tiles
    fills one wave (a block an SM), else 64, which doubles the blocks.
    The rule the C entry applied with a fixed 132 SMs before tiles
    became knobs; the wrapper reads the card's count."""
    return 128 if -(-M // bm) * -(-N // 128) >= sms else 64


def _index(device: torch.device) -> int:
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _sms(device: torch.device) -> int:
    if device.type != "cuda":
        return CPU_SMS
    return _build.multiprocessors(_index(device))


def _address(t: torch.Tensor) -> int:
    """``t``'s data address for the variant's alignment test.  A tensor
    with no storage (a fake one, as a ``make_fx`` trace holds) gives its
    offset's bytes: the caching allocator starts every block aligned."""
    from torch._subclasses.fake_tensor import is_fake
    if is_fake(t):
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def resolve_tile(x: torch.Tensor, y: torch.Tensor, bm: Optional[int] = None,
                 bn: Optional[int] = None, bk: Optional[int] = None
                 ) -> Tuple[str, str, Dict[str, int]]:
    """(device key, variant, tile) of ``x @ y``: the variant the product
    takes and its knobs, resolved (explicit ``bm``/``bn``/``bk`` first)
    and validated against :data:`TILES` and, on the card, the device's
    shared memory; raises ``ValueError`` for a tile outside the set."""
    (M, K), N = x.shape, y.shape[1]
    which = variant(M, K, N, x.dtype, _address(x), _address(y))
    named = bm is not None or bn is not None or bk is not None
    key = (which, x.get_device(), M, N)
    if not named:
        got = _MEMO.get(key)
        if got is not None:
            return got
    device = x.device
    dev = tuning.device_key(device)
    cfg = tuning.resolve("matmul", which, device=dev, bm=bm, bn=bn, bk=bk)
    if cfg["bn"] is None:
        rows = cfg["bm"] if cfg["bm"] in TILES[which]["bm"] else 128
        cfg["bn"] = tile(M, N, _sms(device), rows)
    tuning.validate_blocks("matmul", which, cfg, TILES[which])
    if device.type == "cuda":
        lib = _build.load("matmul", _SIGNATURES)
        tuning.validate_blocks(
            "matmul", which, cfg, TILES[which],
            smem_bytes=lib.matmul_smem_bytes(int(which == "wgmma"),
                                             cfg["bm"], cfg["bn"],
                                             cfg["bk"]),
            smem_limit=_build.shared_memory_optin(lib, _index(device)))
    return (dev, which, cfg) if named else \
        _MEMO.put(key, (dev, which, cfg))


def _launch(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int
            ) -> torch.Tensor:
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
            x.data_ptr(), y.data_ptr(), out.data_ptr(), M, N, K, bm, bn, bk,
            stream)
    _build.check(lib, code, "matmul")
    launches += 1
    launches_by_variant[which] += 1
    return out


@torch.library.custom_op("repro_torch::matmul", mutates_args=())
def _matmul(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int
            ) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x, y, bm, bn, bk)
    if x.device.type == "cpu":
        return matmul_ref(x, y)
    raise ValueError(f"matmul: no kernel for device {x.device}")


@_matmul.register_fake
def _(x: torch.Tensor, y: torch.Tensor, bm: int, bn: int, bk: int
      ) -> torch.Tensor:
    return x.new_empty((x.shape[0], y.shape[1]))


@register_flop_formula(torch.ops.repro_torch.matmul)
def _matmul_flops(x_shape, y_shape, bm, bn, bk, *, out_shape=None,
                  **kwargs) -> int:
    """``FlopCounterMode``'s count of ``matmul_ref`` (one ``mm``), which
    cannot see into the custom op: 2·M·N·K."""
    (M, K), N = x_shape, y_shape[1]
    return 2 * M * N * K


def matmul(x: torch.Tensor, y: torch.Tensor, *, bm: Optional[int] = None,
           bn: Optional[int] = None, bk: Optional[int] = None
           ) -> torch.Tensor:
    """``x[M,K] @ y[K,N]`` with a float32 accumulator, in ``x.dtype``.

    Takes contiguous 2-D float32 or bfloat16 operands of one type on one
    device; any M, N, K (ragged edges are masked in the kernel, or
    zero-filled by its TMA loads).  ``bm``/``bn``/``bk`` force the tile
    of the variant the product takes (:data:`TILES`); unset, they come
    from the tuning registry.
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
    dev, which, cfg = resolve_tile(x, y, bm, bn, bk)
    tuning.note("matmul", dev, which, cfg)
    return _matmul(x, y, cfg["bm"], cfg["bn"], cfg["bk"])
