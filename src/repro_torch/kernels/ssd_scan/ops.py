"""SSD through the CUDA chunk kernel (``csrc/ssd_scan.cu``) plus the
inter-chunk recurrence in torch.

Replaces ``repro.kernels.ssd_scan.ops.ssd`` (the Pallas kernel
``ssd_chunk_pallas`` wrapped in XLA).  :func:`ssd_chunk` launches the
kernel for CUDA tensors or raises, and takes the plain version in
``ref.py`` for CPU tensors; there is no other fallback.  :func:`ssd`
wraps it in torch ops as the reference wrapped it in XLA: the scan over
chunk states, the ``C·h_in·exp(cs)`` term and the ``D`` skip.

The chunk is part of the function (it fixes the states' shape), so an
explicit ``chunk`` keeps its contract: the plain version takes any, the
kernel any up to 128.  Left unset, it is resolved on every call through
:mod:`repro_torch.kernels.tuning` (tune override > env > ``tuned.json``
> 128) and must be one of :data:`TILES`, the chunks a tune may choose;
the reference's ``tuned.json`` (256) was chosen in CPU interpret mode
and is not taken.

On the card the kernel is one register-tiled body for chunks up to 128,
head sizes up to 64 and state sizes up to 128, built for two largest
state sizes: :func:`variant` picks ``"tiled_n64"`` or ``"tiled_n128"``
and raises for a shape neither takes.  A block takes one (batch, chunk)
and :func:`head_group` heads, which share its ``C·Bᵀ``.
"""
import ctypes
from typing import Dict, Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from .. import _build, tuning
from .ref import ssd_chunk_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``),
#: in all and by variant.
launches = 0
launches_by_variant = {"tiled_n64": 0, "tiled_n128": 0}

#: The kernel's tile limits (csrc's QM, PM and each variant's NM).
MAX_CHUNK = 128
MAX_HEAD_SIZE = 64
STATE_SIZES = {"tiled_n64": 64, "tiled_n128": 128}
#: The chunks a tune may choose, by variant: the kernel takes any chunk
#: up to ``MAX_CHUNK`` at run time (no instantiation per chunk); these
#: are the ones held to 3e-5 on the card.
TILES = {name: {"chunk": (32, 64, 128)} for name in STATE_SIZES}
#: Most heads a block takes (one cumsum warp each), and the blocks a
#: streaming multiprocessor should get before heads are grouped.
MAX_GROUP = 8
BLOCKS_PER_SM = 2

_MAX_GRID_YZ = 65535
_INT_MAX = 2 ** 31 - 1
_SYMBOLS = {"tiled_n64": "ssd_chunk_f32_n64",
            "tiled_n128": "ssd_chunk_f32_n128"}
_SIGNATURES = {
    **{sym: [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
       for sym in _SYMBOLS.values()},
    "ssd_chunk_smem_bytes": [ctypes.c_int] * 2,
    "shared_memory_optin": _build.SMEM_OPTIN_SIGNATURE,
}


def variant(chunk: int, p: int, n: int) -> str:
    """The kernel variant a CUDA call with chunk ``Q``, head size ``p``
    and state size ``n`` takes: ``"tiled_n64"`` for n ≤ 64,
    ``"tiled_n128"`` for n ≤ 128.  Raises ``ValueError`` for a chunk
    above 128 or a head size above 64: the tiles the kernel stages in
    shared memory are that large."""
    if chunk <= MAX_CHUNK and p <= MAX_HEAD_SIZE:
        for name, most in STATE_SIZES.items():
            if n <= most:
                return name
    raise ValueError(
        f"ssd_chunk: chunk {chunk}, head size {p} and state size {n} exceed "
        f"the tiles the kernel stages in shared memory (chunk ≤ "
        f"{MAX_CHUNK}, head size ≤ {MAX_HEAD_SIZE}, state size ≤ "
        f"{max(STATE_SIZES.values())})")


def state_variant(n: int) -> str:
    """The variant whose tuned chunk a call with state size ``n`` reads:
    the one :func:`variant` picks, ``tiled_n128`` also above 128 (where
    the kernel refuses the shape and only the plain version runs)."""
    return "tiled_n64" if n <= STATE_SIZES["tiled_n64"] else "tiled_n128"


def resolve_chunk(x: torch.Tensor, n: int
                  ) -> Tuple[str, str, Dict[str, int]]:
    """(device key, variant, knobs) of a call on ``x`` with state size
    ``n`` that names no chunk: the chunk resolved through the tuning
    registry for :func:`state_variant` and validated against
    :data:`TILES`."""
    which = state_variant(n)
    dev = tuning.device_key(x.device)
    cfg = tuning.resolve("ssd_scan", which, device=dev)
    tuning.validate_blocks("ssd_scan", which, cfg, TILES[which])
    return dev, which, cfg


def head_group(b: int, nc: int, h: int, sms: int) -> int:
    """Heads a block takes, G: the largest power of two up to
    ``MAX_GROUP`` and up to ``h`` for which the grid of
    ``b · nc · ceil(h / G)`` blocks still gives each of ``sms``
    multiprocessors ``BLOCKS_PER_SM`` blocks; 1 where no G > 1 does.
    The heads of a group share the block's ``C·Bᵀ``."""
    g = MAX_GROUP
    while g > 1 and (g > h or b * nc * -(-h // g) < BLOCKS_PER_SM * sms):
        g //= 2
    return g


def _launch(x, dt, A, B, C, chunk: int):
    global launches
    b, l, h, p = x.shape
    n = B.shape[-1]
    Q = min(chunk, l)
    nc = l // Q
    y = torch.empty_like(x)
    states = torch.empty((b, nc, h, p, n), dtype=torch.float32,
                         device=x.device)
    ecs = torch.empty((b, l, h), dtype=torch.float32, device=x.device)
    if ecs.numel() == 0:
        return y, states, ecs
    which = variant(Q, p, n)
    lib = _build.load("ssd_scan", _SIGNATURES)
    index = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    sms = _build.multiprocessors(index)
    limit = _build.shared_memory_optin(lib, index)
    G = head_group(b, nc, h, sms)
    need = lib.ssd_chunk_smem_bytes(STATE_SIZES[which], G)
    if need > limit:
        raise ValueError(f"ssd_chunk: chunk {Q}, head size {p} and state "
                         f"size {n} need {need} bytes of shared memory; "
                         f"the device allows {limit} a block")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, _SYMBOLS[which])(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), states.data_ptr(), ecs.data_ptr(),
            b, l, h, p, n, Q, G, stream)
    _build.check(lib, code, "ssd_chunk")
    launches += 1
    launches_by_variant[which] += 1
    return y, states, ecs


@torch.library.custom_op("repro_torch::ssd_chunk", mutates_args=())
def _ssd_chunk(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, chunk: int
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if x.device.type == "cuda":
        return _launch(x, dt, A, B, C, chunk)
    if x.device.type == "cpu":
        return ssd_chunk_ref(x, dt, A, B, C, chunk=chunk)
    raise ValueError(f"ssd_chunk: no kernel for device {x.device}")


@_ssd_chunk.register_fake
def _(x, dt, A, B, C, chunk):
    b, l, h, p = x.shape
    nc = l // min(chunk, l)
    return (torch.empty_like(x),
            x.new_empty((b, nc, h, p, B.shape[-1]), dtype=torch.float32),
            x.new_empty((b, l, h), dtype=torch.float32))


@register_flop_formula(torch.ops.repro_torch.ssd_chunk)
def _ssd_chunk_flops(x_shape, dt_shape, A_shape, B_shape, C_shape, chunk,
                     *, out_shape=None, **kwargs) -> int:
    """``FlopCounterMode``'s count of ``ssd_chunk_ref``: its three
    batched products, C·Bᵀ per (batch, chunk), ``y`` and the chunk
    states per head, each over whole Q×Q chunks (the causal half the
    kernel skips included); the cumsum and the decays are elementwise
    and count nothing."""
    b, l, h, p = x_shape
    n = B_shape[-1]
    Q = min(chunk, l)
    nc = l // Q
    return 2 * b * nc * Q * (Q * n + h * Q * p + h * p * n)


def ssd_chunk(x, dt, A, B, C, *, chunk: Optional[int] = None):
    """The SSD chunk kernel: x ``[b,l,h,p]``, dt ``[b,l,h]``, A ``[h]``,
    B/C ``[b,l,n]`` (one group, folded), all float32, contiguous, on one
    device; ``l`` a multiple of ``Q = min(chunk, l)``, the chunk from the
    tuning registry (128 by default) when not given.

    Returns (y_intra ``[b,l,h,p]``, states ``[b,l/Q,h,p,n]``, exp of the
    cumsum of ``dt·A`` within each chunk ``[b,l,h]``), all float32.
    """
    if x.dim() != 4:
        raise ValueError(f"ssd_chunk: x {tuple(x.shape)}; want [b,l,h,p]")
    b, l, h, p = x.shape
    if dt.shape != (b, l, h) or A.shape != (h,) or B.dim() != 3 \
            or B.shape[:2] != (b, l) or C.shape != B.shape:
        raise ValueError(f"ssd_chunk: shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}, C {tuple(C.shape)}; want "
                         f"[b,l,h,p], [b,l,h], [h], [b,l,n], [b,l,n]")
    if chunk is None:
        dev, which, cfg = resolve_chunk(x, B.shape[-1])
        chunk = cfg["chunk"]
    elif isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"ssd_chunk: chunk must be a positive int, got "
                         f"{chunk!r}")
    else:
        dev, which = tuning.device_key(x.device), state_variant(B.shape[-1])
    Q = min(chunk, l)
    if l == 0 or l % Q:
        raise ValueError(f"ssd_chunk: sequence length {l} is not a "
                         f"multiple of the chunk {Q}")
    ops = (x, dt, A, B, C)
    if any(t.dtype != torch.float32 for t in ops):
        raise TypeError("ssd_chunk: operands must be float32, got "
                        + ", ".join(str(t.dtype) for t in ops))
    if any(t.device != x.device for t in ops):
        raise ValueError("ssd_chunk: operands on "
                         + ", ".join(str(t.device) for t in ops))
    if not all(t.is_contiguous() for t in ops):
        raise ValueError("ssd_chunk: operands must be contiguous")
    if b > _MAX_GRID_YZ or h > _MAX_GRID_YZ or x.numel() > _INT_MAX:
        raise ValueError("ssd_chunk: operands exceed the kernel's grid")
    tuning.note("ssd_scan", dev, which, {"chunk": chunk})
    return _ssd_chunk(x, dt, A, B, C, chunk)


def ssd(x, dt, A, B, C, D, *, chunk: Optional[int] = None, init_state=None):
    """Same contract as ``ssd_chunked`` for one group: x ``[b,l,h,p]``;
    dt ``[b,l,h]``; A ``[h]``; B,C ``[b,l,1,n]``; D ``[h]``; float32.
    Returns (y ``[b,l,h,p]``, final_state ``[b,h,p,n]``)."""
    if B.dim() != 4 or C.shape != B.shape or B.shape[2] != 1:
        raise ValueError(f"ssd: B {tuple(B.shape)}, C {tuple(C.shape)}; "
                         f"the kernel takes one group, [b,l,1,n]")
    b, l, h, p = x.shape
    y_intra, states, ecs = ssd_chunk(x, dt, A, B[:, :, 0], C[:, :, 0],
                                     chunk=chunk)
    nc = states.shape[1]
    Q = l // nc
    ecs_c = ecs.reshape(b, nc, Q, h)
    # decay across a whole chunk = exp(a_tot) = ecs at the chunk's last row
    etot = ecs_c[:, :, -1]                                 # [b,nc,h]
    hs = (torch.zeros((b, h, p, states.shape[-1]), dtype=torch.float32,
                      device=x.device)
          if init_state is None else init_state.float())
    h_in = []
    for c in range(nc):                                    # entering state
        h_in.append(hs)
        hs = hs * etot[:, c, :, None, None] + states[:, c]
    h_in = torch.stack(h_in, dim=1)                        # [b,nc,h,p,n]
    Cc = C[:, :, 0].float().reshape(b, nc, Q, -1)
    y_inter = torch.einsum("bcqn,bcqh,bchpn->bcqhp", Cc, ecs_c, h_in)
    y = y_intra.float() + y_inter.reshape(b, l, h, p)
    y = y + x.float() * D[None, None, :, None]
    return y.to(x.dtype), hs
