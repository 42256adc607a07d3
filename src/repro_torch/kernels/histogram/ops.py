"""Public wrapper of the privatised histogram kernel
(``csrc/histogram.cu``).

Replaces ``repro.kernels.histogram.ops.histogram`` (the Pallas kernel
``histogram_pallas``).  A CUDA tensor launches the CUDA kernel or
raises; a CPU tensor takes the plain version in ``ref.py``.
"""
import ctypes

import torch

from .. import _build
from .ref import histogram_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``).
launches = 0

THREADS = 256              # csrc/histogram.cu's block size
ITEMS_PER_THREAD = 32      # values each thread walks before the grid caps
#: One block's bins live in shared memory: at most the per-block opt-in
#: limit of Hopper (232,448 bytes) of int32 counts.
MAX_BINS = 232448 // 4

_SIGNATURES = {"histogram_i32": [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_void_p]}


def grid_size(n: int, sm_count: int) -> int:
    """Blocks for ``n`` values: enough that each thread walks about
    ``ITEMS_PER_THREAD`` values, capped at one SM's worth of resident
    threads (2048) per SM — past that, more blocks only add merges."""
    want = -(-n // (THREADS * ITEMS_PER_THREAD))
    return max(1, min(want, sm_count * (2048 // THREADS)))


def _launch(x: torch.Tensor, nbins: int) -> torch.Tensor:
    global launches
    if nbins > MAX_BINS:
        raise ValueError(f"histogram: {nbins} bins exceed one block's "
                         f"shared memory ({MAX_BINS} bins)")
    out = torch.zeros(nbins, dtype=torch.int32, device=x.device)
    n = x.numel()
    if n == 0:
        return out
    lib = _build.load("histogram", _SIGNATURES)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.histogram_i32(x.data_ptr(), n, out.data_ptr(), nbins,
                                 grid_size(n, sms), stream)
    _build.check(lib, code, "histogram")
    launches += 1
    return out


@torch.library.custom_op("repro_torch::histogram", mutates_args=())
def _histogram(x: torch.Tensor, nbins: int) -> torch.Tensor:
    if x.device.type == "cuda":
        return _launch(x, nbins)
    if x.device.type == "cpu":
        return histogram_ref(x, nbins)
    raise ValueError(f"histogram: no kernel for device {x.device}")


@_histogram.register_fake
def _(x: torch.Tensor, nbins: int) -> torch.Tensor:
    return x.new_empty((nbins,), dtype=torch.int32)


def histogram(x: torch.Tensor, nbins: int) -> torch.Tensor:
    """int32 counts ``[nbins]`` of the int32 values of 1-D ``x`` that lie
    in ``[0, nbins)``; any length, other values are dropped."""
    if x.dim() != 1:
        raise ValueError(f"histogram: input must be 1-D, got shape "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.int32:
        raise TypeError(f"histogram: input dtype {x.dtype}; want int32")
    if not x.is_contiguous():
        raise ValueError("histogram: input must be contiguous")
    if isinstance(nbins, bool) or not isinstance(nbins, int) or nbins < 1:
        raise ValueError(f"histogram: nbins must be a positive int, got "
                         f"{nbins!r}")
    return _histogram(x, nbins)
