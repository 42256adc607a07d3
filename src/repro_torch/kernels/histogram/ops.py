"""Public wrapper of the histogram kernel (``csrc/histogram.cu``):
privatised shared-memory bins, merged across thread-block clusters.

Replaces ``repro.kernels.histogram.ops.histogram`` (the Pallas kernel
``histogram_pallas``).  A CUDA tensor launches the CUDA kernel or
raises; a CPU tensor takes the plain version in ``ref.py``.
"""
import ctypes
from typing import Dict, Tuple

import torch

from .. import _build
from .ref import histogram_ref

#: Kernel launches made by this process (read by ``chip_smoke.py``).
launches = 0

THREADS = 256              # csrc/histogram.cu's block size
ITEMS_PER_THREAD = 32      # values each thread walks before the grid caps
#: Blocks a cluster (csrc's CLUSTER): the blocks that merge their bins
#: through distributed shared memory before the global merge.
CLUSTER = 4
#: One block's bins live in shared memory: at most the per-block opt-in
#: limit of Hopper (232,448 bytes) of int32 counts.
MAX_BINS = 232448 // 4

_SIGNATURES = {
    "histogram_max_clusters": [ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
    "histogram_i32": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}

#: (device index, nbins) -> clusters that can be resident at once: one
#: occupancy query per key (it stands in for the SM count).
_CLUSTERS: Dict[Tuple[int, int], int] = {}


def grid_size(n: int, max_clusters: int) -> int:
    """Blocks for ``n`` values, in whole clusters of ``CLUSTER``: enough
    that each thread walks about ``ITEMS_PER_THREAD`` values, capped at
    the clusters the card can hold at once (``max_clusters``) — past
    that, more clusters only add merges.  A grid smaller than one
    cluster is padded to one (the extra blocks count nothing)."""
    want = -(-n // (THREADS * ITEMS_PER_THREAD * CLUSTER))
    return CLUSTER * max(1, min(want, max_clusters))


def max_clusters(lib, device: int, nbins: int) -> int:
    """How many clusters with ``nbins`` bins the current device holds at
    once (cached per device and bin count); raises when not one fits."""
    key = (device, nbins)
    fits = _CLUSTERS.get(key)
    if fits is None:
        got = ctypes.c_int(0)
        _build.check(lib, lib.histogram_max_clusters(
            nbins, ctypes.byref(got)), "histogram")
        if got.value < 1:
            raise RuntimeError(f"histogram: no cluster of {CLUSTER} blocks "
                               f"with {nbins} bins fits the device")
        fits = _CLUSTERS[key] = got.value
    return fits


def _launch(x: torch.Tensor, nbins: int) -> torch.Tensor:
    global launches
    if nbins > MAX_BINS:
        raise ValueError(f"histogram: {nbins} bins exceed one block's "
                         f"shared memory ({MAX_BINS} bins)")
    n = x.numel()
    if n == 0:
        return torch.zeros(nbins, dtype=torch.int32, device=x.device)
    # zeroed by the C entry on the same stream
    out = torch.empty(nbins, dtype=torch.int32, device=x.device)
    lib = _build.load("histogram", _SIGNATURES)
    with torch.cuda.device(x.device):
        fits = max_clusters(lib, x.device.index, nbins)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = lib.histogram_i32(x.data_ptr(), n, out.data_ptr(), nbins,
                                 grid_size(n, fits), stream)
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
