"""Build the hand-written CUDA kernels at first use and load them.

Each kernel's source is ``kernels/<name>/csrc/<name>.cu`` with a plain C
interface.  It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library under the checkout's ``build/`` directory and loaded with
``ctypes``.  Sources include the shared Hopper helpers as
``"_hopper/hopper.cuh"`` (``kernels/`` is on the include path).  The
library's file name carries a hash of the source, the headers it may
include (every ``*.cuh`` beside it and under ``kernels/_hopper/``) and
the flags, so an edited source or header rebuilds and an unchanged one
is loaded as it is.  Nothing here runs at import time: the CPU tests
import every module on a host without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence

KERNELS_DIR = Path(__file__).resolve().parent
#: src/repro_torch/kernels → the checkout's root
BUILD_DIR = KERNELS_DIR.parents[2] / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Loaded libraries by kernel name (one load per process).
_LOADED: Dict[str, ctypes.CDLL] = {}
#: Device index -> per-block shared-memory opt-in limit, in bytes.
_SMEM_OPTIN: Dict[int, int] = {}
#: Device index -> streaming multiprocessors.
_SMS: Dict[int, int] = {}
#: ``shared_memory_optin``'s argument types, for a kernel's signatures.
SMEM_OPTIN_SIGNATURE = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]


def kernel_names() -> List[str]:
    """Every kernel with a source under ``kernels/<name>/csrc/``."""
    return sorted(p.parent.parent.name
                  for p in KERNELS_DIR.glob("*/csrc/*.cu")
                  if p.stem == p.parent.parent.name)


def source(name: str) -> Path:
    return KERNELS_DIR / name / "csrc" / f"{name}.cu"


def headers(name: str) -> List[Path]:
    """The headers a kernel's source may include: the shared Hopper
    helpers and any ``*.cuh`` in its own ``csrc/``."""
    return sorted([*(KERNELS_DIR / "_hopper").glob("*.cuh"),
                   *source(name).parent.glob("*.cuh")])


def library_path(name: str) -> Path:
    """``build/<name>-<hash>.so``: the hash covers the source, its
    headers and the flags."""
    h = hashlib.sha1(source(name).read_bytes())
    for header in headers(name):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def nvcc() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else ``$CUDA_HOME/bin/nvcc``
    (``CUDA_HOME`` defaults to ``/usr/local/cuda``).  Raises when there
    is none — a CUDA run never goes on without its kernels."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.access(candidate, os.X_OK):
        return candidate
    raise RuntimeError(f"nvcc not found on PATH or in {home}/bin: the CUDA "
                       f"kernels cannot be built")


def nvcc_command(name: str, out: Path) -> List[str]:
    return [nvcc(), *NVCC_FLAGS, "-I", str(KERNELS_DIR), "-o", str(out),
            str(source(name))]


def build(names: Sequence[str]) -> Dict[str, str]:
    """Compile every named kernel whose library is missing, all at once
    (one ``nvcc`` per source, started together).  Returns the compiler's
    messages by kernel name (``-Xptxas -v``: registers, shared memory,
    spills); raises ``RuntimeError`` with them if a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        # write beside the target and rename: a concurrent loader never
        # sees a half-written library
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    logs: Dict[str, str] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: Mapping[str, Sequence[type]]
         ) -> ctypes.CDLL:
    """Build (if needed) and load one kernel's library; declare each C
    function's argument types (``restype`` is the ``cudaError_t`` the
    function returns) and the library's ``kernel_error_string``."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        lib.kernel_error_string.restype = ctypes.c_char_p
        _LOADED[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error: a refused
    launch never runs, and no later synchronize reports it."""
    if code != 0:
        msg: Optional[bytes] = lib.kernel_error_string(code)
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({msg.decode() if msg else 'unknown'})")


def shared_memory_optin(lib: ctypes.CDLL, index: int) -> int:
    """The largest shared memory a block may opt in to on device
    ``index`` (``cudaDevAttrMaxSharedMemoryPerBlockOptin``, through the
    library's ``shared_memory_optin``: torch's device properties do not
    carry it), asked once a device."""
    limit = _SMEM_OPTIN.get(index)
    if limit is None:
        got = ctypes.c_int(0)
        check(lib, lib.shared_memory_optin(index, ctypes.byref(got)),
              "shared_memory_optin")
        limit = _SMEM_OPTIN[index] = got.value
    return limit


def multiprocessors(index: int) -> int:
    """The streaming multiprocessors of device ``index``, asked once a
    device (the wrappers size grids and tiles by them)."""
    sms = _SMS.get(index)
    if sms is None:
        import torch
        sms = _SMS[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return sms
