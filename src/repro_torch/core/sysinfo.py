"""System characterization context — what SCOPE puts in the JSON ``context``.

The torch port of ``repro.core.sysinfo``.  Google Benchmark's context
block (date, host, cpu info) is extended with the facts that make two
documents from the CUDA stack comparable: torch, CUDA and driver
versions, the device's name, SM count and compute capability, and the
TF32 switches that change what a float32 product computes.

``target_hardware`` names the card's entry in :data:`HOPPER`, the data
sheet table the scopes read peaks from.  On the CPU it is nominally the
H100 SXM, as the reference writes ``tpu_v5e`` on the CPU.
"""
from __future__ import annotations

import datetime
import hashlib
import json
import os
import platform
import shutil
import subprocess
import types
from typing import Any, Dict, Mapping, Optional

# Data-sheet peaks of the Hopper cards (NVIDIA H100 data sheet, dense
# rates without sparsity).  Immutable on purpose: benchmark bodies read
# these at call time.  SXM and PCIe parts differ in SM count, clocks and
# memory, so the table is keyed by the name torch.cuda reports.
H100_SXM = types.MappingProxyType({
    "name": "h100_sxm",
    "peak_bf16_flops": 989e12,     # FLOP/s, tensor cores, dense
    "peak_tf32_flops": 495e12,     # tensor cores, dense
    "peak_fp32_flops": 67e12,      # outside the tensor cores
    "hbm_bandwidth": 3.35e12,      # B/s
})
H100_PCIE = types.MappingProxyType({
    "name": "h100_pcie",
    "peak_bf16_flops": 756e12,
    "peak_tf32_flops": 378e12,
    "peak_fp32_flops": 51e12,
    "hbm_bandwidth": 2.0e12,
})
HOPPER: Mapping[str, Mapping[str, Any]] = types.MappingProxyType({
    "NVIDIA H100 80GB HBM3": H100_SXM,
    "NVIDIA H100 PCIe": H100_PCIE,
})


def target_hardware(device_name: Optional[str] = None) -> Mapping[str, Any]:
    """The data-sheet entry for a card by its torch device name.

    ``None`` (a CPU run) and unlisted names give the H100 SXM entry, the
    nominal target.
    """
    if device_name is None:
        return H100_SXM
    if device_name in HOPPER:
        return HOPPER[device_name]
    return H100_PCIE if "PCIe" in device_name else H100_SXM


def _cpu_info() -> Dict[str, Any]:
    info: Dict[str, Any] = {
        "machine": platform.machine(),
        "processor": platform.processor() or "unknown",
        "num_cpus": os.cpu_count() or 1,
    }
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    info["model_name"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return info


def _driver_version() -> str:
    smi = shutil.which("nvidia-smi")
    if smi is None:
        return "unavailable"
    try:
        out = subprocess.run(
            [smi, "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "unavailable"


def _torch_info(device: str) -> Dict[str, Any]:
    import torch
    info: Dict[str, Any] = {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda or "none",
        "backend": device,
        "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "cudnn_allow_tf32": bool(torch.backends.cudnn.allow_tf32),
    }
    if device == "cuda":
        props = torch.cuda.get_device_properties(torch.cuda.current_device())
        info.update({
            "driver_version": _driver_version(),
            "device_count": torch.cuda.device_count(),
            "device_kind": props.name,
            "sm_count": props.multi_processor_count,
            "compute_capability": f"{props.major}.{props.minor}",
            "target_hardware": target_hardware(props.name)["name"],
        })
    else:
        info.update({
            "driver_version": "none",
            "device_count": 1,
            "device_kind": "cpu",
            "sm_count": 0,
            "compute_capability": "none",
            "target_hardware": H100_SXM["name"],
        })
    return info


# Context keys that determine whether two runs are comparable: the
# machine, the accelerator stack and its numerics switches — NOT the
# date/run-id, which differ on every run by construction.
_DIGEST_KEYS = (
    "host_name", "machine", "processor", "num_cpus", "model_name",
    "torch_version", "cuda_version", "driver_version", "backend",
    "device_count", "device_kind", "sm_count", "compute_capability",
    "allow_tf32", "cudnn_allow_tf32", "target_hardware", "scope_version",
)


def context_digest(ctx: Dict[str, Any]) -> str:
    """Short stable digest of a context's comparability-relevant facts."""
    facts = {k: ctx.get(k) for k in _DIGEST_KEYS}
    blob = json.dumps(facts, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode("utf-8")).hexdigest()[:12]


def build_context(extra: Optional[Dict[str, Any]] = None,
                  device: str = "cuda") -> Dict[str, Any]:
    """The ``context`` object written at the top of every result JSON."""
    ctx: Dict[str, Any] = {
        "date": datetime.datetime.now().isoformat(timespec="seconds"),
        "host_name": platform.node(),
        "executable": "scope",
        "scope_version": "1.0.0-torch",
        "library_build_type": "release",
        "caches": [],
        **_cpu_info(),
        **_torch_info(device),
    }
    if extra:
        ctx.update(extra)
    return ctx
