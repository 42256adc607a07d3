#!/usr/bin/env python3
"""Smoke test of the torch port (``src/repro_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit, traceback, no
``ok`` line) when it fails:

  1. device — CUDA must be available; prints the card's name and power
     limit as ``nvidia-smi`` reports them;
  2. build — compiles every hand-written kernel from ``csrc/`` with
     ``nvcc`` (one process per source, all started together) into
     ``build/`` and prints the build seconds and ``ptxas`` resources;
  3. matmul kernel against its plain version on the card, f32 and bf16,
     with the reference's tolerances, plus times.  bf16 is also held to
     within ``BF16_MAX_ULPS`` of the float32 product rounded once to
     bf16, which a kernel that accumulates in bf16 fails;
  4. histogram kernel against its plain version, exact, plus times;
  5. the main path: ``repro_torch.core.main.main(["run", ...])`` over
     the example, mxu and histo scopes, with the kernels' launch counts
     set to 0 just before and read just after.  Every scope must load
     and be enabled, every instance must have a record without error and
     with ``compile_time_s``, and both kernels must have launched;
  6. one ``{"kernels": [...]}`` line: per kernel its launches on the main
     path, its largest error against the plain version, and its time,
     the plain version's, the library call's and the card's bound, at
     the main path's largest shape (every shape under ``shapes``).
     ``ms`` is the time per call of back-to-back calls through the
     wrapper (CUDA events), ``device_ms`` the kernel alone (profiler);
  7. last line: ``{"ok": true, "device": {...}}``.
"""
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.core.sysinfo import target_hardware  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.histogram import histogram, histogram_ref  # noqa: E402
from repro_torch.kernels.histogram import ops as histogram_ops  # noqa: E402
from repro_torch.kernels.matmul import (bf16_ulp_error, matmul,  # noqa: E402
                                        matmul_ref)
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402

#: The reference's tolerances (tests/test_kernels.py): atol = rtol.
MATMUL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-1}
#: bf16 output against the float32 product rounded once to bf16, in ulps
#: (see ``bf16_ulp_error``): summation order moves a value by at most one.
BF16_MAX_ULPS = 2.0
#: (M, K, N) per dtype: the mxu scope's sizes, a ragged shape each way,
#: and one large bf16 product.
MATMUL_SHAPES = (
    [(torch.float32, s) for s in ((256, 256, 256), (512, 512, 512),
                                  (1024, 1024, 1024), (1000, 1536, 777),
                                  (1000, 777, 1536))]
    + [(torch.bfloat16, s) for s in ((256, 256, 256), (512, 512, 512),
                                     (1024, 1024, 1024), (1000, 1536, 777),
                                     (1000, 777, 1536), (4096, 4096, 4096))])
#: (n, bins, out_of_range): the histo scope's grid, a ragged n, a large n,
#: and inputs with values outside [0, bins).
HISTOGRAM_SHAPES = [(n, b, False) for n in (1 << 16, 1 << 20, (1 << 20) + 3,
                                            1 << 28)
                    for b in (256, 4096)] + [((1 << 20) + 3, 4096, True)]
#: The main path's largest shape of each kernel: the one the kernels line
#: reports at its top level.
MATMUL_HEADLINE = (torch.bfloat16, (1024, 1024, 1024))
HISTOGRAM_HEADLINE = (1 << 20, 4096, False)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, target_s: float = 0.05, max_reps: int = 2000) -> float:
    """Time per call of back-to-back calls, from CUDA events around a
    run long enough to span ``target_s``, after a warm-up call.  Where
    the host cannot launch as fast as the device runs, this holds the
    host's share too (``device_ms`` is the kernel alone)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    reps = int(min(max_reps, max(3, target_s * 1e3 / max(
        start.elapsed_time(end), 1e-3))))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, calls: int = 20):
    """Mean device time of the CUDA kernel whose name holds ``kernel``,
    from a ``torch.profiler`` trace of ``calls`` calls: the kernel alone,
    without the host's launch path.  None when the trace shows no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    found = [e for e in prof.key_averages() if kernel in e.key]
    count = sum(e.count for e in found)
    return sum(e.device_time_total for e in found) / count / 1e3 \
        if count else None


def fmt_ms(t) -> str:
    return "not measured" if t is None else f"{t:.4f} ms"


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this script needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    return dict(target_hardware(name))


def phase_build() -> None:
    names = _build.kernel_names()
    t0 = time.perf_counter()
    logs = _build.build(names)
    log(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")


def phase_matmul(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = []
    for dtype, (M, K, N) in MATMUL_SHAPES:
        x = (torch.randn((M, K), generator=gen, device="cuda")
             / math.sqrt(K)).to(dtype)
        y = torch.randn((K, N), generator=gen, device="cuda").to(dtype)
        out = matmul(x, y)
        ref = matmul_ref(x, y)
        torch.cuda.synchronize()
        tol = MATMUL_TOL[dtype]
        err = (out.float() - ref.float()).abs().max().item()
        torch.testing.assert_close(out.float(), ref.float(), atol=tol,
                                   rtol=tol)
        ulps = None
        if dtype == torch.bfloat16:
            ulps = bf16_ulp_error(out, x, y)
            if ulps > BF16_MAX_ULPS:
                raise AssertionError(
                    f"matmul bf16 {M}x{K}x{N}: {ulps} ulps from the "
                    f"float32 product rounded once (limit {BF16_MAX_ULPS})")
        itemsize = x.element_size()
        flops = 2.0 * M * N * K
        nbytes = (M * K + K * N + M * N) * itemsize
        peak = hw["peak_bf16_flops"] if dtype == torch.bfloat16 \
            else hw["peak_fp32_flops"]
        t_ops, t_bytes = flops / peak, nbytes / hw["hbm_bandwidth"]
        row = {
            "dtype": str(dtype).replace("torch.", ""), "M": M, "K": K, "N": N,
            "max_abs_err": err, "tol": tol, "max_ulp_err": ulps,
            "ms": time_ms(lambda: matmul(x, y)),
            "device_ms": device_ms(lambda: matmul(x, y), "matmul_kernel"),
            "plain_ms": time_ms(lambda: matmul_ref(x, y)),
            "library_ms": time_ms(lambda: torch.matmul(x, y)),
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        }
        ulp_note = "" if ulps is None else f" ulps {ulps:.3g}"
        log(f"matmul {row['dtype']} {M}x{K}x{N}: max_abs_err {err:.3g} "
            f"(tol {tol}){ulp_note} kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms torch.matmul {row['library_ms']:.4f} "
            f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        shapes.append(((dtype, (M, K, N)), row))
    return summarize("matmul", "src/repro_torch/kernels/matmul/csrc/matmul.cu",
                     "src/repro/kernels/matmul/kernel.py:38",
                     "src/repro/kernels/matmul/kernel.py::matmul_pallas",
                     shapes, MATMUL_HEADLINE)


def phase_histogram(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    for n, bins, out_of_range in HISTOGRAM_SHAPES:
        lo, hi = (-(bins // 4), bins + bins // 4) if out_of_range \
            else (0, bins)
        x = torch.randint(lo, hi, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        out = histogram(x, bins)
        ref = histogram_ref(x, bins)
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"histogram n={n} bins={bins}: kernel "
                                 f"differs from plain (max {err})")
        nbytes = (n + bins) * 4
        row = {
            "n": n, "bins": bins, "out_of_range": out_of_range,
            "max_abs_err": err, "tol": 0,
            "ms": time_ms(lambda: histogram(x, bins)),
            "device_ms": device_ms(lambda: histogram(x, bins),
                                   "histogram_kernel"),
            "plain_ms": time_ms(lambda: histogram_ref(x, bins)),
            "library_ms": (None if out_of_range else time_ms(
                lambda: torch.bincount(x, minlength=bins))),
            "bound_ms": nbytes / hw["hbm_bandwidth"] * 1e3,
            "bound_by": "bytes",
        }
        lib = "n/a" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        log(f"histogram n={n} bins={bins}{' out-of-range' if out_of_range else ''}"
            f": exact; kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain {row['plain_ms']:.4f}"
            f" ms torch.bincount {lib} bound {row['bound_ms']:.5f} ms")
        shapes.append(((n, bins, out_of_range), row))
    return summarize("histogram",
                     "src/repro_torch/kernels/histogram/csrc/histogram.cu",
                     "src/repro/kernels/histogram/kernel.py:29",
                     "src/repro/kernels/histogram/kernel.py::histogram_pallas",
                     shapes, HISTOGRAM_HEADLINE)


def summarize(name, source, replaces, function, shapes, headline) -> dict:
    top = dict(shapes)[headline]
    return {
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces, "replaces_function": function,
        "launches": None,
        "max_abs_err": max(row["max_abs_err"] for _, row in shapes),
        "ms": top["ms"], "device_ms": top["device_ms"],
        "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"],
        "library_ms": top["library_ms"],
        "shapes": [row for _, row in shapes],
    }


def expected_instances() -> list:
    """Every instance the three scopes register, from a fresh registry."""
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.scope import ScopeManager
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load()
    mgr.register_all()
    return [name for b in mgr.registry.all() for name, _ in b.instances()]


def phase_main_path() -> dict:
    from repro_torch.core.main import main
    scopes = ["example", "mxu", "histo"]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run.json")
        argv = ["run"] + [a for s in scopes for a in ("--enable-scope", s)] \
            + ["--benchmark_min_time", "0.05", "--benchmark_out", out]
        matmul_ops.launches = 0
        histogram_ops.launches = 0
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        launches = {"matmul": matmul_ops.launches,
                    "histogram": histogram_ops.launches}
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"main path exited {rc}")
        with open(out) as f:
            doc = json.load(f)
    ctx = doc["context"]
    if ctx["scopes"] != {s: "enabled" for s in scopes}:
        raise AssertionError(f"scope status {ctx['scopes']}")
    if ctx["backend"] != "cuda" or ctx["device_kind"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"document not from the card: {ctx}")
    records = {r["name"]: r for r in doc["benchmarks"]}
    missing = [n for n in expected_instances() if n not in records]
    if missing:
        raise AssertionError(f"instances without a record: {missing}")
    for name, r in records.items():
        if r.get("error_occurred") or r.get("skipped"):
            raise AssertionError(f"{name}: {r.get('error_message')}")
        if "compile_time_s" not in r:
            raise AssertionError(f"{name}: no compile_time_s")
        if not (math.isfinite(r["real_time"]) and r["real_time"] > 0):
            raise AssertionError(f"{name}: real_time {r['real_time']}")
    for kernel, count in launches.items():
        if count == 0:
            raise AssertionError(f"the main path never launched {kernel}")
    log(f"main path: {len(records)} records from {', '.join(scopes)} in "
        f"{wall:.1f} s on {ctx['device_kind']}; launches {launches}")
    for name, r in records.items():
        if name.startswith(("mxu/", "histo/")):
            log(f"  {name}: {r['real_time']:.3f} {r['time_unit']} "
                f"(compile {r['compile_time_s']:.3f} s)")
    return launches


def main() -> int:
    hw = phase_device()
    phase_build()
    kernels = [phase_matmul(hw), phase_histogram(hw)]
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
