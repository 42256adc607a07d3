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
     then counts the tensor-core instructions (``HGMMA``, ``HMMA``) in
     each library's ``cuobjdump -sass`` and fails if matmul or flash
     attention has no HGMMA (their bf16 ``wgmma`` variants); flash's
     HMMA count is logged (its float32 body runs on the CUDA cores);
  3. matmul kernel against its plain version on the card, f32 and bf16,
     with the reference's tolerances, plus times and the variant each
     shape took (``wgmma`` or ``simt``).  bf16 is also held to within
     ``BF16_MAX_ULPS`` of the float32 product rounded once to bf16,
     which a kernel that accumulates in bf16 fails;
  4. histogram kernel against its plain version, exact, plus times, at
     the histo scope's shapes, a ragged and a large n, values out of
     range, every value in one bin and a view one element into its
     storage; each shape's cluster size and grid, and the global merges
     that a model of the kernel's partition gives (logged only);
  5. flash-attention kernel against its plain version (``naive_attention``)
     at the nn scope's shapes, ragged ones (f32 full, bf16 causal), f32
     at head size 128 and 4096 tokens, and the attention of llama3.2-1b
     and internlm2-1.8b at 4096 tokens in bf16, with the reference's
     tolerances, plus times (``torch.nn.functional.
     scaled_dot_product_attention`` is the library yardstick).  Each
     float32 shape is also held to 2e-5 with inputs x4 (scores of tens),
     and carries the 3xTF32 tensor-core bound beside its CUDA-core one;
  6. rmsnorm kernel against its plain version at the nn scope's shapes, a
     ragged one and llama3.2-1b's width (and 8192) in bf16, plus times
     (``torch.nn.functional.rms_norm`` is the yardstick);
  7. SSD chunk kernel against its plain version, and ``ssd`` (kernel plus
     the inter-chunk recurrence in torch) against the sequential
     ``ssd_reference`` for ``y`` and the final state, at the nn scope's
     shapes, a ragged one, mamba2-780m's SSD layer, its widths at batch 8
     (several heads a block), 5 heads (a ragged head group) and dt x8
     (in-chunk cumsums of hundreds; there ``ssd`` is held to the plain
     chunked ``ssd_chunked``, and its distance from the sequential
     recurrence, which both chunked forms miss, is logged); each shape's variant and
     heads a block are logged, and the whole ``ssd`` call is split into
     the kernel and its torch remainder.  No single torch call computes
     it, so its library time is null;
  8. host path: each step of a histogram and a float32 flash wrapper
     call (argument checks, custom_op dispatch, output allocation, device
     and stream lookup, library lookup, the ctypes call, ``_build.check``)
     timed alone over ``HOST_CALLS`` calls on the host clock;
  9. the main path: ``repro_torch.core.main.main(["run", ...])`` over
     the example, mxu, histo and nn scopes, with the kernels' launch
     counts set to 0 just before and read just after.  Every scope must
     load and be enabled, every instance must have a record without
     error and with ``compile_time_s``, all five kernels must have
     launched, the mxu scope's bf16 ``cuda`` rows must have gone
     through matmul's ``wgmma`` variant, the nn scope's float32
     flash rows through flash attention's ``ffma`` variant and its
     ``ssd_scan_cuda`` rows through the SSD kernel's ``tiled_n64``;
 10. the same main path again in a child process under
     ``torch.profiler``: the device's idle share over its activity
     window;
 11. a ``{"host_path_us": ..., "main_path_idle": ...}`` line, then one
     ``{"kernels": [...]}`` line: per kernel its launches on the main
     path (with each variant's, for matmul, flash attention and SSD), its
     largest error against the plain version, and its time,
     the plain version's, the library call's and the card's bound, at
     the main path's largest shape (every shape under ``shapes``).
     ``ms`` is the time per call of back-to-back calls through the
     wrapper (CUDA events), ``device_ms`` the kernels alone (profiler);
 12. last line: ``{"ok": true, "device": {...}}``.

Every comparison holds the kernel to its plain version on the same
inputs with ``atol = rtol = tol``, ``tol`` being the reference's own
(tests/test_kernels.py): a relative term is needed where a bf16 output
of magnitude above 4 rounds one ulp (over 2e-2) away when the float32
sums differ in their last bit.
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
import torch.nn.functional as F  # noqa: E402

from repro_torch.core.sysinfo import target_hardware  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.histogram import histogram, histogram_ref  # noqa: E402
from repro_torch.kernels.histogram import ops as histogram_ops  # noqa: E402
from repro_torch.kernels.matmul import (bf16_ulp_error, matmul,  # noqa: E402
                                        matmul_ref)
from repro_torch.kernels.matmul import ops as matmul_ops  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref  # noqa: E402
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk,  # noqa: E402
                                          ssd_chunk_ref, ssd_chunked,
                                          ssd_reference)
from repro_torch.kernels.ssd_scan import ops as ssd_ops  # noqa: E402

#: The reference's tolerances (tests/test_kernels.py): atol = rtol.
MATMUL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-1}
#: bf16 output against the float32 product rounded once to bf16, in ulps
#: (see ``bf16_ulp_error``): summation order moves a value by at most one.
BF16_MAX_ULPS = 2.0
#: (M, K, N) per dtype: the mxu scope's sizes, a ragged shape each way
#: (bf16: ``simt``, as N or K is odd), a ragged bf16 shape that TMA can
#: load (``wgmma`` with ragged M and N tiles), llama3.2-1b's MLP
#: up-projection at 4096 tokens, and one large square bf16 product.
MATMUL_SHAPES = (
    [(torch.float32, s) for s in ((256, 256, 256), (512, 512, 512),
                                  (1024, 1024, 1024), (1000, 1536, 777),
                                  (1000, 777, 1536))]
    + [(torch.bfloat16, s) for s in ((256, 256, 256), (512, 512, 512),
                                     (1024, 1024, 1024), (1000, 1536, 777),
                                     (1000, 777, 1536), (1000, 1536, 776),
                                     (4096, 2048, 8192), (4096, 4096, 4096))])
#: (n, bins, case): the histo scope's grid, a ragged n and a large n of
#: uniform values; values outside [0, bins); every value in one bin (the
#: shared atomics' worst contention); and a view one element into its
#: storage (a scalar head before the 16-byte loads).
HISTOGRAM_SHAPES = [(n, b, "uniform") for n in (1 << 16, 1 << 20,
                                                (1 << 20) + 3, 1 << 28)
                    for b in (256, 4096)] + [
    ((1 << 20) + 3, 4096, "out_of_range"), (1 << 20, 4096, "one_hot_bin"),
    (1 << 20, 4096, "misaligned")]
#: The main path's largest shape of each kernel: the one the kernels line
#: reports at its top level.
MATMUL_HEADLINE = (torch.bfloat16, (1024, 1024, 1024))
HISTOGRAM_HEADLINE = (1 << 20, 4096, "uniform")

#: The reference's tolerances for the nn kernels (tests/test_kernels.py).
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 4e-2}
RMSNORM_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = 3e-5
#: (dtype, B, S, H, K, D, causal): the nn scope's flash_attention_cuda
#: rows, a ragged length without the causal mask, float32 at head size
#: 128 and 4096 tokens, the same causal in bf16 at llama3.2-1b's heads
#: (TMA fills the sequence's edge with zeros), llama3.2-1b (32 heads, 8
#: kv heads, head size 64) and internlm2-1.8b (16, 8, 128) at 4096.
FLASH_SHAPES = (
    [(torch.float32, 2, S, 4, 2, 64, True) for S in (256, 512, 1024)]
    + [(torch.float32, 2, 1000, 4, 2, 64, False),
       (torch.float32, 1, 4096, 4, 2, 128, True),
       (torch.bfloat16, 1, 1000, 32, 8, 64, True),
       (torch.bfloat16, 1, 4096, 32, 8, 64, True),
       (torch.bfloat16, 1, 4096, 16, 8, 128, True)])
FLASH_HEADLINE = FLASH_SHAPES[2]
#: (dtype, rows, d): the nn scope's rmsnorm rows, a ragged shape,
#: llama3.2-1b's d_model and the widest d the Pallas kernel took.
RMSNORM_SHAPES = [(torch.float32, 4096, 1024), (torch.float32, 4096, 4096),
                  (torch.bfloat16, 1000, 1000),
                  (torch.bfloat16, 4096, 2048), (torch.bfloat16, 4096, 8192)]
RMSNORM_HEADLINE = RMSNORM_SHAPES[1]
#: (b, l, h, p, n, chunk, dt scale): the nn scope's ssd_scan_cuda rows,
#: ragged widths, mamba2-780m's SSD layer (48 heads of 64, state 128),
#: its widths at batch 8 (4 heads a block on an H100), 5 heads (groups
#: of 2 and a last of one) and the nn scope's shape with dt x8.
SSD_SHAPES = [(2, 1024, 4, 64, 64, 128, 1.0), (2, 4096, 4, 64, 64, 128, 1.0),
              (1, 384, 3, 24, 40, 128, 1.0), (1, 4096, 48, 64, 128, 128, 1.0),
              (8, 512, 48, 64, 128, 128, 1.0), (4, 4096, 5, 64, 64, 128, 1.0),
              (2, 1024, 4, 64, 64, 128, 8.0)]
SSD_HEADLINE = SSD_SHAPES[1]


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


def device_ms(fn, kernels, calls: int = 20):
    """Device time per call of the CUDA kernels whose names hold one of
    ``kernels`` (a kernel's variants and passes), from a
    ``torch.profiler`` trace of ``calls`` calls: the kernels alone,
    without the host's launch path.  None when the trace shows no such
    kernel."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):   # a trace now and then comes back without kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        found = [e for e in prof.key_averages()
                 if any(k in e.key for k in kernels)]
        if found:
            return sum(e.device_time_total for e in found) / calls / 1e3
    return None


#: Profiler names of each kernel's ``__global__`` functions (each
#: variant's, and the ffma variant's combine pass): ``device_ms`` sums
#: the kernels a call launches.
MATMUL_KERNELS = ("matmul_simt_kernel", "matmul_wgmma_kernel")
FLASH_KERNELS = ("flash_attention_wgmma_kernel", "flash_attention_ffma_kernel",
                 "flash_attention_ffma_combine_kernel")
HISTOGRAM_KERNELS = ("histogram_kernel",)
RMSNORM_KERNELS = ("rmsnorm_kernel",)
SSD_KERNELS = ("ssd_chunk_tiled_kernel",)


def variant_of(ops, before: dict) -> str:
    """The variant that the one call since ``before`` launched."""
    ran = [v for v, n in ops.launches_by_variant.items() if n != before[v]]
    if len(ran) != 1:
        raise AssertionError(f"one launch expected, variants {ran}")
    return ran[0]


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


#: Tensor-core instructions each library must hold: the bf16 ``wgmma``
#: variants' HGMMA.
TENSOR_CORE_OPS = {"matmul": ("HGMMA",), "flash_attention": ("HGMMA",)}


def phase_build() -> dict:
    names = _build.kernel_names()
    t0 = time.perf_counter()
    logs = _build.build(names)
    log(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, text in logs.items():
        for line in text.splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "Compiling entry" in line or "warning" in line):
                log(f"  {name}: {line.strip()}")
    return phase_sass(names)


def phase_sass(names) -> dict:
    """Tensor-core instructions in each library's SASS: ``HGMMA`` (the
    warpgroup ``wgmma``) and ``HMMA`` (warp ``mma.sync``)."""
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    counts = {}
    for name in names:
        sass = subprocess.run(
            [cuobjdump, "-sass", str(_build.library_path(name))],
            capture_output=True, text=True, timeout=300, check=True).stdout
        counts[name] = {op: sum(1 for line in sass.splitlines()
                                if f" {op}." in line or f" {op} " in line)
                        for op in ("HGMMA", "HMMA")}
    log(f"sass tensor-core instructions: {counts}; flash_attention HMMA "
        f"{counts['flash_attention']['HMMA']} (float32 runs on the CUDA "
        f"cores: ffma)")
    for name, ops in TENSOR_CORE_OPS.items():
        for op in ops:
            if counts[name][op] == 0:
                raise AssertionError(f"{name}: no {op} in its library")
    return counts


def check_close(what, got, want, tol) -> float:
    """Largest absolute difference; raises past ``atol = rtol = tol``."""
    err = (got.float() - want.float()).abs().max().item() \
        if got.numel() else 0.0
    try:
        torch.testing.assert_close(got.float(), want.float(), atol=tol,
                                   rtol=tol)
    except AssertionError as e:
        raise AssertionError(f"{what}: {e}") from None
    return err


def tol_units(got, want, tol) -> float:
    """Largest |got - want| in units of ``tol + tol |want|`` (1 is the
    edge of ``check_close``)."""
    return ((got.float() - want.float()).abs()
            / (tol + tol * want.float().abs())).max().item()


def bound(hw, nbytes, ops, dtype) -> dict:
    """The least time for ``nbytes`` moved and ``ops`` done at the
    card's peak for ``dtype``: ``bound_ms`` and what bounds it."""
    peak = hw["peak_bf16_flops"] if dtype == torch.bfloat16 \
        else hw["peak_fp32_flops"]
    t_ops, t_bytes = ops / peak, nbytes / hw["hbm_bandwidth"]
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def phase_matmul(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = []
    for dtype, (M, K, N) in MATMUL_SHAPES:
        x = (torch.randn((M, K), generator=gen, device="cuda")
             / math.sqrt(K)).to(dtype)
        y = torch.randn((K, N), generator=gen, device="cuda").to(dtype)
        before = dict(matmul_ops.launches_by_variant)
        out = matmul(x, y)
        variant = variant_of(matmul_ops, before)
        tol = MATMUL_TOL[dtype]
        err = check_close(f"matmul {dtype} {M}x{K}x{N}", out,
                          matmul_ref(x, y), tol)
        ulps = None
        if dtype == torch.bfloat16:
            ulps = bf16_ulp_error(out, x, y)
            if ulps > BF16_MAX_ULPS:
                raise AssertionError(
                    f"matmul bf16 {M}x{K}x{N}: {ulps} ulps from the "
                    f"float32 product rounded once (limit {BF16_MAX_ULPS})")
        row = {
            "dtype": dname(dtype), "M": M, "K": K, "N": N,
            "variant": variant,
            "max_abs_err": err, "tol": tol, "max_ulp_err": ulps,
            "ms": time_ms(lambda: matmul(x, y)),
            "device_ms": device_ms(lambda: matmul(x, y), MATMUL_KERNELS),
            "plain_ms": time_ms(lambda: matmul_ref(x, y)),
            "library_ms": time_ms(lambda: torch.matmul(x, y)),
            **bound(hw, (M * K + K * N + M * N) * x.element_size(),
                    2.0 * M * N * K, dtype),
        }
        ulp_note = "" if ulps is None else f" ulps {ulps:.3g}"
        log(f"matmul {row['dtype']} {M}x{K}x{N} ({variant}): max_abs_err "
            f"{err:.3g} "
            f"(tol {tol}){ulp_note} kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms torch.matmul {row['library_ms']:.4f} "
            f"ms bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        shapes.append(((dtype, (M, K, N)), row))
    return summarize("matmul", "src/repro_torch/kernels/matmul/csrc/matmul.cu",
                     "src/repro/kernels/matmul/kernel.py:38",
                     "src/repro/kernels/matmul/kernel.py::matmul_pallas",
                     shapes, MATMUL_HEADLINE)


def histogram_input(n, bins, case, gen):
    if case == "one_hot_bin":
        return torch.full((n,), bins // 3, dtype=torch.int32, device="cuda")
    lo, hi = (-(bins // 4), bins + bins // 4) if case == "out_of_range" \
        else (0, bins)
    extra = 1 if case == "misaligned" else 0
    x = torch.randint(lo, hi, (n + extra,), generator=gen, device="cuda",
                      dtype=torch.int32)
    return x[extra:]


def histogram_merges(x, bins, blocks, cluster) -> dict:
    """A model, not a count on the device: the global atomics one call
    would make (the non-zero (cluster, bin) sums), and what one merge per
    block would make on the same grid, from a copy of the kernel's
    partition: block 0 takes the scalar head and tail, and int4 j of the
    aligned body goes to thread j mod (blocks * THREADS)."""
    n, threads = x.numel(), histogram_ops.THREADS
    head = min(n, (16 - x.data_ptr() % 16) % 16 // 4)
    nvec = (n - head) // 4
    i = torch.arange(n, device=x.device)
    block = torch.where((i >= head) & (i < head + 4 * nvec),
                        (i - head) // 4 % (blocks * threads) // threads, 0)
    keep = (x >= 0) & (x < bins)
    v, block = x[keep].long(), block[keep]
    return {"merges": torch.unique(block // cluster * bins + v).numel(),
            "merges_one_per_block": torch.unique(block * bins + v).numel()}


def phase_histogram(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    lib = _build.load("histogram", histogram_ops._SIGNATURES)
    shapes = []
    for n, bins, case in HISTOGRAM_SHAPES:
        x = histogram_input(n, bins, case, gen)
        out = histogram(x, bins)
        ref = histogram_ref(x, bins)
        torch.cuda.synchronize()
        err = (out.long() - ref.long()).abs().max().item()
        if not torch.equal(out, ref):
            raise AssertionError(f"histogram n={n} bins={bins} {case}: "
                                 f"kernel differs from plain (max {err})")
        cluster = histogram_ops.CLUSTER
        blocks = histogram_ops.grid_size(
            n, histogram_ops.max_clusters(lib, x.device.index, bins))
        model = histogram_merges(x, bins, blocks, cluster)
        row = {
            "n": n, "bins": bins, "case": case,
            "out_of_range": case == "out_of_range",
            "cluster": cluster, "blocks": blocks,
            "max_abs_err": err, "tol": 0,
            "ms": time_ms(lambda: histogram(x, bins)),
            "device_ms": device_ms(lambda: histogram(x, bins),
                                   HISTOGRAM_KERNELS),
            "plain_ms": time_ms(lambda: histogram_ref(x, bins)),
            "library_ms": (None if case == "out_of_range" else time_ms(
                lambda: torch.bincount(x, minlength=bins))),
            **bound(hw, (n + bins) * 4, 0.0, torch.int32),
        }
        lib_ms = "n/a" if row["library_ms"] is None \
            else f"{row['library_ms']:.4f} ms"
        log(f"histogram n={n} bins={bins} {case}: exact; {blocks} blocks in "
            f"clusters of {cluster}, {model['merges']} global merges by the "
            f"model (one a block: {model['merges_one_per_block']}); kernel "
            f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms torch.bincount {lib_ms} bound "
            f"{row['bound_ms']:.5f} ms")
        shapes.append(((n, bins, case), row))
    return summarize("histogram",
                     "src/repro_torch/kernels/histogram/csrc/histogram.cu",
                     "src/repro/kernels/histogram/kernel.py:29",
                     "src/repro/kernels/histogram/kernel.py::histogram_pallas",
                     shapes, HISTOGRAM_HEADLINE)


def flash_f32_x4(key, q, k, v, variant) -> float:
    """A float32 shape again with inputs x4 (scores of tens), through the
    same variant and held to 2e-5 of the plain version like the rest."""
    tol = FLASH_TOL[torch.float32]
    causal = key[-1]
    q4, k4, v4 = (t * 4 for t in (q, k, v))
    before = dict(flash_ops.launches_by_variant)
    out4 = flash_attention(q4, k4, v4, causal=causal)
    if variant_of(flash_ops, before) != variant:
        raise AssertionError(f"flash_attention {key} x4: another variant")
    err = check_close(f"flash_attention {key} x4", out4,
                      flash_attention_ref(q4, k4, v4, causal=causal), tol)
    log(f"  x4: max_abs_err {err:.3g} (tol {tol})")
    return err


def phase_flash(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    for key in FLASH_SHAPES:
        dtype, B, S, H, K, D, causal = key
        q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for shape in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
        tol = FLASH_TOL[dtype]
        before = dict(flash_ops.launches_by_variant)
        out = flash_attention(q, k, v, causal=causal)
        variant = variant_of(flash_ops, before)
        err = check_close(f"flash_attention {key}", out,
                          flash_attention_ref(q, k, v, causal=causal), tol)
        # (query, key) pairs the mask keeps: what the work depends on
        pairs = S * (S + 1) // 2 if causal else S * S
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        row = {
            "dtype": dname(dtype), "B": B, "S": S, "H": H, "K": K, "D": D,
            "causal": causal, "variant": variant, "max_abs_err": err,
            "tol": tol,
            "ms": time_ms(lambda: flash_attention(q, k, v, causal=causal)),
            "device_ms": device_ms(
                lambda: flash_attention(q, k, v, causal=causal),
                FLASH_KERNELS),
            "plain_ms": time_ms(
                lambda: flash_attention_ref(q, k, v, causal=causal)),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=H != K)),
            **bound(hw, 2 * (q.numel() + k.numel()) * q.element_size(),
                    4.0 * B * H * D * pairs, dtype),
        }
        log(f"flash_attention {row['dtype']} B={B} S={S} H={H} K={K} D={D}"
            f" causal={causal} ({variant}): max_abs_err {err:.3g} (tol {tol}) kernel "
            f"{row['ms']:.4f} ms (device {fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms sdpa {row['library_ms']:.4f} ms "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        if dtype == torch.float32:
            row["x4_max_abs_err"] = flash_f32_x4(key, q, k, v, variant)
            # three TF32 products a product on the tensor cores
            row["bound_3xtf32_ms"] = 3 * 4.0 * B * H * D * pairs \
                / hw["peak_tf32_flops"] * 1e3
        shapes.append((key, row))
    return summarize(
        "flash_attention",
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:70",
        "src/repro/kernels/flash_attention/kernel.py::flash_attention_pallas",
        shapes, FLASH_HEADLINE)


def phase_rmsnorm(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    for key in RMSNORM_SHAPES:
        dtype, rows, d = key
        x = torch.randn((rows, d), generator=gen, device="cuda").to(dtype)
        s = torch.randn((d,), generator=gen, device="cuda") + 1.0
        tol = RMSNORM_TOL[dtype]
        err = check_close(f"rmsnorm {key}", rmsnorm(x, s), rmsnorm_ref(x, s),
                          tol)
        # the library call takes its weight in x's type (a mixed pair is
        # not fused); the cast is made once, outside the timing
        s_lib = s.to(dtype)
        row = {
            "dtype": dname(dtype), "rows": rows, "d": d, "max_abs_err": err,
            "tol": tol,
            "ms": time_ms(lambda: rmsnorm(x, s)),
            "device_ms": device_ms(lambda: rmsnorm(x, s),
                                   RMSNORM_KERNELS),
            "plain_ms": time_ms(lambda: rmsnorm_ref(x, s)),
            "library_ms": time_ms(
                lambda: F.rms_norm(x, (d,), s_lib, 1e-6)),
            **bound(hw, 2 * x.numel() * x.element_size() + 4 * d,
                    4.0 * rows * d, dtype),
        }
        log(f"rmsnorm {row['dtype']} {rows}x{d}: max_abs_err {err:.3g} "
            f"(tol {tol}) kernel {row['ms']:.4f} ms (device "
            f"{fmt_ms(row['device_ms'])}) plain {row['plain_ms']:.4f} ms "
            f"F.rms_norm {row['library_ms']:.4f} ms bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
        shapes.append((key, row))
    return summarize("rmsnorm",
                     "src/repro_torch/kernels/rmsnorm/csrc/rmsnorm.cu",
                     "src/repro/kernels/rmsnorm/kernel.py:24",
                     "src/repro/kernels/rmsnorm/kernel.py::rmsnorm_pallas",
                     shapes, RMSNORM_HEADLINE)


def phase_ssd(hw: dict) -> dict:
    gen = torch.Generator("cuda").manual_seed(0)
    shapes = []
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key in SSD_SHAPES:
        b, l, h, p, n, Q, scale = key

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda")
        x = randn(b, l, h, p) * 0.4
        dt = F.softplus(randn(b, l, h)) * scale
        A = -torch.exp(randn(h) * 0.3)
        Bm, Cm = randn(b, l, 1, n) * 0.3, randn(b, l, 1, n) * 0.3
        D = torch.ones(h, device="cuda")
        B0, C0 = Bm[:, :, 0], Cm[:, :, 0]
        before = dict(ssd_ops.launches_by_variant)
        got = ssd_chunk(x, dt, A, B0, C0, chunk=Q)
        variant = variant_of(ssd_ops, before)
        group = ssd_ops.head_group(b, l // Q, h, sms)
        want = ssd_chunk_ref(x, dt, A, B0, C0, chunk=Q)
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"ssd_chunk {key}: non-finite output")
        err = max(check_close(f"ssd_chunk {key} {part}", g, w, SSD_TOL)
                  for part, g, w in zip(("y", "states", "ecs"), got, want))
        y, state = ssd(x, dt, A, Bm, Cm, D, chunk=Q)
        # with dt x8 the chunked form itself sits off the recurrence
        if scale == 1.0:
            oracle = ssd_reference
            y_ref, state_ref = ssd_reference(x, dt, A, Bm, Cm, D)
        else:
            oracle = ssd_chunked
            y_ref, state_ref = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q)
            y_seq, state_seq = ssd_reference(x, dt, A, Bm, Cm, D)
            log(f"  dt x{scale}: ssd from the sequential recurrence, in "
                f"units of atol + rtol |ref| (logged, not held): y "
                f"{tol_units(y, y_seq, SSD_TOL):.3f}, state "
                f"{tol_units(state, state_seq, SSD_TOL):.3f}; ssd_chunked:"
                f" y {tol_units(y_ref, y_seq, SSD_TOL):.3f}")
        err = max(err, check_close(f"ssd {key} y", y, y_ref, SSD_TOL),
                  check_close(f"ssd {key} state", state, state_ref, SSD_TOL))
        nc = l // Q
        tri = Q * (Q + 1) // 2
        # C.B once per (batch, chunk), shared by the heads; y and the
        # chunk state per head
        ops = 2.0 * (b * nc * tri * n + b * nc * h * (tri * p + Q * p * n))
        nbytes = 4 * (2 * x.numel() + 2 * dt.numel() + A.numel()
                      + 2 * B0.numel() + got[1].numel())
        row = {
            "b": b, "l": l, "h": h, "p": p, "n": n, "chunk": Q,
            "dt_scale": scale, "variant": variant, "heads_a_block": group,
            "ssd_oracle": oracle.__name__,
            "max_abs_err": err, "tol": SSD_TOL,
            "ms": time_ms(lambda: ssd_chunk(x, dt, A, B0, C0, chunk=Q)),
            "device_ms": device_ms(
                lambda: ssd_chunk(x, dt, A, B0, C0, chunk=Q),
                SSD_KERNELS),
            "plain_ms": time_ms(
                lambda: ssd_chunk_ref(x, dt, A, B0, C0, chunk=Q)),
            "library_ms": None,
            "ssd_ms": time_ms(lambda: ssd(x, dt, A, Bm, Cm, D, chunk=Q)),
            "ssd_chunked_ms": time_ms(
                lambda: ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q)),
            **bound(hw, nbytes, ops, torch.float32),
        }
        # the whole call less the kernel's: ssd's torch part
        row["ssd_torch_ms"] = row["ssd_ms"] - row["ms"]
        log(f"ssd_chunk b={b} l={l} h={h} p={p} n={n} chunk={Q} dt x{scale}"
            f" ({variant}, heads a block {group}): "
            f"max_abs_err {err:.3g} (tol {SSD_TOL}; ssd against "
            f"{oracle.__name__}) kernel {row['ms']:.4f}"
            f" ms (device {fmt_ms(row['device_ms'])}) plain "
            f"{row['plain_ms']:.4f} ms library none bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}); whole ssd "
            f"{row['ssd_ms']:.4f} ms (kernel {row['ms']:.4f}, torch "
            f"{row['ssd_torch_ms']:.4f}), ssd_chunked "
            f"{row['ssd_chunked_ms']:.4f} ms")
        shapes.append((key, row))
    return summarize("ssd_scan",
                     "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                     "src/repro/kernels/ssd_scan/kernel.py:50",
                     "src/repro/kernels/ssd_scan/kernel.py::ssd_chunk_pallas",
                     shapes, SSD_HEADLINE)


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


#: Each kernel's wrapper module, whose ``launches`` the main path reads.
KERNEL_OPS = {"matmul": matmul_ops, "histogram": histogram_ops,
              "flash_attention": flash_ops, "rmsnorm": rmsnorm_ops,
              "ssd_scan": ssd_ops}
#: Wrappers with variants of their own (``launches_by_variant``).
VARIANT_OPS = {"matmul": matmul_ops, "flash_attention": flash_ops,
               "ssd_scan": ssd_ops}


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


MAIN_SCOPES = ["example", "mxu", "histo", "nn"]


def main_argv(out: str) -> list:
    return ["run"] + [a for s in MAIN_SCOPES for a in ("--enable-scope", s)] \
        + ["--benchmark_min_time", "0.05", "--benchmark_out", out]


def phase_main_path() -> dict:
    from repro_torch.core.main import main
    scopes = MAIN_SCOPES
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "run.json")
        argv = main_argv(out)
        for ops in KERNEL_OPS.values():
            ops.launches = 0
        for ops in VARIANT_OPS.values():
            ops.launches_by_variant = dict.fromkeys(
                ops.launches_by_variant, 0)
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        launches = {name: ops.launches for name, ops in KERNEL_OPS.items()}
        by_variant = {name: dict(ops.launches_by_variant)
                      for name, ops in VARIANT_OPS.items()}
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
    # the mxu scope's bf16 cuda rows (n = 256..1024, fresh aligned
    # operands) are its only bf16 products: they take the tensor cores
    mxu_bf16 = [n for n in records
                if n.startswith("mxu/") and "backend:cuda" in n
                and "dtype:bf16" in n]
    if not mxu_bf16 or by_variant["matmul"]["wgmma"] == 0:
        raise AssertionError(f"mxu bf16 cuda rows {mxu_bf16} did not go "
                             f"through matmul's wgmma variant: "
                             f"{by_variant['matmul']}")
    # the nn scope's flash_attention_cuda rows are float32 with keys:
    # the ffma body
    nn_flash = [n for n in records if n.startswith("nn/flash_attention_cuda")]
    if not nn_flash or by_variant["flash_attention"]["ffma"] == 0:
        raise AssertionError(f"nn flash rows {nn_flash} did not go through "
                             f"flash attention's ffma variant: "
                             f"{by_variant['flash_attention']}")
    # the nn scope's ssd_scan_cuda rows (state size 64): the tiled body
    nn_ssd = [n for n in records if n.startswith("nn/ssd_scan_cuda")]
    if not nn_ssd or by_variant["ssd_scan"]["tiled_n64"] == 0:
        raise AssertionError(f"nn ssd rows {nn_ssd} did not go through the "
                             f"SSD kernel's tiled_n64 variant: "
                             f"{by_variant['ssd_scan']}")
    log(f"main path: {len(records)} records from {', '.join(scopes)} in "
        f"{wall:.1f} s on {ctx['device_kind']}; launches {launches}; by "
        f"variant {by_variant}")
    for name, r in records.items():
        if name.startswith(("mxu/", "histo/", "nn/")):
            log(f"  {name}: {r['real_time']:.3f} {r['time_unit']} "
                f"(compile {r['compile_time_s']:.3f} s)")
    return launches, by_variant


#: Run in a child process (the scopes register once a process): the
#: main path again under torch.profiler, CUDA activity only.  The union
#: of the device's activity spans against the window they cover gives
#: the device's idle share.
_IDLE_CHILD = """
import json, sys, tempfile, time
sys.path.insert(0, sys.argv[1])
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from repro_torch.core.main import main
with tempfile.TemporaryDirectory() as tmp:
    argv = json.loads(sys.argv[2]) + ["--benchmark_out", tmp + "/run.json"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rc = main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA)
busy, reach = 0, None
for a, b in spans:
    if reach is None or a > reach:
        busy += b - a
        reach = b
    elif b > reach:
        busy += b - reach
        reach = b
window = reach - spans[0][0] if spans else 0
print(json.dumps({"rc": rc, "wall_s": wall, "device_spans": len(spans),
                  "busy_s": busy / 1e9, "window_s": window / 1e9,
                  "idle_share": 1 - busy / window if window else None}))
"""


def phase_idle_share() -> dict:
    """The device's idle share over the main path (phase 8 run again,
    profiled, in a child process: the profiler's own cost on the host
    is in this run's wall, not in phase 8's records)."""
    r = subprocess.run(
        [sys.executable, "-c", _IDLE_CHILD, os.path.join(ROOT, "src"),
         json.dumps(main_argv("")[:-2])],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"profiled main path failed: {r.stderr[-3000:]}")
    got = json.loads(r.stdout.strip().splitlines()[-1])
    if got["rc"] != 0 or not got["device_spans"]:
        raise AssertionError(f"profiled main path: {got}")
    log(f"main path under torch.profiler: wall {got['wall_s']:.1f} s, "
        f"{got['device_spans']} device spans, busy {got['busy_s']:.3f} s of "
        f"a {got['window_s']:.3f} s window: idle share "
        f"{got['idle_share']:.4f}")
    return got


#: The host steps of one wrapper call, each timed alone over
#: ``HOST_CALLS`` calls (host clock, the device synchronised at the end
#: of each run).  Shapes whose device time stays below the host's, so
#: that the launch queue never holds the host back.
HOST_CALLS = 10000
HOST_HISTOGRAM = (1 << 20, 4096)
HOST_FLASH = (1, 64, 4, 2, 64)


def host_us(fn, calls: int = HOST_CALLS) -> float:
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def phase_host_path() -> dict:
    """Split a wrapper call's host time: the public function (argument
    checks), the custom_op dispatch, and inside the launch function the
    output allocation, the device and stream lookup, the library lookup,
    the ctypes call (which enqueues the launches) and ``_build.check``."""
    dev = torch.device("cuda", 0)

    def lookup():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    n, bins = HOST_HISTOGRAM
    x = torch.randint(0, bins, (n,), device=dev, dtype=torch.int32)
    hlib = _build.load("histogram", histogram_ops._SIGNATURES)
    fits = histogram_ops.max_clusters(hlib, 0, bins)
    h_out = torch.empty(bins, dtype=torch.int32, device=dev)
    h_args = (x.data_ptr(), n, h_out.data_ptr(), bins,
              histogram_ops.grid_size(n, fits), lookup())
    B, S, H, K, D = HOST_FLASH
    q, k, v = (torch.randn(sh, device=dev) for sh in
               ((B, S, H, D), (B, S, K, D), (B, S, K, D)))
    flib = _build.load("flash_attention", flash_ops._SIGNATURES)
    f_out = torch.empty_like(q)
    part = torch.empty(flash_ops.FFMA_SPLITS * B * S * H * (D + 2),
                       device=dev)
    f_args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), f_out.data_ptr(),
              part.data_ptr(), B, S, S, H, K, D, 1, 1.0 / math.sqrt(D),
              lookup())
    ffma = getattr(flib, flash_ops._SYMBOLS["ffma", torch.float32])
    steps = {
        "histogram": {
            "call": lambda: histogram(x, bins),
            "op": lambda: torch.ops.repro_torch.histogram(x, bins),
            "launch": lambda: histogram_ops._launch(x, bins),
            "alloc": lambda: torch.empty(bins, dtype=torch.int32,
                                         device=dev),
            "lookup": lookup,
            "load": lambda: _build.load("histogram",
                                        histogram_ops._SIGNATURES),
            "ctypes": lambda: hlib.histogram_i32(*h_args),
            "check": lambda: _build.check(hlib, 0, "histogram")},
        "flash_attention": {
            "call": lambda: flash_attention(q, k, v),
            "op": lambda: torch.ops.repro_torch.flash_attention(q, k, v,
                                                                True),
            "launch": lambda: flash_ops._launch(q, k, v, True),
            "alloc": lambda: (torch.empty_like(q), torch.empty(
                part.numel(), device=dev)),
            "lookup": lookup,
            "load": lambda: _build.load("flash_attention",
                                        flash_ops._SIGNATURES),
            "ctypes": lambda: ffma(*f_args),
            "check": lambda: _build.check(flib, 0, "flash_attention")}}
    split = {}
    for name, fns in steps.items():
        t = {step: host_us(fn) for step, fn in fns.items()}
        split[name] = {
            "us_per_call": t["call"],
            "argument_checks": t["call"] - t["op"],
            "custom_op_dispatch": t["op"] - t["launch"],
            "output_allocation": t["alloc"],
            "device_and_stream_lookup": t["lookup"],
            "library_lookup": t["load"],
            "ctypes_call": t["ctypes"],
            "build_check": t["check"],
            "rest_of_launch": t["launch"] - t["alloc"] - t["lookup"]
            - t["load"] - t["ctypes"] - t["check"]}
        log(f"host path {name} ({HOST_CALLS} calls each, us a call): "
            + ", ".join(f"{k} {v:.2f}" for k, v in split[name].items()))
    return split


def main() -> int:
    hw = phase_device()
    sass = phase_build()
    kernels = [phase_matmul(hw), phase_histogram(hw), phase_flash(hw),
               phase_rmsnorm(hw), phase_ssd(hw)]
    host = phase_host_path()
    launches, by_variant = phase_main_path()
    idle = phase_idle_share()
    for k in kernels:
        k["launches"] = launches[k["name"]]
        k["sass"] = sass[k["name"]]
        if k["name"] in by_variant:
            k["launches_by_variant"] = by_variant[k["name"]]
    print(json.dumps({"host_path_us": host, "main_path_idle": idle}),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
