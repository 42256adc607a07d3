"""The torch port's kernels on the CPU: their plain versions against the
JAX package's Pallas kernels, and the wrappers' contract.

The Pallas kernels run as tests/test_kernels.py runs them (interpret
mode on the CPU), at its shapes and tolerances: matmul 1e-4 for f32 and
2e-1 for bf16, histogram exact.  Inputs are made from a seed with numpy
and handed to both packages.  The CUDA kernels themselves run only on
the card (tests/test_torch_cuda.py); on a CPU tensor a wrapper takes
its plain version and launches nothing.
"""
import ast
import os
import re
import stat
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.histogram import histogram as jax_histogram
from repro.kernels.matmul import matmul as jax_matmul
from repro_torch.core.bridge import from_numpy
from repro_torch.kernels import _build
from repro_torch.kernels.histogram import histogram, histogram_ref
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.matmul import bf16_ulp_error, matmul, matmul_ref
from repro_torch.kernels.matmul import ops as matmul_ops

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-1)}


@pytest.mark.parametrize("m,k,n,bm,bk,bn", [
    (128, 64, 96, 64, 32, 32),
    (256, 256, 256, 128, 128, 128),
    (64, 128, 64, 64, 64, 64),
])
@pytest.mark.parametrize("dtype", list(_DTYPES))
def test_matmul_plain_matches_pallas(m, k, n, bm, bk, bn, dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((m, k), np.float32) * 0.5, jdt)
    y = jnp.asarray(rng.standard_normal((k, n), np.float32) * 0.5, jdt)
    out = jax_matmul(x, y, bm=bm, bk=bk, bn=bn)
    want = np.asarray(out, np.float32)
    tx, ty = from_numpy((np.asarray(x), np.asarray(y)))
    assert tx.dtype == tdt
    before = matmul_ops.launches
    got = matmul(tx, ty)
    assert matmul_ops.launches == before
    assert got.dtype == tdt and tuple(got.shape) == (m, n)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)
    np.testing.assert_allclose(matmul_ref(tx, ty).float().numpy(), want,
                               atol=tol, rtol=tol)
    if tdt == torch.bfloat16:
        # the Pallas kernel accumulates in float32 and rounds once too
        assert bf16_ulp_error(from_numpy(np.asarray(out)), tx, ty) <= 2.0


def test_bf16_ulp_error_fails_a_bfloat16_sum():
    """The card's bf16 check: another float32 summation order stays
    within one ulp of the rounded product, a bfloat16 sum does not."""
    rng = np.random.default_rng(1)
    x, y = from_numpy((rng.standard_normal((64, 256), np.float32) / 16,
                       rng.standard_normal((256, 48), np.float32)))
    x, y = x.bfloat16(), y.bfloat16()
    fp32 = torch.zeros(64, 48)
    bf16 = torch.zeros(64, 48, dtype=torch.bfloat16)
    for k in reversed(range(256)):
        term = x[:, k:k + 1].float() * y[k:k + 1, :].float()
        fp32 += term
        bf16 = (bf16.float() + term).bfloat16()
    assert bf16_ulp_error(matmul_ref(x, y), x, y) == 0.0
    assert bf16_ulp_error(fp32.bfloat16(), x, y) <= 1.0
    assert bf16_ulp_error(bf16, x, y) > 100.0
    # the reference's own bf16 tolerance lets the bfloat16 sum through
    torch.testing.assert_close(bf16.float(), matmul_ref(x, y).float(),
                               atol=2e-1, rtol=2e-1)


@pytest.mark.parametrize("n,bins,chunk", [(4096, 64, 512), (8192, 256, 1024),
                                          (1024, 16, 256)])
@pytest.mark.parametrize("out_of_range", [False, True])
def test_histogram_plain_matches_pallas(n, bins, chunk, out_of_range):
    """Exact counts; values outside [0, bins) match no one-hot column in
    the Pallas kernel, and the port drops them too."""
    rng = np.random.default_rng(0)
    lo, hi = (-(bins // 4), bins + bins // 4) if out_of_range else (0, bins)
    x = rng.integers(lo, hi, n, dtype=np.int32)
    want = np.asarray(jax_histogram(jnp.asarray(x), bins, chunk=chunk))
    before = histogram_ops.launches
    got = histogram(from_numpy(x), bins)
    assert histogram_ops.launches == before
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(histogram_ref(from_numpy(x), bins).numpy(),
                                  want)


@pytest.mark.parametrize("args,err,match", [
    ((torch.ones(4), torch.ones(4, 2)), ValueError, "do not multiply"),
    ((torch.ones(4, 3), torch.ones(4, 2)), ValueError, "do not multiply"),
    ((torch.ones(4, 3, dtype=torch.int32), torch.ones(3, 2, dtype=torch.int32)),
     TypeError, "dtypes"),
    ((torch.ones(4, 3), torch.ones(3, 2, dtype=torch.bfloat16)), TypeError,
     "dtypes"),
    ((torch.ones(3, 4).t(), torch.ones(3, 2)), ValueError, "contiguous"),
])
def test_matmul_wrapper_rejects(args, err, match):
    with pytest.raises(err, match=match):
        matmul(*args)


@pytest.mark.parametrize("x,bins,err,match", [
    (torch.zeros(4, 2, dtype=torch.int32), 8, ValueError, "1-D"),
    (torch.zeros(8, dtype=torch.int64), 8, TypeError, "int32"),
    (torch.zeros(8, dtype=torch.float32), 8, TypeError, "int32"),
    (torch.zeros(16, dtype=torch.int32)[::2], 8, ValueError, "contiguous"),
    (torch.zeros(8, dtype=torch.int32), 0, ValueError, "positive"),
    (torch.zeros(8, dtype=torch.int32), 8.0, ValueError, "positive"),
])
def test_histogram_wrapper_rejects(x, bins, err, match):
    with pytest.raises(err, match=match):
        histogram(x, bins)


def test_wrappers_are_custom_ops():
    """Both go through the dispatcher as repro_torch:: ops with a fake
    (shape) implementation, so a FLOP counter can see them; matmul's op
    takes the resolved tile (bm, bn, bk) as ints."""
    x, y = torch.ones(8, 4), torch.ones(4, 6)
    torch.library.opcheck(torch.ops.repro_torch.matmul.default,
                          (x, y, 128, 64, 16),
                          test_utils=("test_schema", "test_faketensor"))
    h = torch.arange(10, dtype=torch.int32)
    torch.library.opcheck(torch.ops.repro_torch.histogram.default, (h, 7),
                          test_utils=("test_schema", "test_faketensor"))
    assert torch.equal(torch.ops.repro_torch.histogram(h, 7),
                       histogram_ref(h, 7))


def test_histogram_grid_size():
    """Whole clusters, about ITEMS_PER_THREAD values a thread, capped at
    the clusters the card holds at once; a small input still gets one
    whole cluster."""
    cluster = histogram_ops.CLUSTER
    per_cluster = histogram_ops.THREADS * histogram_ops.ITEMS_PER_THREAD \
        * cluster
    assert histogram_ops.grid_size(1, 16) == cluster
    assert histogram_ops.grid_size(per_cluster, 16) == cluster
    assert histogram_ops.grid_size(per_cluster + 1, 16) == 2 * cluster
    assert histogram_ops.grid_size(1 << 28, 16) == 16 * cluster
    assert histogram_ops.grid_size(1 << 28, 0) == cluster
    # the main path's largest shape: 2^20 values, 128 blocks, as the old
    # one-merge-per-block grid had on 132 SMs
    assert histogram_ops.grid_size(1 << 20, 132) == 128
    assert histogram_ops.CLUSTER in (1, 2, 4, 8, 16)


#: chip_smoke.py's profiler filter of each kernel's device time.
_PROFILER_FILTERS = {"matmul": "MATMUL_KERNELS",
                     "histogram": "HISTOGRAM_KERNELS",
                     "flash_attention": "FLASH_KERNELS",
                     "rmsnorm": "RMSNORM_KERNELS", "ssd_scan": "SSD_KERNELS",
                     "decode_attention": "DECODE_KERNELS"}


@pytest.mark.parametrize("name", sorted(_PROFILER_FILTERS))
def test_profiler_filters_cover_every_kernel(name):
    """chip_smoke.py's device time counts the profiler events whose names
    hold one of a tuple of names: every __global__ of a kernel's source
    must match one, or its time silently drops out of device_ms."""
    assert set(_PROFILER_FILTERS) == set(_build.kernel_names())
    src = _build.source(name).read_text()
    globals_ = re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        src)
    assert globals_ and len(globals_) == src.count("__global__"), name
    smoke = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    consts = {t.id: ast.literal_eval(node.value)
              for node in ast.parse(open(smoke).read()).body
              if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Name)
              and t.id.endswith("_KERNELS")}
    names = consts[_PROFILER_FILTERS[name]]
    for fn in globals_:
        assert any(n in fn for n in names), (fn, names)


def test_kernel_modules_import_without_nvcc():
    """Importing and calling on CPU tensors builds nothing: with no
    nvcc reachable the wrappers still import and work."""
    code = (
        "import torch\n"
        "from repro_torch.kernels import _build\n"
        "from repro_torch.kernels.matmul import matmul, ops as mo\n"
        "from repro_torch.kernels.histogram import histogram, ops as ho\n"
        "import repro_torch.scopes.mxu_scope, repro_torch.scopes.histo_scope\n"
        "matmul(torch.ones(2, 2), torch.ones(2, 2))\n"
        "histogram(torch.zeros(4, dtype=torch.int32), 2)\n"
        "assert not _build._LOADED and mo.launches == ho.launches == 0\n"
        "try:\n"
        "    _build.nvcc()\n"
        "except RuntimeError as e:\n"
        "    print('NO-NVCC', e)\n")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable),
               CUDA_HOME="/nonexistent")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "NO-NVCC" in r.stdout


def _fake_nvcc(tmp_path, body: str) -> None:
    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)


@pytest.fixture
def build_root(tmp_path, monkeypatch):
    """Kernel sources and the build directory under tmp_path, and a PATH
    holding only the fake nvcc the test writes."""
    for name in ("matmul", "histogram"):
        csrc = tmp_path / "kernels" / name / "csrc"
        csrc.mkdir(parents=True)
        (csrc / f"{name}.cu").write_bytes(_build.source(name).read_bytes())
    hopper = tmp_path / "kernels" / "_hopper"
    hopper.mkdir()
    (hopper / "hopper.cuh").write_bytes(
        (_build.KERNELS_DIR / "_hopper" / "hopper.cuh").read_bytes())
    monkeypatch.setattr(_build, "KERNELS_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path / "bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    return tmp_path


def test_build_compiles_for_sm90a_once_per_source(build_root):
    # the fake compiler logs its arguments and writes the -o file
    _fake_nvcc(build_root, 'echo "$@" >> "${0%/*}/calls"\n'
               'while [ "$1" != "-o" ]; do shift; done; echo lib > "$2"\n')
    logs = _build.build(["matmul", "histogram"])
    assert set(logs) == {"matmul", "histogram"}
    calls = (build_root / "bin" / "calls").read_text().splitlines()
    assert len(calls) == 2
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" in c
               for c in calls)
    # the sources include "_hopper/hopper.cuh": kernels/ is on the path
    assert all(f"-I {build_root / 'kernels'} " in c for c in calls)
    assert _build.kernel_names() == ["histogram", "matmul"]
    libs = {_build.library_path(n) for n in ("matmul", "histogram")}
    assert all(p.exists() and p.parent == build_root / "build"
               for p in libs)
    assert _build.build(["matmul", "histogram"]) == {}   # up to date
    # an edited source gets a new library name, so it rebuilds
    src = _build.source("matmul")
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path("matmul") not in libs
    assert set(_build.build(["matmul", "histogram"])) == {"matmul"}
    assert not list((build_root / "build").glob("*.tmp"))


def test_build_failure_raises_with_compiler_output(build_root):
    _fake_nvcc(build_root, 'echo "error: no such intrinsic"; exit 1\n')
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(["histogram"])
    assert not _build.library_path("histogram").exists()


def test_build_without_nvcc_raises(build_root):
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build(["matmul"])


def test_library_path_follows_the_hopper_header(build_root):
    """An edited shared header gets every kernel a new library name, so
    no stale library is loaded; an unchanged one keeps the name."""
    before = {n: _build.library_path(n) for n in ("matmul", "histogram")}
    assert before == {n: _build.library_path(n) for n in before}
    header = build_root / "kernels" / "_hopper" / "hopper.cuh"
    assert _build.headers("matmul") == [header]
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in before}
    assert all(after[n] != before[n] for n in before)
    # a header beside one kernel's source moves only that kernel's name
    (build_root / "kernels" / "matmul" / "csrc" / "tiles.cuh").write_text(
        "#pragma once\n")
    assert _build.library_path("matmul") != after["matmul"]
    assert _build.library_path("histogram") == after["histogram"]


_ALIGNED = 1 << 20   # a base on 16 bytes (the allocator gives 256)


@pytest.mark.parametrize("m,k,n,dtype,x_ptr,y_ptr,want", [
    (1024, 1024, 1024, torch.bfloat16, _ALIGNED, _ALIGNED, "wgmma"),
    (1000, 1536, 776, torch.bfloat16, _ALIGNED, _ALIGNED, "wgmma"),
    (128, 8, 8, torch.bfloat16, _ALIGNED, _ALIGNED, "wgmma"),
    (1, 8, 8, torch.bfloat16, _ALIGNED + 16, _ALIGNED + 48, "wgmma"),
    (1024, 1024, 1024, torch.float32, _ALIGNED, _ALIGNED, "simt"),
    (65, 17, 128, torch.bfloat16, _ALIGNED, _ALIGNED, "simt"),   # K % 8
    (1000, 1536, 777, torch.bfloat16, _ALIGNED, _ALIGNED, "simt"),  # N % 8
    (300, 0, 8, torch.bfloat16, _ALIGNED, _ALIGNED, "simt"),     # K == 0
    (200, 72, 136, torch.bfloat16, _ALIGNED + 2, _ALIGNED, "simt"),
    (200, 72, 136, torch.bfloat16, _ALIGNED, _ALIGNED + 8, "simt"),
])
def test_matmul_variant(m, k, n, dtype, x_ptr, y_ptr, want):
    assert matmul_ops.variant(m, k, n, dtype, x_ptr, y_ptr) == want


def test_matmul_variant_counts_stay_on_the_cpu():
    """A CPU product takes the plain version: no variant is counted."""
    before = dict(matmul_ops.launches_by_variant)
    matmul(torch.ones(16, 16, dtype=torch.bfloat16),
           torch.ones(16, 16, dtype=torch.bfloat16))
    assert matmul_ops.launches_by_variant == before
    assert set(before) == {"wgmma", "simt"}
