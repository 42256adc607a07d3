"""The torch port's first slice as a whole, on the CPU: ``python -m
repro_torch run`` over the mxu and histo scopes against the JAX
package's run, and the scopes' functions on the reference's own fixture
inputs carried across with ``bridge.from_numpy``.

The port's ``torch`` backend stands where the reference's ``xla`` stood
and its ``cuda`` backend (the hand-written kernel) where ``pallas``
stood.  A CPU run leaves the ``cuda`` rows out, so the kernels' wrappers
are called directly here, where a CPU tensor takes the plain version.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core.flags import FlagRegistry as RefFlagRegistry
from repro.core.hooks import HookChain as RefHookChain
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.scope import ScopeManager as RefScopeManager
from repro_torch.core.bridge import from_numpy
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.scope import ScopeManager
from repro_torch.kernels.histogram import histogram as port_histogram
from repro_torch.kernels.matmul import matmul as port_matmul

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = {"xla": "torch", "pallas": "cuda"}   # reference → port


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def _run(package, args, out):
    argv = [sys.executable, "-m", package, "run", *args,
            "--benchmark_out", str(out)]
    argv += ["--results-dir", ""]
    return subprocess.run(argv, capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=600)


def _port_name(ref_name: str) -> str:
    parts = ref_name.split("/")
    return "/".join(f"backend:{BACKENDS[p.split(':', 1)[1]]}"
                    if p.startswith("backend:") else p for p in parts)


def test_slice_run_on_cpu_pairs_with_reference(tmp_path):
    args = ["--enable-scope", "mxu", "--enable-scope", "histo",
            "--param", "n=256", "--param", "n=65536",
            "--benchmark_min_time", "0.01"]
    r = _run("repro_torch", ["--device", "cpu", *args], tmp_path / "p.json")
    assert r.returncode == 0, r.stderr
    port = json.loads((tmp_path / "p.json").read_text())
    r = _run("repro", args, tmp_path / "r.json")
    assert r.returncode == 0, r.stderr
    ref = json.loads((tmp_path / "r.json").read_text())

    records = {rec["name"]: rec for rec in port["benchmarks"]}
    # a CPU document holds no backend:cuda record: no CUDA kernel ran
    assert sorted(records) == sorted(
        [f"mxu/matmul/backend:torch/dtype:{d}/n:256" for d in ("f32", "bf16")]
        + [f"histo/histogram/backend:torch/n:65536/bins:{k}"
           for k in (256, 4096)])
    for name, rec in records.items():
        assert not rec.get("error_occurred"), (name, rec)
        assert rec["real_time"] > 0 and rec["compile_time_s"] >= 0
    paired = [r for r in ref["benchmarks"] if "backend:xla" in r["name"]]
    assert len(paired) == len(records)
    for ref_rec in paired:
        rec = records[_port_name(ref_rec["name"])]
        assert sorted(rec) == sorted(ref_rec)
    mxu = records["mxu/matmul/backend:torch/dtype:bf16/n:256"]
    assert mxu["flops_per_call"] == 2.0 * 256 ** 3
    assert mxu["model_roofline_s"] == 2.0 * 256 ** 3 / 989e12
    ctx = port["context"]
    assert ctx["backend"] == "cpu" and ctx["allow_tf32"] is False
    assert ctx["scopes"] == {"example": "disabled", "mxu": "enabled",
                             "histo": "enabled", "nn": "disabled",
                             "linalg": "disabled", "instr": "disabled",
                             "comm": "disabled", "io": "disabled",
                             "model": "disabled", "serve": "disabled"}


def _families(mgr_cls, registry, flags, hooks, name):
    mgr = mgr_cls(registry=registry, flags=flags, hooks=hooks)
    mgr.load()
    mgr.configure(enable=[name])
    mgr.register_all()
    return {b.name: b for b in registry.all()}


def _fixture(families, family, **point):
    bench = families[family]
    for _, params in bench.instances():
        if dict(params) == point:
            return bench.fixture(params)
    raise KeyError(point)


@pytest.fixture
def port_on_cpu():
    """The port's fixtures allocate on FLAGS' device: the CPU here."""
    before = FLAGS.get("device")
    FLAGS.set("device", "cpu")
    yield
    FLAGS.set("device", before)


@pytest.mark.parametrize("ref_backend,dtype", [("xla", "f32"),
                                               ("xla", "bf16"),
                                               ("pallas", "f32")])
def test_mxu_on_reference_inputs(port_on_cpu, ref_backend, dtype):
    ref = _families(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                    RefHookChain(), "mxu")
    port = _families(ScopeManager, BenchmarkRegistry(), FlagRegistry(),
                     HookChain(), "mxu")
    fn, x, y = _fixture(ref, "mxu/matmul", backend=ref_backend, dtype=dtype,
                        n=256)
    want = np.asarray(fn(x, y), np.float32)
    tx, ty = from_numpy((np.asarray(x), np.asarray(y)))
    tol = 1e-4 if dtype == "f32" else 2e-1
    assert not [n for n, _ in port["mxu/matmul"].instances()
                if "backend:cuda" in n]
    pfn, px, _ = _fixture(port, "mxu/matmul", backend="torch", dtype=dtype,
                          n=256)
    assert px.dtype == tx.dtype and px.device.type == "cpu"
    for fn in (pfn, port_matmul):
        np.testing.assert_allclose(fn(tx, ty).float().numpy(), want,
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("ref_backend,bins", [("xla", 256), ("xla", 4096),
                                              ("pallas", 256)])
def test_histo_on_reference_inputs(port_on_cpu, ref_backend, bins):
    ref = _families(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                    RefHookChain(), "histo")
    port = _families(ScopeManager, BenchmarkRegistry(), FlagRegistry(),
                     HookChain(), "histo")
    fn, x = _fixture(ref, "histo/histogram", backend=ref_backend, n=65536,
                     bins=bins)
    want = np.asarray(fn(x))
    tx = from_numpy(np.asarray(x))
    assert tx.dtype == torch.int32
    assert not [n for n, _ in port["histo/histogram"].instances()
                if "backend:cuda" in n]
    pfn, px = _fixture(port, "histo/histogram", backend="torch", n=65536,
                       bins=bins)
    assert px.dtype == torch.int32 and int(px.max()) < bins
    np.testing.assert_array_equal(pfn(tx).numpy(), want)
    np.testing.assert_array_equal(port_histogram(tx, bins).numpy(), want)


def test_run_without_cuda_exits_2():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would start")
    r = subprocess.run([sys.executable, "-m", "repro_torch", "run",
                        "--enable-scope", "example"], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 2
    assert "--device cpu" in r.stderr and not r.stdout


def test_port_imports_neither_jax_nor_repro():
    """Every module of the package, and chip_smoke.py, load without
    putting jax or any module of the JAX package in sys.modules."""
    code = (
        "import importlib, importlib.util, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', "
        f"{os.path.join(ROOT, 'chip_smoke.py')!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith('jax.') or m == 'repro' or\n"
        "             m.startswith('repro.'))\n"
        "print(len(names), bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=_env(), cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    count, bad = r.stdout.split(" ", 1)
    assert int(count) >= 20 and bad.strip() == "[]"
