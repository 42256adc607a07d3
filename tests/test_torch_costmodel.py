"""The torch port's cost-model meter (``--meters costmodel``) and the
FLOP formulas of the hand kernels' custom ops, on the CPU.

The reference's three cost-model tests (``tests/test_measure.py``) run
through the port; each custom op's formula is held to what
``FlopCounterMode`` counts for the kernel's plain version on the same
shapes (exactly: both are integer counts of the same products); and
the linalg scope's ``batched_matmul`` reports the ``flops`` the
reference's XLA cost model reports at the same point.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core import measure
from repro_torch.core.benchmark import Params, State
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.measure import CostModelMeter
from repro_torch.core.registry import BenchmarkRegistry, benchmark
from repro_torch.core.runner import RunOptions, run_benchmarks
from repro_torch.core.scope import ScopeManager
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.histogram import histogram, histogram_ref
from repro_torch.kernels.matmul import matmul, matmul_ref
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALL_METERS = RunOptions(min_time=0.002, meters=["wall", "cpu", "costmodel"],
                        device="cpu")


def _records(doc, run_type="iteration"):
    return [r for r in doc["benchmarks"] if r["run_type"] == run_type]


def _matmul_family(reg, n=64, fn=torch.matmul, name="mm"):
    """A torch matmul family following the (fn, *operands) fixture
    convention."""
    def setup(params):
        return fn, torch.ones((n, n)), torch.ones((n, n))

    @benchmark(scope="t", registry=reg, name=name)
    def mm(state):
        f, x, y = state.fixture
        while state.keep_running():
            state.deliver(f(x, y))
    mm.set_fixture(setup)
    return mm


def _flops(fn, *args, **kwargs):
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()


# ---------------------------------------------------------------------------
# the reference's cost-model tests
# ---------------------------------------------------------------------------

def test_cost_model_counters_exact_for_matmul():
    reg = BenchmarkRegistry()
    _matmul_family(reg, n=64)
    doc = run_benchmarks(reg.all(), ALL_METERS, progress=False)
    rec = _records(doc)[0]
    assert rec["flops"] == 2.0 * 64 ** 3
    # one mm: two operands read, one result written, float32
    assert rec["bytes_accessed"] == 3 * 64 * 64 * 4
    assert rec["arithmetic_intensity"] == \
        rec["flops"] / rec["bytes_accessed"]
    per_iter_s = rec["real_time"] * 1e-6
    assert rec["flops_per_second"] == pytest.approx(
        rec["flops"] / per_iter_s, rel=1e-6)


def test_cost_model_analysis_runs_once_in_prepare(monkeypatch):
    """The analysis call happens in prepare (untimed, before the warm
    batch) and is cached per parameter point."""
    meter = CostModelMeter()
    calls = []
    real = meter._analyze
    monkeypatch.setattr(meter, "_analyze",
                        lambda st: calls.append(1) or real(st))
    fixture = (torch.matmul, torch.ones((16, 16)), torch.ones((16, 16)))
    st = State(params=Params({"n": 16}), fixture=fixture)
    meter.prepare(st)
    assert calls == [1]
    assert meter.end(st)["flops"] == 2.0 * 16 ** 3
    assert calls == [1]


def test_cost_model_degrades_without_fixture_convention():
    """A family whose fixture isn't (fn, *args), or whose call raises,
    gets no cost counters — and no error."""
    reg = BenchmarkRegistry()

    @benchmark(scope="t", registry=reg)
    def plain(state):
        while state.keep_running():
            pass

    def broken(x, y):
        raise RuntimeError("cannot be analyzed")

    def setup(params):
        return broken, torch.ones(2), torch.ones(2)

    @benchmark(scope="t", registry=reg)
    def raises(state):
        while state.keep_running():
            pass
    raises.set_fixture(setup)
    doc = run_benchmarks(reg.all(), ALL_METERS, progress=False)
    for rec in _records(doc):
        assert "flops" not in rec and "bytes_accessed" not in rec
        assert not rec.get("error_occurred")


# ---------------------------------------------------------------------------
# the custom ops' formulas
# ---------------------------------------------------------------------------

def _ssd_inputs(b, l, h, p, n):
    rng = np.random.default_rng(0)
    return (torch.from_numpy(rng.standard_normal((b, l, h, p), np.float32)),
            torch.from_numpy(rng.random((b, l, h), np.float32)),
            -torch.from_numpy(rng.random(h, np.float32)),
            torch.from_numpy(rng.standard_normal((b, l, n), np.float32)),
            torch.from_numpy(rng.standard_normal((b, l, n), np.float32)))


CASES = {
    "matmul": [((33, 17), (17, 9)), ((512, 256), (256, 256))],
    "flash_attention": [(2, 40, 4, 24, 2, 16, True),
                        (1, 64, 2, 64, 2, 32, False)],
    "ssd_chunk": [(2, 64, 3, 8, 12, 16), (1, 96, 2, 8, 8, 128)],
    "rmsnorm": [(10, 32), (3, 5, 64)],
    "histogram": [(100, 16), (1000, 256)],
}


def _op_calls(name, case):
    """(kernel wrapper call, plain version call) on CPU tensors."""
    rng = np.random.default_rng(1)
    if name == "matmul":
        x, y = (torch.from_numpy(rng.standard_normal(s, np.float32))
                for s in case)
        return (lambda: matmul(x, y)), (lambda: matmul_ref(x, y))
    if name == "flash_attention":
        B, Sq, H, Sk, K, D, causal = case
        q = torch.from_numpy(rng.standard_normal((B, Sq, H, D), np.float32))
        k, v = (torch.from_numpy(rng.standard_normal((B, Sk, K, D),
                                                     np.float32))
                for _ in range(2))
        return (lambda: flash_attention(q, k, v, causal=causal),
                lambda: flash_attention_ref(q, k, v, causal=causal))
    if name == "ssd_chunk":
        *shape, chunk = case
        args = _ssd_inputs(*shape)
        return (lambda: ssd_chunk(*args, chunk=chunk),
                lambda: ssd_chunk_ref(*args, chunk=chunk))
    if name == "rmsnorm":
        x = torch.from_numpy(rng.standard_normal(case, np.float32))
        s = torch.from_numpy(rng.standard_normal(case[-1], np.float32))
        return (lambda: rmsnorm(x, s)), (lambda: rmsnorm_ref(x, s))
    n, bins = case
    x = torch.from_numpy(rng.integers(0, bins, n, dtype=np.int32))
    return (lambda: histogram(x, bins)), (lambda: histogram_ref(x, bins))


@pytest.mark.parametrize("name,case", [(n, c) for n, cs in CASES.items()
                                       for c in cs])
def test_custom_op_formula_equals_plain_count(name, case):
    """The counter sees a custom op as one op and runs its body with
    the mode popped: without the formula it would count 0."""
    kernel, plain = _op_calls(name, case)
    assert _flops(kernel) == _flops(plain)
    if name in ("rmsnorm", "histogram"):
        assert _flops(plain) == 0       # elementwise / integer work
    else:
        assert _flops(plain) > 0


def test_torch_and_kernel_rows_report_the_same_counters():
    """The mxu scope's two backends on one point: ``torch.matmul`` and
    the kernel's custom op give the same flops and the same bytes (one
    op each: two operands, one result)."""
    reg = BenchmarkRegistry()
    _matmul_family(reg, n=48, fn=torch.matmul, name="lib")
    _matmul_family(reg, n=48, fn=matmul, name="kernel")
    lib, kernel = _records(run_benchmarks(reg.all(), ALL_METERS,
                                          progress=False))
    for key in ("flops", "bytes_accessed", "arithmetic_intensity"):
        assert lib[key] == kernel[key]
    assert lib["flops"] == 2.0 * 48 ** 3


def test_bytes_mode_skips_views():
    moved = measure._bytes_mode()
    x = torch.ones((4, 8))
    with moved:
        x.view(32).view(4, 8).t()
    assert moved.nbytes == 0
    with moved:
        x.t().reshape(32)          # not contiguous: the reshape copies
    assert moved.nbytes == 2 * 4 * 8 * 4


# ---------------------------------------------------------------------------
# the linalg scope against the reference's cost model
# ---------------------------------------------------------------------------

def test_batched_matmul_flops_equal_reference_cost_model():
    from repro.core.flags import FlagRegistry as RefFlagRegistry
    from repro.core.hooks import HookChain as RefHookChain
    from repro.core.registry import BenchmarkRegistry as RefRegistry
    from repro.core.runner import RunOptions as RefRunOptions
    from repro.core.runner import run_benchmarks as ref_run
    from repro.core.scope import ScopeManager as RefScopeManager

    point = {"dtype": ["f32"], "n": ["128"]}
    ref_mgr = RefScopeManager(registry=RefRegistry(),
                              flags=RefFlagRegistry(), hooks=RefHookChain())
    ref_mgr.load(["repro.scopes.linalg_scope"])
    ref_mgr.register_all()
    ref_doc = ref_run(ref_mgr.registry.filter("batched_matmul"),
                      RefRunOptions(min_time=0.002, param_filter=point,
                                    meters=["wall", "cpu", "costmodel"]),
                      progress=False)
    before = FLAGS.get("device")
    FLAGS.set("device", "cpu")
    try:
        mgr = ScopeManager(registry=BenchmarkRegistry(),
                           flags=FlagRegistry(), hooks=HookChain())
        mgr.load(["repro_torch.scopes.linalg_scope"])
        mgr.register_all()
        doc = run_benchmarks(mgr.registry.filter("batched_matmul"),
                             RunOptions(min_time=0.002, param_filter=point,
                                        meters=["wall", "cpu", "costmodel"],
                                        device="cpu"), progress=False)
    finally:
        FLAGS.set("device", before)
    (ref,), (port,) = _records(ref_doc), _records(doc)
    assert port["name"] == ref["name"] == \
        "linalg/batched_matmul/dtype:f32/b:8/n:128"
    assert port["flops"] == ref["flops"] == 2.0 * 8 * 128 ** 3
    assert port["bytes_accessed"] > 0


def test_costmodel_cli_on_linalg_and_mxu(tmp_path):
    """``--meters costmodel`` through ``python -m repro_torch run`` on
    the CPU: every linalg and mxu row carries the counters, and every
    matmul row reports 2·m·n·k."""
    out = tmp_path / "cost.json"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(ROOT, "src"),
                      os.environ.get("PYTHONPATH")])))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--device", "cpu",
         "--enable-scope", "linalg", "--enable-scope", "mxu",
         "--param", "n=256", "--param", "n=128",
         "--meters", "wall,cpu,costmodel", "--results-dir", "",
         "--benchmark_min_time", "0.01", "--benchmark_out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr
    recs = {rec["name"]: rec for rec in json.loads(out.read_text())
            ["benchmarks"]}
    mxu = [n for n in recs if n.startswith("mxu/")]
    assert len(mxu) == 2
    for name in mxu:
        assert recs[name]["flops"] == 2.0 * 256 ** 3
    assert recs["linalg/batched_matmul/dtype:bf16/b:8/n:256"]["flops"] == \
        2.0 * 8 * 256 ** 3
    for name, rec in recs.items():
        assert not rec.get("error_occurred"), name
        assert rec["bytes_accessed"] > 0, name
        if "flops" in rec and name.startswith(("mxu/", "linalg/batched")):
            assert rec["arithmetic_intensity"] == \
                rec["flops"] / rec["bytes_accessed"]
