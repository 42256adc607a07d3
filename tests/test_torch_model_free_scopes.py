"""The torch port's model-free scopes (instr, comm, io) against the JAX
package's, on the CPU.

``python -m repro_torch run --device cpu`` over each scope must write
the instance names and record keys of ``python -m repro run``; the 24
modeled collective rows must equal the reference's exactly; each instr
op must compute the reference's function on the same input (GELU is the
tanh approximation); and the measured all-reduce must run on a
one-rank gloo group twice in one process and under ``--jobs 2``, and
refuse a card run on a gloo group.  The subprocesses inherit
``os.environ`` (jax's platform probe hangs without ``JAX_PLATFORMS``).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.scopes import comm_scope as ref_comm
from repro.scopes import instr_scope as ref_instr
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.runner import RunOptions, run_benchmarks
from repro_torch.core.scope import BUILTIN_SCOPES, ScopeManager
from repro_torch.scopes import comm_scope, instr_scope

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCOPES = ["instr", "comm", "io"]
MIN_TIME = "0.005"


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def cli(package, *args, timeout=300):
    return subprocess.run([sys.executable, "-m", package, *args],
                          capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=timeout)


@pytest.fixture
def on_cpu():
    """The scopes register and allocate on FLAGS' device: the CPU."""
    before = FLAGS.get("device")
    FLAGS.set("device", "cpu")
    yield
    FLAGS.set("device", before)


@pytest.fixture(scope="module")
def documents(tmp_path_factory):
    """One run of each package over the three scopes (CPU, nothing
    persisted): {package: document}."""
    tmp = tmp_path_factory.mktemp("docs")
    docs = {}
    for package, extra in (("repro_torch", ["--device", "cpu"]),
                           ("repro", [])):
        out = tmp / f"{package}.json"
        r = cli(package, "run", *extra,
                *[a for s in SCOPES for a in ("--enable-scope", s)],
                "--benchmark_min_time", MIN_TIME, "--results-dir", "",
                "--benchmark_out", str(out))
        assert r.returncode == 0, r.stderr[-3000:]
        with open(out) as f:
            docs[package] = json.load(f)
    return docs


def test_list_scopes_names_eight():
    r = cli("repro_torch", "--list-scopes")
    assert r.returncode == 0, r.stderr
    names = [line.split()[0] for line in r.stdout.splitlines() if line]
    assert sorted(names) == sorted(["example", "mxu", "histo", "nn",
                                    "linalg", "instr", "comm", "io"])
    assert len(BUILTIN_SCOPES) == 8


@pytest.mark.parametrize("scope", SCOPES)
def test_instances_and_record_keys_match_reference(documents, scope):
    def keys(doc):
        return {r["name"]: sorted(r) for r in doc["benchmarks"]
                if r["name"].startswith(scope + "/")}
    port, ref = keys(documents["repro_torch"]), keys(documents["repro"])
    assert port and list(port) == list(ref)
    assert port == ref
    errors = [r["name"] for r in documents["repro_torch"]["benchmarks"]
              if r.get("error_occurred")]
    assert errors == []
    status = documents["repro_torch"]["context"]["scopes"]
    assert sorted(s for s, st in status.items() if st == "enabled") == \
        sorted(SCOPES)


def test_modeled_collective_rows_equal_reference(documents):
    def modeled(doc):
        return {r["name"]: {k: r[k] for k in (
            "real_time", "time_unit", "iterations", "modeled_s",
            "axis_size", "bytes_per_second")}
            for r in doc["benchmarks"]
            if r["name"].startswith("comm/collective_modeled_v5e/")}
    port = modeled(documents["repro_torch"])
    assert len(port) == 24
    assert port == modeled(documents["repro"])


def test_modeled_formula_equals_reference():
    for kind in ("all_reduce", "all_gather", "reduce_scatter",
                 "all_to_all", "ppermute"):
        for nbytes in (1, 1 << 20, 1 << 24, 1 << 28, 12345):
            for axis in (0, 1, 2, 16, 256):
                assert comm_scope.modeled_collective_seconds(
                    kind, nbytes, axis) == \
                    ref_comm.modeled_collective_seconds(kind, nbytes, axis)
    assert comm_scope.modeled_collective_seconds(
        "all_reduce", 1 << 20, 16, link_bw=1e9) == \
        ref_comm.modeled_collective_seconds("all_reduce", 1 << 20, 16,
                                            link_bw=1e9)


def _fixtures(scope_module, registry):
    scope_module.SCOPE.register(registry)
    out = {}
    for bench in registry.all():
        for name, params in bench.instances():
            if bench.fixture is not None:
                out[name] = bench.fixture(params)
    return out


def test_instr_ops_match_jitted_reference(on_cpu):
    """Every instr instance's fixture: the operands agree, and the port's
    op on the reference's operand matches the reference's jitted op
    within 1e-6 — an exact-erf GELU misses by ~1e-4 at x = 1."""
    port = _fixtures(instr_scope, BenchmarkRegistry())
    ref = _fixtures(ref_instr, RefRegistry())
    assert sorted(port) == sorted(ref) and len(port) == 9
    for name in port:
        fn, x = port[name]
        rfn, rx = ref[name]
        np.testing.assert_allclose(x.numpy(), np.asarray(rx), rtol=0,
                                   atol=1e-7, err_msg=name)
        got = fn(torch.from_numpy(np.array(rx)))
        want = np.asarray(jax.jit(rfn)(rx))
        assert str(got.dtype).split(".")[-1] == want.dtype.name, name
        np.testing.assert_allclose(got.float().numpy(),
                                   want.astype(np.float32), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    fn, x = port["instr/elementwise/op:gelu/n:1048576"]
    exact = torch.nn.functional.gelu(x)
    assert float((exact - fn(x)).abs().max()) > 1e-5


def _comm_records():
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(["repro_torch.scopes.comm_scope"])
    mgr.register_all()
    benches = [b for b in mgr.registry.all()
               if b.name == "comm/all_reduce_measured"]
    doc = run_benchmarks(benches, RunOptions(min_time=0.002, device="cpu"),
                         progress=False)
    return doc["benchmarks"]


def test_all_reduce_runs_twice_in_one_process(on_cpu):
    """The second run reuses the process's gloo group: init_process_group
    may run once a process."""
    for _ in range(2):
        records = _comm_records()
        assert [r["name"] for r in records] == [
            f"comm/all_reduce_measured/bytes:{b}"
            for b in (1 << 16, 1 << 19, 1 << 22)]
        assert all(not r.get("error_occurred") and r["devices"] == 1
                   for r in records), records
    assert comm_scope.process_group("cpu") == "gloo"


def test_all_reduce_refuses_a_card_run_on_gloo(on_cpu):
    comm_scope.process_group("cpu")
    with pytest.raises(RuntimeError, match="needs nccl"):
        comm_scope.process_group("cuda")


def test_all_reduce_sums_over_the_ranks(on_cpu):
    comm_scope.process_group("cpu")
    x = torch.arange(8, dtype=torch.float32).reshape(1, 8)
    out = comm_scope._all_reduce(x)
    assert torch.equal(out, x) and out.data_ptr() != x.data_ptr()


def test_all_reduce_under_two_workers(tmp_path):
    out = tmp_path / "jobs2.json"
    r = cli("repro_torch", "run", "--device", "cpu", "--enable-scope",
            "comm", "--benchmark_filter", "comm/all_reduce", "--jobs", "2",
            "--benchmark_min_time", MIN_TIME, "--results-dir", "",
            "--benchmark_out", str(out))
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        records = json.load(f)["benchmarks"]
    assert len(records) == 3
    assert all(not r.get("error_occurred") and r["devices"] == 1
               for r in records), records
