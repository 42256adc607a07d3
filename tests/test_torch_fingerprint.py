"""The torch port's instance fingerprints
(``repro_torch.core.fingerprint``): the reference's
``tests/test_fingerprint.py`` cases on the port's families — digests are
deterministic across processes, change when, and only when, a digest
input changes (a body, a fixture, the torch version, a kernel's Python
module, a kernel's CUDA source or shared header, a tuned artifact for
the run's card), and drive delta planning and coverage — plus the
port's discovery of kernels imported at a scope module's top."""
import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from repro_torch.core import fingerprint as fp
from repro_torch.core.flags import FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.scope import ScopeManager
from repro_torch.kernels import tuning

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = ["repro_torch.scopes.example_scope"]
#: Every scope whose families reach a kernel, and two that reach none.
KERNEL_SCOPES = ["repro_torch.scopes.example_scope",
                 "repro_torch.scopes.mxu_scope",
                 "repro_torch.scopes.histo_scope",
                 "repro_torch.scopes.nn_scope",
                 "repro_torch.scopes.linalg_scope",
                 "repro_torch.scopes.instr_scope"]


def make_mgr(modules):
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(modules)
    mgr.register_all()
    return mgr


def example_benches():
    return make_mgr(EXAMPLE).registry.all()


def family(name, modules):
    return {b.name: b for b in make_mgr(modules).registry.all()}[name]


def rec(name, fingerprint, *, run_id="r1", ts="2026-08-01T00:00:00",
        sysinfo="m1", mean=1.0, **extra):
    out = {"run_id": run_id, "ts": ts, "name": name, "mean_s": mean,
           "stddev_s": 0.0, "n": 1, "errors": 0, "sysinfo": sysinfo,
           "verdict": "new", "fingerprint": fingerprint}
    out.update(extra)
    return out


# ---------------------------------------------------------------------------
# determinism
# ---------------------------------------------------------------------------

def test_fingerprints_stable_within_process():
    a = fp.registry_fingerprints(example_benches(), "cpu")
    b = fp.registry_fingerprints(example_benches(), "cpu")
    assert a and a == b
    assert all(len(v) == fp.DIGEST_LEN for v in a.values())


def test_fingerprints_stable_across_processes():
    """A fresh interpreter computes byte-identical digests (content-based
    inputs only — no paths, pids or times), kernel families included."""
    parent = fp.registry_fingerprints(
        make_mgr(KERNEL_SCOPES).registry.all(), "cpu")
    code = (
        "import json\n"
        "from repro_torch.core.fingerprint import registry_fingerprints\n"
        "from tests.test_torch_fingerprint import make_mgr, KERNEL_SCOPES\n"
        "print(json.dumps(registry_fingerprints("
        "make_mgr(KERNEL_SCOPES).registry.all(), 'cpu')))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src"), ROOT,
         env.get("PYTHONPATH", "")]).rstrip(os.pathsep)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == parent


def test_family_inputs_are_labeled_and_content_based():
    bench = {b.name: b for b in example_benches()}["example/axpy"]
    ins = fp.family_inputs(bench, "cpu")
    assert set(ins) == {"version", "body", "fixture", "sync", "meters",
                        "tunable", "kernels", "tuned", "torch", "cuda",
                        "nvcc"}
    assert "def axpy" in ins["body"]
    assert "def axpy_setup" in ins["fixture"]
    import torch
    assert ins["torch"] == torch.__version__
    blob = json.dumps(ins)
    assert ROOT not in blob


# ---------------------------------------------------------------------------
# sensitivity: each input moves the digest; nothing else does
# ---------------------------------------------------------------------------

def axpy():
    return {b.name: b for b in example_benches()}["example/axpy"]


def test_digest_changes_on_body_edit():
    a, b = axpy(), axpy()
    b.source = b.source + "  # edited\n"
    assert fp.family_digest(a, "cpu") != fp.family_digest(b, "cpu")


def test_digest_changes_on_fixture_edit():
    a, b = axpy(), axpy()
    b.fixture_source = b.fixture_source + "  # edited\n"
    assert fp.family_digest(a, "cpu") != fp.family_digest(b, "cpu")


@pytest.mark.parametrize("key", ["torch", "cuda", "nvcc"])
def test_digest_changes_on_stack_version(monkeypatch, key):
    a = fp.family_digest(axpy(), "cpu")
    real = fp._stack_versions()
    monkeypatch.setattr(fp, "_stack_versions",
                        lambda: dict(real, **{key: "99.0.0"}))
    assert fp.family_digest(axpy(), "cpu") != a


def test_nvcc_release_is_read_once(monkeypatch):
    first = fp._nvcc_release()
    monkeypatch.setattr(fp.subprocess, "run", None)    # a second call fails
    assert fp._nvcc_release() == first


def test_digest_changes_on_kernel_python_source(monkeypatch):
    """A family importing a kernel re-fingerprints when any module in the
    kernel's transitive closure changes."""
    bench = axpy()
    bench.source = ("def body(state):\n"
                    "    from repro_torch.kernels.matmul import matmul\n")
    base = fp.family_digest(bench, "cpu")
    real = fp._module_source
    monkeypatch.setattr(
        fp, "_module_source",
        lambda m: (real(m) or "") + "# patched\n"
        if m == "repro_torch.kernels.matmul.ops" else real(m))
    assert fp.family_digest(bench, "cpu") != base


def _all_fingerprints():
    return fp.registry_fingerprints(make_mgr(KERNEL_SCOPES).registry.all(),
                                    "cpu")


@pytest.fixture
def kernels_copy(tmp_path, monkeypatch):
    """A copy of the kernels root the digests read instead of the tree."""
    root = tmp_path / "kernels"
    shutil.copytree(fp._kernels_root(), root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    monkeypatch.setattr(fp, "_kernels_root", lambda: str(root))
    return root


def _changed(before, after):
    return sorted({name.split("/")[0] + "/" + name.split("/")[1]
                   for name in before if before[name] != after[name]})


def test_cuda_source_edit_changes_exactly_its_families(kernels_copy):
    """Editing ``matmul.cu`` re-fingerprints every mxu and linalg family
    (their modules import the matmul kernel at the top) and no example,
    histo, nn or instr family."""
    before = _all_fingerprints()
    cu = kernels_copy / "matmul" / "csrc" / "matmul.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    changed = _changed(before, _all_fingerprints())
    assert "mxu/matmul" in changed and "linalg/matmul_rect" in changed
    assert {c.split("/")[0] for c in changed} == {"mxu", "linalg"}
    linalg = {n.split("/")[1] for n in before if n.startswith("linalg/")}
    assert {c for c in changed if c.startswith("linalg/")} == \
        {f"linalg/{f}" for f in linalg}


def test_shared_header_edit_changes_every_kernel_family(kernels_copy):
    before = _all_fingerprints()
    header = kernels_copy / "_hopper" / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    scopes = {c.split("/")[0] for c in _changed(before,
                                                _all_fingerprints())}
    assert scopes == {"mxu", "histo", "nn", "linalg"}


def test_histogram_source_edit_leaves_mxu_alone(kernels_copy):
    before = _all_fingerprints()
    cu = kernels_copy / "histogram" / "csrc" / "histogram.cu"
    cu.write_text(cu.read_text() + "\n// edited\n")
    scopes = {c.split("/")[0] for c in _changed(before,
                                                _all_fingerprints())}
    assert scopes == {"histo"}


def test_module_top_imports_seed_kernel_discovery():
    """The port's mxu body imports nothing; its module imports the
    matmul kernel, whose sources reach the digest."""
    bench = family("mxu/matmul", ["repro_torch.scopes.mxu_scope"])
    assert "import" not in (bench.source or "")
    assert fp.family_inputs(bench, "cpu")["kernels"] != ""
    assert fp.family_inputs(axpy(), "cpu")["kernels"] == ""


def test_kernel_dependencies_and_native_sources():
    src = "from repro_torch.kernels.matmul import matmul as cuda_matmul\n"
    deps = fp.kernel_dependencies([src])
    assert {"repro_torch.kernels.matmul", "repro_torch.kernels.matmul.ops",
            "repro_torch.kernels.matmul.ref", "repro_torch.kernels.tuning",
            "repro_torch.kernels._build"} <= set(deps)
    assert all(d.startswith("repro_torch.kernels") for d in deps)
    # indented source (fixture bodies) parses the same
    assert fp.kernel_dependencies(["    " + src]) == deps
    assert fp.kernel_dependencies(["import numpy as np\n"]) == []
    native = fp.native_sources(deps)
    assert "matmul/csrc/matmul.cu" in native
    assert "_hopper/hopper.cuh" in native and "_build.py" in native
    assert not any(n.startswith("histogram/") for n in native)
    assert fp.native_sources(
        fp.kernel_dependencies(["import repro_torch.kernels.tuning"])) == []


def _write_artifact(tmp_path, device, config, variant="wgmma"):
    tuning.write_tuned("matmul", {"config": config}, device=device,
                       variant=variant,
                       path=str(tmp_path / "matmul" / "tuned.json"))


def test_digest_changes_on_tuned_artifact_for_the_run_device(monkeypatch,
                                                              tmp_path):
    bench = family("mxu/matmul", ["repro_torch.scopes.mxu_scope"])
    assert bench.tunable is not None
    base = fp.family_inputs(bench, "cpu")
    monkeypatch.setenv(tuning.DIR_ENV, str(tmp_path))
    tuning.invalidate_cache()
    try:
        # another card's entry: not this run's artifact
        _write_artifact(tmp_path, "NVIDIA H100 PCIe",
                        {"bm": 64, "bn": 64, "bk": 64})
        assert fp.family_inputs(bench, "cpu") == base
        _write_artifact(tmp_path, "cpu", {"bm": 64, "bn": 128, "bk": 64})
        new = fp.family_inputs(bench, "cpu")
    finally:
        monkeypatch.delenv(tuning.DIR_ENV)
        tuning.invalidate_cache()
    assert json.loads(new["tuned"]) == {"wgmma": {"bm": 64, "bn": 128,
                                                  "bk": 64}}
    assert {k for k in base if base[k] != new[k]} == {"tuned"}
    # untunable families never read artifacts
    assert fp.family_inputs(axpy(), "cpu")["tuned"] == ""


def test_artifact_device_key_without_a_card():
    import torch
    assert fp.artifact_device("cpu") == "cpu"
    if not torch.cuda.is_available():
        assert fp.artifact_device("cuda") == "cuda"


def test_params_split_families_share_family_digest():
    bench = axpy()
    fam = fp.family_digest(bench, "cpu")
    names = dict(bench.instances())
    fps = {name: fp.instance_fingerprint(bench, params, fam)
           for name, params in bench.instances()}
    assert len(set(fps.values())) == len(names)   # one per point
    again = {name: fp.instance_fingerprint(bench, params, device="cpu")
             for name, params in bench.instances()}
    assert fps == again


# ---------------------------------------------------------------------------
# freshness classification + delta split
# ---------------------------------------------------------------------------

def test_classify_states():
    assert fp.classify("aa", None) == fp.NEVER
    assert fp.classify("aa", rec("x", "bb")) == fp.STALE
    assert fp.classify("aa", rec("x", "aa")) == fp.FRESH
    assert fp.classify("aa", rec("x", "aa", mean=None)) == fp.STALE
    assert fp.classify("aa", rec("x", "aa", errors=1)) == fp.STALE
    assert fp.classify("aa", rec("x", "aa", ts="2026-07-01T00:00:00"),
                       since="2026-08-01") == fp.STALE
    assert fp.classify("aa", rec("x", "aa", ts="2026-08-02T00:00:00"),
                       since="2026-08-01") == fp.FRESH


def test_latest_measurements_skips_cached_tune_and_other_machines():
    records = [
        rec("s/a", "f1", run_id="r1"),
        rec("s/a", "f2", run_id="r2", cached=True),     # replay: no vouch
        rec("s/b", "f3", run_id="r2", tag="tune"),      # trial: no vouch
        rec("s/c", "f4", run_id="r2", sysinfo="m2"),    # other machine
    ]
    latest = fp.latest_measurements(records, sysinfo="m1")
    assert set(latest) == {"s/a"}
    assert latest["s/a"]["fingerprint"] == "f1"


def test_delta_split_prunes_only_fresh():
    items = [types.SimpleNamespace(instance_id=f"i{i}", name=n)
             for i, n in enumerate(["s/a", "s/b", "s/c"])]
    fps = {"s/a": "fa", "s/b": "fb", "s/c": "fc"}
    records = [rec("s/a", "fa"),            # fresh → cached
               rec("s/b", "old")]           # stale → runs
    pending, cached = fp.delta_split(items, fps, records, "m1")
    assert [i.name for i in pending] == ["s/b", "s/c"]
    assert set(cached) == {"i0"}
    assert cached["i0"]["fingerprint"] == "fa"
    # a record of another device's digest vouches for nothing here
    pending, cached = fp.delta_split(items, fps, records, "m-card")
    assert len(pending) == 3 and cached == {}


def test_coverage_counts_per_scope():
    benches = example_benches()
    cov = fp.coverage(benches, [], device="cpu")
    n = cov["instances"]
    assert n > 0 and cov["totals"] == {"fresh": 0, "stale": 0, "never": n}
    fps = fp.registry_fingerprints(benches, "cpu")
    records = [rec(name, digest) for name, digest in fps.items()]
    cov = fp.coverage(benches, records, sysinfo="m1", device="cpu")
    assert cov["totals"] == {"fresh": n, "stale": 0, "never": 0}
    assert cov["pending"] == []
    records[0]["fingerprint"] = "stale"
    cov = fp.coverage(benches, records, sysinfo="m1", device="cpu")
    assert cov["totals"]["stale"] == 1
    assert cov["pending"] == [records[0]["name"]]
