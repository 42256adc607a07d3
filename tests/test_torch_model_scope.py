"""The torch port's model scope against the JAX package's, on the CPU.

``python -m repro_torch run --device cpu --enable-scope model`` must
write the reference's six instance names (so ``python -m repro compare``
pairs the rows across the packages) with finite loss-step times, and
``dryrun_rooflines`` over hand-written dry-run cells must give the
reference's counters.  The subprocesses inherit ``os.environ`` (jax's
platform probe hangs without ``JAX_PLATFORMS``).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.flags import FlagRegistry as RefFlagRegistry
from repro.core.hooks import HookChain as RefHookChain
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.scope import ScopeManager as RefScopeManager
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.scope import ScopeManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def run(package, out, *args):
    argv = [sys.executable, "-m", package, "run", "--enable-scope", "model",
            "--results-dir", "", "--benchmark_out", str(out), *args]
    r = subprocess.run(argv, capture_output=True, text=True, env=_env(),
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _families(mgr_cls, registry, flags, hooks):
    mgr = mgr_cls(registry=registry, flags=flags, hooks=hooks)
    mgr.load()
    mgr.configure(enable=["model"])
    mgr.register_all()
    return {b.name: b for b in registry.all()}


def _names(families):
    return [name for b in families.values() for name, _ in b.instances()]


@pytest.fixture
def on_cpu():
    before = FLAGS.get("device")
    FLAGS.set("device", "cpu")
    yield
    FLAGS.set("device", before)


def test_cpu_run_writes_the_reference_instances(tmp_path):
    ref = _families(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                    RefHookChain())
    names = _names(ref)
    assert names == [f"model/loss_step_reduced/arch:{a}" for a in (
        "llama3.2-1b", "mamba2-780m", "deepseek-moe-16b", "jamba-v0.1-52b",
        "whisper-small")] + ["model/dryrun_rooflines"]
    (tmp_path / "dryrun").mkdir()
    doc = run("repro_torch", tmp_path / "p.json", "--device", "cpu",
              "--benchmark_min_time", "0.01",
              "--model.dryrun_dir", str(tmp_path / "dryrun"))
    records = {r["name"]: r for r in doc["benchmarks"]}
    assert list(records) == names
    assert doc["context"]["scopes"]["model"] == "enabled"
    for name in names[:-1]:
        r = records[name]
        assert not r.get("error_occurred") and not r.get("skipped"), r
        assert np.isfinite(r["real_time"]) and r["real_time"] > 0
        assert r["compile_time_s"] >= 0 and r["items_per_second"] > 0
    dry = records["model/dryrun_rooflines"]
    assert dry["skipped"] and "no dry-run results" in dry["skip_message"]


def _cell(name, status, compute_s, memory_s, collective_s):
    return {"cell": name, "status": status,
            "roofline": {"compute_s": compute_s, "memory_s": memory_s,
                         "collective_s": collective_s}}


def test_dryrun_rooflines_matches_reference(tmp_path):
    d = tmp_path / "dryrun"
    d.mkdir()
    cells = [_cell("llama3.2-1b__train_4k", "ok", 0.25, 0.125, 0.5),
             _cell("mamba2-780m__long_500k", "ok", 1.5, 2.75, 0.0),
             _cell("stablelm-12b__decode_32k", "failed", 9.0, 9.0, 9.0)]
    for c in cells:
        (d / f"{c['cell']}.json").write_text(json.dumps(c))
    args = ["--benchmark_filter", "dryrun_rooflines", "--model.dryrun_dir",
            str(d)]
    port = run("repro_torch", tmp_path / "p.json", "--device", "cpu", *args)
    ref = run("repro", tmp_path / "r.json", *args)
    (p,), (r,) = port["benchmarks"], ref["benchmarks"]
    assert p["name"] == r["name"] == "model/dryrun_rooflines"
    assert (p["cells"], p["sum_bound_s"]) == (r["cells"], r["sum_bound_s"])
    assert (p["cells"], p["sum_bound_s"]) == (2, 0.5 + 2.75)
    assert p["iterations"] == r["iterations"] == 1
    assert sorted(p) == sorted(r)


def test_loss_step_fixture_matches_reference_batch(on_cpu):
    """The fixture's reduced config, batch and callable: a finite scalar
    loss on the CPU, with the reference's batch fields and shapes."""
    ref = _families(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                    RefHookChain())
    port = _families(ScopeManager, BenchmarkRegistry(), FlagRegistry(),
                     HookChain())
    for arch in ("whisper-small", "deepseek-moe-16b"):
        def fixture(families):
            fam = families["model/loss_step_reduced"]
            (params,) = [p for _, p in fam.instances() if p.arch == arch]
            return fam.fixture(params)
        _, ref_weights, ref_batch = fixture(ref)
        fn, weights, batch = fixture(port)
        assert sorted(batch) == sorted(ref_batch)
        for k, v in batch.items():
            assert tuple(v.shape) == ref_batch[k].shape
            assert str(v.dtype).replace("torch.", "") == \
                str(ref_batch[k].dtype)
            assert v.device.type == "cpu" and bool((v == 1).all())
        assert {"/".join(map(str, k)): tuple(v.shape) for k, v in
                jax.tree_util.tree_flatten_with_path(ref_weights)[0]} == {
            "/".join(map(str, k)): tuple(v.shape) for k, v in
            jax.tree_util.tree_flatten_with_path(weights)[0]}
        loss = fn(weights, batch)
        assert loss.shape == () and torch.isfinite(loss)
        assert not loss.requires_grad
