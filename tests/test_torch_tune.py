"""``python -m repro_torch tune`` on the CPU.

The tune command lists the five tunable families of the port's scopes,
runs end to end on a small family whose body calls the port's matmul on
CPU tensors (the plain version; the wrapper still resolves, validates
and records the ``simt`` variant's tile), and writes documents with the
keys and formats the JAX package's ``tune`` writes for a like family:
the ``tune.json`` summary, the ``tune``-tagged history records and the
``tune/<kernel>/<knob:value>/...`` trial names.  Artifacts and results
go to temporary directories, never into the source tree."""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_SCOPE = '''
import torch
from repro_torch.core import Scope, State, benchmark
from repro_torch.kernels.matmul import matmul


def _register(registry):
    def setup(params):
        g = torch.Generator().manual_seed(0)
        return (matmul, torch.randn(params.m, params.k, generator=g),
                torch.randn(params.k, params.n, generator=g))

    @benchmark(scope="tprobe", registry=registry)
    def mm(state: State):
        fn, x, y = state.fixture
        while state.keep_running():
            state.deliver(fn(x, y))
        p = state.params
        state.counters["flops"] = 2.0 * p.m * p.n * p.k
    mm.param_space(m=[96, 256], k=[32], n=[80])
    mm.set_fixture(setup)
    mm.set_tunable("matmul", bm=[64, 128], bn=[64, 128], bk=[16],
                   instance={"m": 96})

    @benchmark(scope="tprobe", registry=registry)
    def mm_bad(state: State):
        fn, x, y = state.fixture
        while state.keep_running():
            state.deliver(fn(x, y))
    mm_bad.param_space(m=[96], k=[32], n=[80])
    mm_bad.set_fixture(setup)
    # 96 rows a tile is no instantiation of the simt variant
    mm_bad.set_tunable("matmul", bm=[64, 96, 128], bn=[64], bk=[16])

    @benchmark(scope="tprobe", registry=registry)
    def no_kernel(state: State):
        while state.keep_running():
            state.deliver(torch.ones(4) * 2)
    no_kernel.param_space(m=[1])
    no_kernel.set_tunable("matmul", bm=[64, 128])


SCOPE = Scope(name="tprobe", register=_register)
'''

REF_SCOPE = '''
import jax.numpy as jnp
import numpy as np
from repro.core import Scope, State, benchmark


def _register(registry):
    def setup(params):
        rng = np.random.default_rng(0)
        return (jnp.dot,
                jnp.asarray(rng.standard_normal((params.m, params.k)),
                            jnp.float32),
                jnp.asarray(rng.standard_normal((params.k, params.n)),
                            jnp.float32))

    @benchmark(scope="tprobe", registry=registry)
    def mm(state: State):
        fn, x, y = state.fixture
        while state.keep_running():
            state.deliver(fn(x, y))
        p = state.params
        state.counters["flops"] = 2.0 * p.m * p.n * p.k
    mm.param_space(m=[96, 256], k=[32], n=[80])
    mm.set_fixture(setup)
    mm.set_tunable("matmul", bm=[64, 128], bn=[64, 128], bk=[16],
                   instance={"m": 96})


SCOPE = Scope(name="tprobe", register=_register)
'''

TRIAL_NAME = re.compile(r"^tune/matmul/bm:\d+/bn:\d+/bk:\d+$")


@pytest.fixture
def scopes(tmp_path, monkeypatch):
    """The two scope modules on ``sys.path``, artifacts under tmp."""
    (tmp_path / "torch_tune_probe_scope.py").write_text(PORT_SCOPE)
    (tmp_path / "ref_tune_probe_scope.py").write_text(REF_SCOPE)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("REPRO_TUNED_DIR", str(tmp_path / "tuned"))
    monkeypatch.delenv("REPRO_TUNED", raising=False)
    for name in list(os.environ):
        if name.startswith("REPRO_TUNED_MATMUL_"):
            monkeypatch.delenv(name)
    from repro_torch.kernels import tuning
    tuning.invalidate_cache()
    yield tmp_path
    tuning.invalidate_cache()


def _isolated(flags, registry, fn):
    """Run ``fn`` against an empty global registry with the flags
    snapshotted (the process-global registry would otherwise collide
    across calls)."""
    specs, values = dict(flags._specs), dict(flags._values)
    saved = dict(registry._benchmarks)
    registry._benchmarks.clear()
    try:
        return fn()
    finally:
        registry._benchmarks.clear()
        registry._benchmarks.update(saved)
        flags._specs.clear(), flags._specs.update(specs)
        flags._values.clear(), flags._values.update(values)


def port_tune(args, modules=("torch_tune_probe_scope",)):
    from repro_torch.core.flags import FLAGS
    from repro_torch.core.registry import REGISTRY
    from repro_torch.core.tune import tune_main
    return _isolated(FLAGS, REGISTRY,
                     lambda: tune_main(list(args), list(modules)))


def ref_tune(args, modules=("ref_tune_probe_scope",)):
    from repro.core.flags import FLAGS
    from repro.core.registry import REGISTRY
    from repro.core.tune import tune_main
    return _isolated(FLAGS, REGISTRY,
                     lambda: tune_main(list(args), list(modules)))


def _args(tmp, run_id, *extra):
    return ["tprobe/mm", "--budget", "2", "--seed", "0", "--strategy",
            "hillclimb", "--no-report", "--results-dir",
            str(tmp / "results"), "--run-id", run_id,
            "--benchmark_min_time", "0.001", *extra]


def _history(tmp, run_id):
    with open(tmp / "results" / "history.jsonl") as fh:
        return [r for r in map(json.loads, fh) if r["run_id"] == run_id]


def test_tune_list_names_the_five_families():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch", "tune",
                        "--list"], capture_output=True, text=True, env=env,
                       cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    listed = {line.split()[0]: line for line in r.stdout.splitlines()}
    assert set(listed) == {"mxu/matmul", "linalg/matmul_rect", "nn/rmsnorm",
                           "nn/flash_attention_cuda", "nn/ssd_scan_cuda"}
    assert "kernel=matmul" in listed["mxu/matmul"]
    assert "instance=backend=cuda,dtype=bf16" in listed["mxu/matmul"]
    assert "kernel=ssd_scan  space=chunk (3 configs)" in \
        listed["nn/ssd_scan_cuda"]
    assert "kernel=flash_attention  space=bqxbk (4 configs)" in \
        listed["nn/flash_attention_cuda"]


def test_tune_end_to_end_on_cpu(scopes):
    from repro_torch.kernels import tuning
    assert port_tune(_args(scopes, "cpu1", "--device", "cpu")) == 0
    with open(tuning.tuned_path("matmul")) as fh:
        artifact = json.load(fh)
    assert artifact["kernel"] == "matmul"
    assert list(artifact["devices"]) == ["cpu"]
    entry = artifact["devices"]["cpu"]["simt"]
    assert set(entry["config"]) == {"bm", "bn", "bk"}
    assert entry["variant"] == "simt" and entry["device"] == "cpu"
    assert entry["source"] == {"family": "tprobe/mm",
                               "instance": "tprobe/mm/m:96/k:32/n:80",
                               "run_id": "cpu1"}
    summary = json.loads((scopes / "results" / "cpu1" /
                          "tune.json").read_text())
    assert summary["kernel"] == "matmul"
    assert summary["instance"] == "tprobe/mm/m:96/k:32/n:80"
    # the builtin tile at 96 x 80: bm 128, bn by the wave rule, bk 16
    assert summary["baseline"]["params"] == {"bm": 128, "bn": 64, "bk": 16}
    assert summary["best"]["params"] == entry["config"]
    trials = summary["search"]["trials"]
    assert len(trials) == 2 and trials[0]["params"] == \
        summary["baseline"]["params"]
    records = _history(scopes, "cpu1")
    assert len(records) == 2
    assert all(r["tag"] == "tune" and TRIAL_NAME.match(r["name"])
               for r in records)
    merged = json.loads((scopes / "results" / "cpu1" /
                         "merged.json").read_text())
    assert [r["name"] for r in merged["benchmarks"]] == \
        [r["name"] for r in records]
    # the written artifact now is the variant's default on this device
    tuning.invalidate_cache()
    assert tuning.resolve("matmul", "simt", device="cpu") == entry["config"]
    assert tuning.resolve("matmul", "simt", device="NVIDIA H100 PCIe") == \
        tuning.BUILTIN_DEFAULTS["matmul"]["simt"]


def test_tune_documents_pair_with_the_reference(scopes):
    """A like family through both packages' tune: the same summary keys,
    search keys, history record keys and tag, and trial names of one
    format; the reference's artifact keys all in the port's entry."""
    assert port_tune(_args(scopes, "port", "--device", "cpu",
                           "--output", str(scopes / "port.json"))) == 0
    assert ref_tune(_args(scopes, "ref", "--output",
                          str(scopes / "ref.json"))) == 0
    port = json.loads((scopes / "results" / "port" / "tune.json").read_text())
    ref = json.loads((scopes / "results" / "ref" / "tune.json").read_text())
    assert set(port) == set(ref)
    assert set(port["search"]) == set(ref["search"])
    assert set(port["best"]) == set(ref["best"])
    assert port["axes"] == ref["axes"] and port["instance"] == \
        ref["instance"]
    port_recs, ref_recs = _history(scopes, "port"), _history(scopes, "ref")
    assert port_recs and ref_recs
    assert {frozenset(r) for r in port_recs} == \
        {frozenset(r) for r in ref_recs}
    for r in port_recs + ref_recs:
        assert r["tag"] == "tune" and TRIAL_NAME.match(r["name"]), r
    ref_art = json.loads((scopes / "ref.json").read_text())
    port_art = json.loads((scopes / "port.json").read_text())
    assert set(ref_art) <= set(port_art["devices"]["cpu"]["simt"])
    assert not (scopes / "tuned").exists()       # --output was honoured


def test_a_tile_outside_the_set_is_a_failed_trial(scopes):
    """bm = 96 raises in the wrapper: the trial is recorded as failed,
    consumes budget, and the search goes on to a legal winner."""
    assert port_tune(["tprobe/mm_bad", "--budget", "3", "--device", "cpu",
                      "--no-artifact", "--results-dir",
                      str(scopes / "results"), "--run-id", "bad",
                      "--benchmark_min_time", "0.001"]) == 0
    summary = json.loads((scopes / "results" / "bad" /
                          "tune.json").read_text())
    failed = [t for t in summary["search"]["trials"] if t.get("error")]
    assert [t["params"]["bm"] for t in failed] == [96]
    assert "bm=96" in failed[0]["error"]
    assert summary["best"]["params"]["bm"] in (64, 128)
    assert not (scopes / "tuned").exists()


@pytest.mark.parametrize("argv,rc", [
    ([], 2),                                        # no family
    (["tprobe/nope"], 1),                           # no such family
    (["tprobe/no_kernel", "--device", "cpu"], 1),   # calls no matmul
    (["tprobe/mm", "--device", "cpu", "--param", "m=7"], 1),  # no instance
])
def test_tune_refusals(scopes, argv, rc):
    # (flag=value: with no family, a flag's separate value would be
    # taken for one, as in the reference's parser)
    assert port_tune([*argv, f"--results-dir={scopes / 'results'}",
                      "--benchmark_min_time=0.001"]) == rc
    assert not (scopes / "tuned").exists()


def test_tune_needs_the_card_unless_told_cpu(scopes):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert port_tune(_args(scopes, "nocard")) == 2
