"""The torch port's run orchestrator and baseline comparison
(``repro_torch.core.orchestrate`` / ``repro_torch.core.baseline``): the
reference's ``tests/test_orchestrate.py`` run through the port on
``--device cpu``, one test for each of the reference's, plus parity
with the reference's CLI: ``merged.json`` keeps its record names and
keys across ``--jobs``, the grain and ``--resume`` and matches
``python -m repro run``'s, and the two packages' ``compare`` give the
same verdicts and exit code on the same documents.  Worker processes
are fresh interpreters, so every test passes ``device=cpu`` to them
through the flag values, as ``python -m repro_torch run --device cpu``
does."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro_torch.core import baseline as bl
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.orchestrate import (WORKER_MODULE, OrchestratorOptions,
                                          ScopeShard, execute, merge_shards,
                                          read_manifest, scope_error_record)
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.runner import RunOptions, run_benchmarks
from repro_torch.core.scope import ScopeManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = "repro_torch.scopes.example_scope"
HISTO = "repro_torch.scopes.histo_scope"
FAST = RunOptions(min_time=0.002, device="cpu")
#: What a worker needs to register and allocate on the CPU.
CPU_FLAGS = {"device": "cpu"}


def opts(**kw):
    return OrchestratorOptions(run=FAST, flag_values=CPU_FLAGS, **kw)


def make_mgr(modules):
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(modules)
    mgr.register_all()
    return mgr


@pytest.fixture
def on_cpu():
    """The parent's scopes register on FLAGS' device: the CPU here."""
    before = FLAGS.get("device")
    FLAGS.set("device", "cpu")
    yield
    FLAGS.set("device", before)


def _ensure_src_on_child_path(monkeypatch, extra=None):
    parts = [os.path.join(ROOT, "src")]
    if extra:
        parts.append(str(extra))
    old = os.environ.get("PYTHONPATH")
    if old:
        parts.append(old)
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(parts))


def _names(doc):
    return [r["name"] for r in doc["benchmarks"]]


def _schemas(doc):
    return [frozenset(r) for r in doc["benchmarks"]]


# ---------------------------------------------------------------------------
# equivalence
# ---------------------------------------------------------------------------

def test_inline_merged_matches_sequential_runner():
    mgr = make_mgr([EXAMPLE])
    seq = run_benchmarks(mgr.registry.filter(".*"), FAST, progress=False)
    res = execute(mgr, mgr.registry, opts(jobs=1))
    assert sorted(res.doc) == ["benchmarks", "context"]
    assert _names(res.doc) == _names(seq)
    assert _schemas(res.doc) == _schemas(seq)
    ctx = res.doc["context"]
    assert ctx["backend"] == "cpu" and ctx["run_id"]
    assert [s["scope"] for s in ctx["shards"]] == ["example"]


def test_parallel_subprocess_matches_inline(on_cpu, monkeypatch, tmp_path):
    """--jobs 2 scope-grained subprocess run: same names/schema as
    inline, per-scope shards persisted under results/<run-id>/, and the
    reference's ScopePlot reads the run directory."""
    _ensure_src_on_child_path(monkeypatch)
    mgr = make_mgr([EXAMPLE, HISTO])
    inline = execute(mgr, mgr.registry, opts(jobs=1))
    par = execute(mgr, mgr.registry,
                  opts(jobs=2, isolate="subprocess", shard_grain="scope",
                       results_dir=str(tmp_path), run_id="t1"))
    assert [s.status for s in par.shards] == ["ok", "ok"]
    assert _names(par.doc) == _names(inline.doc)
    assert _schemas(par.doc) == _schemas(inline.doc)
    assert not any("backend:cuda" in n for n in _names(par.doc))
    out = tmp_path / "t1"
    assert sorted(p.name for p in out.iterdir()) == \
        ["example.json", "histo.json", "merged.json"]
    merged = json.loads((out / "merged.json").read_text())
    assert [s["scope"] for s in merged["context"]["shards"]] == \
        ["example", "histo"]
    assert merged["context"]["run_id"] == "t1"

    from repro.scopeplot import load
    bf = load(str(out))
    assert bf.scope_names() == ["example", "histo"]
    assert [s["status"] for s in bf.shards()] == ["ok", "ok"]
    assert len(bf.for_scope("example")) == \
        len(load(str(out / "example.json")))


# ---------------------------------------------------------------------------
# crash isolation
# ---------------------------------------------------------------------------

CRASHY = textwrap.dedent("""
    import os
    from repro_torch.core import Scope, State, benchmark

    NAME = "crashy"

    def _register(registry):
        @benchmark(scope=NAME, registry=registry)
        def die(state: State):
            os._exit(42)

    SCOPE = Scope(name=NAME, register=_register)
""")


def test_crash_isolation_subprocess(monkeypatch, tmp_path):
    (tmp_path / "torch_crashy_scope.py").write_text(CRASHY)
    monkeypatch.syspath_prepend(str(tmp_path))
    _ensure_src_on_child_path(monkeypatch, extra=tmp_path)
    mgr = make_mgr([EXAMPLE, "torch_crashy_scope"])
    res = execute(mgr, mgr.registry,
                  opts(jobs=2, isolate="subprocess", shard_grain="scope"))
    by = {s.scope: s for s in res.shards}
    assert by["example"].status == "ok"
    assert by["crashy"].status == "crashed"
    assert "42" in by["crashy"].error
    failed = [r for r in res.doc["benchmarks"]
              if r["name"] == "crashy/SCOPE_FAILED"]
    assert len(failed) == 1 and failed[0]["error_occurred"]
    assert any(r["name"].startswith("example/")
               for r in res.doc["benchmarks"])


FAULTY = textwrap.dedent("""
    from repro_torch.core import Scope

    NAME = "faulty"

    def _register(registry):
        raise RuntimeError("registration exploded")

    SCOPE = Scope(name=NAME, register=_register)
""")


def test_subprocess_distinguishes_error_from_crash(monkeypatch, tmp_path):
    (tmp_path / "torch_faulty_scope.py").write_text(FAULTY)
    monkeypatch.syspath_prepend(str(tmp_path))
    _ensure_src_on_child_path(monkeypatch, extra=tmp_path)
    make_mgr(["torch_faulty_scope"])
    from repro_torch.core.orchestrate import _run_subprocess
    shard = _run_subprocess("faulty", "torch_faulty_scope",
                            opts(jobs=1, isolate="subprocess"))
    assert shard.status == "error"
    assert "registration exploded" in shard.error
    assert WORKER_MODULE == "repro_torch.core.orchestrate"


def test_crash_breaks_pool_but_run_recovers(monkeypatch, tmp_path):
    (tmp_path / "torch_crashy_scope.py").write_text(CRASHY)
    monkeypatch.syspath_prepend(str(tmp_path))
    _ensure_src_on_child_path(monkeypatch, extra=tmp_path)
    mgr = make_mgr([EXAMPLE, "torch_crashy_scope"])
    res = execute(mgr, mgr.registry,
                  opts(jobs=2, isolate="pool", shard_grain="scope"))
    by = {s.scope: s for s in res.shards}
    assert set(by) == {"example", "crashy"}
    assert by["example"].status == "ok"
    assert by["crashy"].status == "crashed"


def test_import_failure_yields_error_shard():
    mgr = make_mgr([EXAMPLE])
    shards = [
        ScopeShard("example", EXAMPLE, "ok",
                   run_benchmarks(mgr.registry.filter(".*"), FAST,
                                  progress=False)),
        ScopeShard("broken", "no.such.module", "error",
                   error="ModuleNotFoundError: no.such.module"),
    ]
    doc = merge_shards(shards, run_id="r1", device="cpu")
    assert doc["context"]["run_id"] == "r1"
    assert doc["context"]["backend"] == "cpu"
    assert [s["status"] for s in doc["context"]["shards"]] == \
        ["ok", "error"]
    assert "broken/SCOPE_FAILED" in _names(doc)


def test_scope_error_record_schema_matches_runner():
    rec = scope_error_record(ScopeShard("x", "m", "crashed", error="boom"))
    for key in ("name", "run_name", "run_type", "repetitions",
                "repetition_index", "threads", "iterations", "real_time",
                "cpu_time", "time_unit", "error_occurred",
                "error_message"):
        assert key in rec
    assert rec["error_occurred"] is True
    assert "boom" in rec["error_message"]


# ---------------------------------------------------------------------------
# benchmark grain: plan scheduling, manifest, resume, instance isolation
# ---------------------------------------------------------------------------

def test_plan_grain_inline_matches_scope_grain(tmp_path):
    mgr = make_mgr([EXAMPLE])
    scope_run = execute(mgr, mgr.registry, opts(jobs=1))
    plan_run = execute(mgr, mgr.registry,
                       opts(jobs=1, shard_grain="benchmark",
                            results_dir=str(tmp_path), run_id="p1"))
    assert _names(plan_run.doc) == _names(scope_run.doc)
    assert _schemas(plan_run.doc) == _schemas(scope_run.doc)
    out = tmp_path / "p1"
    assert (out / "merged.json").exists()
    shard_files = sorted(p.name for p in (out / "shards").iterdir()
                         if p.suffix == ".json")
    assert len(shard_files) == len(plan_run.plan.items)
    manifest = read_manifest(str(out))
    assert manifest["run_id"] == "p1"
    assert manifest["grain"] == "benchmark"
    assert manifest["completed"] == manifest["total"] == \
        len(plan_run.plan.items)
    assert [e["name"] for e in manifest["items"]] == \
        [i.name for i in plan_run.plan.items]
    assert all(e["status"] == "ok" and e["finished"] is not None
               for e in manifest["items"])
    assert [(s.scope, s.status) for s in plan_run.shards] == \
        [("example", "ok")]
    merged = json.loads((out / "merged.json").read_text())
    ctx = merged["context"]
    assert [s["status"] for s in ctx["shards"]] == ["ok"]
    assert ctx["run_id"] == "p1" and ctx["backend"] == "cpu"
    assert [i["name"] for i in ctx["instances"]] == _names(plan_run.doc)
    (out / "merged.json").unlink()      # interrupted-run view
    assert _names(bl.load_document(str(out))) == _names(plan_run.doc)


def test_resume_skips_completed_instances(tmp_path):
    mgr = make_mgr([EXAMPLE])
    o = opts(jobs=1, shard_grain="benchmark", results_dir=str(tmp_path),
             run_id="r1")
    first = execute(mgr, mgr.registry, o)
    out = tmp_path / "r1"
    before = {e["name"]: e for e in read_manifest(str(out))["items"]}
    victim = first.plan.items[2]
    (out / "shards" / f"{victim.instance_id}.json").unlink()
    (out / "merged.json").unlink()

    o.resume = True
    second = execute(mgr, mgr.registry, o)
    after = {e["name"]: e for e in read_manifest(str(out))["items"]}
    for name, entry in after.items():
        if name == victim.name:
            assert entry["finished"] > before[name]["finished"]
            assert not entry.get("cached")
        else:
            assert entry["finished"] == before[name]["finished"]
            assert entry.get("cached")
    assert _names(second.doc) == _names(first.doc)
    assert _schemas(second.doc) == _schemas(first.doc)
    assert (out / "merged.json").exists()


INSTANCE_CRASHY = textwrap.dedent("""
    import os
    from repro_torch.core import Scope, State, benchmark

    NAME = "crashy"

    def _register(registry):
        @benchmark(scope=NAME, registry=registry)
        def ok_before(state: State):
            while state.keep_running():
                pass

        @benchmark(scope=NAME, registry=registry)
        def die(state: State):
            if state.range(0) == 2:
                os._exit(42)
            while state.keep_running():
                pass
        die.range_multiplier_args(1, 4)

        @benchmark(scope=NAME, registry=registry)
        def ok_after(state: State):
            while state.keep_running():
                pass

    SCOPE = Scope(name=NAME, register=_register)
""")


def test_instance_crash_degrades_only_itself(monkeypatch, tmp_path):
    (tmp_path / "torch_instance_crashy_scope.py").write_text(INSTANCE_CRASHY)
    monkeypatch.syspath_prepend(str(tmp_path))
    _ensure_src_on_child_path(monkeypatch, extra=tmp_path)
    mgr = make_mgr(["torch_instance_crashy_scope"])
    res = execute(mgr, mgr.registry,
                  opts(jobs=2, isolate="subprocess", shard_grain="benchmark"))
    by = {r.item.name: r for r in res.instances}
    assert by["crashy/die/2"].status == "crashed"
    assert "42" in by["crashy/die/2"].error
    for name in ("crashy/ok_before", "crashy/die/1", "crashy/die/4",
                 "crashy/ok_after"):
        assert by[name].status == "ok"
    recs = {r["name"]: r for r in res.doc["benchmarks"]}
    assert recs["crashy/die/2"]["error_occurred"]
    assert not recs["crashy/ok_after"].get("error_occurred")
    assert [(s.scope, s.status) for s in res.shards] == \
        [("crashy", "partial")]


def test_merge_determinism_across_grains_and_resume(on_cpu, monkeypatch,
                                                    tmp_path):
    _ensure_src_on_child_path(monkeypatch)
    mgr = make_mgr([EXAMPLE, HISTO])
    inline = execute(mgr, mgr.registry, opts(jobs=1, isolate="inline"))
    par = execute(mgr, mgr.registry,
                  opts(jobs=4, isolate="subprocess", shard_grain="benchmark",
                       results_dir=str(tmp_path), run_id="d1"))
    assert _names(par.doc) == _names(inline.doc)
    assert _schemas(par.doc) == _schemas(inline.doc)

    out = tmp_path / "d1"
    for item in (par.plan.items[1], par.plan.items[-1]):
        (out / "shards" / f"{item.instance_id}.json").unlink()
    (out / "merged.json").unlink()
    resumed = execute(mgr, mgr.registry,
                      opts(jobs=2, isolate="subprocess",
                           shard_grain="benchmark", resume=True,
                           results_dir=str(tmp_path), run_id="d1"))
    assert sum(1 for r in resumed.instances if r.cached) == \
        len(par.plan.items) - 2
    assert _names(resumed.doc) == _names(inline.doc)
    assert _schemas(resumed.doc) == _schemas(inline.doc)
    merged = json.loads((out / "merged.json").read_text())
    assert _names(merged) == _names(inline.doc)


def test_external_scopes_run_inline_at_benchmark_grain():
    from repro_torch.core.benchmark import Benchmark
    from repro_torch.core.scope import Scope
    mgr = make_mgr([])

    def _register(reg):
        reg.register(Benchmark("ext/x", lambda s: None, scope="ext"))
    mgr.add_scope(Scope(name="ext", register=_register))
    mgr.register_all()
    res = execute(mgr, mgr.registry,
                  opts(jobs=2, isolate="subprocess", shard_grain="benchmark"))
    assert [r.item.name for r in res.instances] == ["ext/x"]
    assert res.instances[0].status == "ok"
    assert _names(res.doc) == ["ext/x"]


def test_worker_sent_to_missing_card_fails_its_instances(tmp_path):
    """A worker sent ``device=cuda`` on a host without a card reports
    each instance as an error record; it never measures on the CPU.
    Here the check runs in the worker body itself (no subprocess)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from repro_torch.core.orchestrate import run_plan_items
    from repro_torch.core.plan import build_plan
    mgr = make_mgr([EXAMPLE])
    items = build_plan(mgr, mgr.registry).items[:2]
    run_plan_items([i.meta() for i in items],
                   RunOptions(min_time=0.002, device="cuda"), {}, str(tmp_path))
    for i in items:
        doc = json.loads((tmp_path / f"{i.instance_id}.json").read_text())
        assert doc["context"]["instance"]["status"] == "error"
        (rec,) = doc["benchmarks"]
        assert rec["error_occurred"] and "no CUDA device" in \
            rec["error_message"]


# ---------------------------------------------------------------------------
# baseline comparison
# ---------------------------------------------------------------------------

def _doc(entries):
    """entries: {name: [times_us...]} -> GB-JSON document."""
    benchmarks = []
    for name, times in entries.items():
        for i, t in enumerate(times):
            benchmarks.append({
                "name": name, "run_name": name, "run_type": "iteration",
                "repetitions": len(times), "repetition_index": i,
                "threads": 1, "iterations": 100,
                "real_time": t, "cpu_time": t, "time_unit": "us",
            })
    return {"context": {}, "benchmarks": benchmarks}


def _error_rec(name):
    return {"name": name, "run_name": name, "run_type": "iteration",
            "repetitions": 1, "repetition_index": 0, "threads": 1,
            "iterations": 0, "real_time": 0.0, "cpu_time": 0.0,
            "time_unit": "us", "error_occurred": True, "error_message": "x"}


def test_compare_flags_2x_slowdown():
    base = _doc({"s/a": [10.0, 10.1, 9.9], "s/b": [5.0, 5.1, 4.9]})
    new = _doc({"s/a": [20.0, 20.2, 19.8], "s/b": [5.1, 5.0, 4.9]})
    comps = {c.name: c for c in bl.compare_documents(base, new)}
    assert comps["s/a"].verdict == "regression"
    assert comps["s/a"].ratio == pytest.approx(2.0, rel=0.05)
    assert comps["s/b"].verdict == "similar"


def test_compare_stddev_gates_noisy_changes():
    base = _doc({"s/noisy": [10.0, 14.0, 6.0]})
    new = _doc({"s/noisy": [11.5, 16.0, 7.0]})
    (c,) = bl.compare_documents(base, new)
    assert c.verdict == "similar" and not c.significant


def test_compare_improvement_added_removed_errors():
    base = _doc({"s/fast": [10.0, 10.0, 10.0], "s/gone": [1.0]})
    new = _doc({"s/fast": [5.0, 5.0, 5.0], "s/new": [1.0]})
    new["benchmarks"].append(_error_rec("s/err"))
    base["benchmarks"].append(_error_rec("s/err"))
    comps = {c.name: c for c in bl.compare_documents(base, new)}
    assert comps["s/fast"].verdict == "improvement"
    assert comps["s/gone"].verdict == "removed"
    assert comps["s/new"].verdict == "added"
    assert comps["s/err"].verdict == "errors"


def test_compare_units_normalized():
    one = {"name": "s/x", "run_name": "s/x", "run_type": "iteration",
           "repetitions": 1, "repetition_index": 0, "threads": 1,
           "iterations": 1}
    base = {"context": {}, "benchmarks": [dict(
        one, real_time=1.0, cpu_time=1.0, time_unit="ms")]}
    new = {"context": {}, "benchmarks": [dict(
        one, real_time=1000.0, cpu_time=1000.0, time_unit="us")]}
    (c,) = bl.compare_documents(base, new)
    assert c.verdict == "similar"
    assert c.ratio == pytest.approx(1.0)


def test_compare_cli_exit_codes(tmp_path, capsys):
    base = _doc({"s/a": [10.0, 10.0, 10.1]})
    slow = _doc({"s/a": [20.0, 20.0, 20.2]})
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(base))
    pb.write_text(json.dumps(slow))
    assert bl.compare_main([str(pa), str(pb)]) == 1
    assert "REGRESSION" in capsys.readouterr().out
    assert bl.compare_main([str(pa), str(pa)]) == 0
    assert bl.compare_main([str(pa), str(tmp_path / "missing.json")]) == 2


def test_gate_fails_on_vanished_or_errored_benchmarks():
    base = _doc({"s/a": [10.0], "s/b": [10.0]})
    vanished = _doc({"s/a": [10.0]})
    assert [c.name for c in
            bl.gate_failures(bl.compare_documents(base, vanished))] == \
        ["s/b"]
    errored = _doc({"s/a": [10.0]})
    errored["benchmarks"].append(_error_rec("s/b"))
    assert [c.name for c in
            bl.gate_failures(bl.compare_documents(base, errored))] == \
        ["s/b"]
    base_broken = _doc({"s/a": [10.0]})
    base_broken["benchmarks"].append(_error_rec("s/b"))
    assert bl.gate_failures(
        bl.compare_documents(base_broken, errored)) == []


def test_load_document_reads_interrupted_run_dir(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps(_doc({"s/a": [1.0]})))
    (tmp_path / "b.json").write_text(json.dumps(_doc({"s/b": [2.0]})))
    doc = bl.load_document(str(tmp_path))
    assert _names(doc) == ["s/a", "s/b"]


def test_aggregates_are_not_double_counted():
    doc = _doc({"s/a": [10.0, 10.0]})
    doc["benchmarks"].append({
        "name": "s/a_mean", "run_name": "s/a", "run_type": "aggregate",
        "aggregate_name": "mean", "repetitions": 2, "threads": 1,
        "iterations": 100, "real_time": 10.0, "cpu_time": 10.0,
        "time_unit": "us"})
    assert bl.collect_stats(doc)["s/a"].n == 2


# ---------------------------------------------------------------------------
# parity with the reference's CLI
# ---------------------------------------------------------------------------

def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def _cli(package, *args):
    return subprocess.run([sys.executable, "-m", package, *args],
                          capture_output=True, text=True, env=_env(),
                          cwd=ROOT, timeout=600)


def test_merged_json_matches_reference_cli_across_jobs_and_resume(tmp_path):
    """``python -m repro_torch run --device cpu --jobs 2 --shard-grain
    benchmark`` writes a merged.json with the record names and keys of
    ``python -m repro run`` with the same flags; a resumed run that
    re-runs one deleted instance keeps them, and so does an inline
    ``--jobs 1`` run of the same flags."""
    common = ["--enable-scope", "example", "--benchmark_min_time", "0.01",
              "--shard-grain", "benchmark"]
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    r = _cli("repro_torch", "run", "--device", "cpu", "--jobs", "2",
             *common, "--results-dir", str(port_dir), "--run-id", "p",
             "--benchmark_out", str(tmp_path / "p.json"))
    assert r.returncode == 0, r.stderr
    r = _cli("repro", "run", "--jobs", "2", *common, "--results-dir",
             str(ref_dir), "--run-id", "r", "--benchmark_out",
             str(tmp_path / "r.json"))
    assert r.returncode == 0, r.stderr
    port = json.loads((port_dir / "p" / "merged.json").read_text())
    ref = json.loads((ref_dir / "r" / "merged.json").read_text())
    assert _names(port) == _names(ref)
    assert _schemas(port) == _schemas(ref)
    for key in ("run_id", "shards", "instances", "shard_grain"):
        assert key in port["context"] and key in ref["context"]
    assert port["context"]["backend"] == "cpu"
    assert [line for line in (port_dir / "history.jsonl").read_text()
            .splitlines() if line] and \
        len((port_dir / "history.jsonl").read_text().splitlines()) == \
        len(_names(port))

    manifest = read_manifest(str(port_dir / "p"))
    victim = manifest["items"][3]
    (port_dir / "p" / victim["shard"]).unlink()
    r = _cli("repro_torch", "run", "--device", "cpu", "--jobs", "2",
             *common, "--results-dir", str(port_dir), "--resume", "p")
    assert r.returncode == 0, r.stderr
    resumed = json.loads((port_dir / "p" / "merged.json").read_text())
    assert _names(resumed) == _names(port)
    assert _schemas(resumed) == _schemas(port)
    rerun = [e["name"] for e in read_manifest(str(port_dir / "p"))["items"]
             if not e.get("cached")]
    assert rerun == [victim["name"]]

    mgr = make_mgr([EXAMPLE])
    inline = execute(mgr, mgr.registry, opts(jobs=1, isolate="inline"))
    assert _names(inline.doc) == _names(port)
    assert _schemas(inline.doc) == _schemas(port)

    # each package's compare reads the other's run directory, row for row
    from repro.core import baseline as ref_bl
    for comps in (bl.compare_documents(bl.load_document(str(ref_dir / "r")),
                                       bl.load_document(str(port_dir / "p"))),
                  ref_bl.compare_documents(
                      ref_bl.load_document(str(port_dir / "p")),
                      ref_bl.load_document(str(ref_dir / "r")))):
        assert sorted(c.name for c in comps) == sorted(_names(port))
        assert not [c for c in comps
                    if c.verdict in ("added", "removed", "errors")]


def test_compare_cli_parity_with_reference(tmp_path):
    """Both packages' ``compare`` give the same exit code and the same
    verdict table on the same pair of documents, whichever package wrote
    each; a port document and a reference document pair row for row."""
    base = _doc({"s/a": [10.0, 10.0, 10.1], "s/b": [5.0, 5.0, 5.1],
                 "s/gone": [1.0]})
    new = _doc({"s/a": [20.0, 20.0, 20.2], "s/b": [5.0, 5.1, 5.0],
                "s/new": [2.0]})
    new["benchmarks"].append(_error_rec("s/err"))
    pa, pb = tmp_path / "a.json", tmp_path / "b.json"
    pa.write_text(json.dumps(base))
    pb.write_text(json.dumps(new))
    for (a, b), rc in (((pa, pb), 1), ((pa, pa), 0)):
        port = _cli("repro_torch", "compare", str(a), str(b))
        ref = _cli("repro", "compare", str(a), str(b))
        assert port.returncode == ref.returncode == rc, port.stderr
        assert port.stdout == ref.stdout
    assert "REGRESSION" in port.stdout or rc == 0
