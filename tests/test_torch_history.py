"""The torch port's run-history store (``repro_torch.core.history``):
the reference's ``tests/test_history.py`` run through the port, one test
for each of the reference's, plus parity: the two packages fold the same
history file into the same windowed baseline and drift verdicts."""
import pytest

from repro.core import history as ref_hist
from repro_torch.core import history as hist
from repro_torch.core.baseline import compare_documents, load_document
from repro_torch.core.sysinfo import context_digest

CTX = {"run_id": "r?", "date": "2026-07-31T00:00:00",
       "host_name": "fixturehost", "machine": "x86_64", "num_cpus": 8,
       "torch_version": "0.0-test", "cuda_version": "12.0",
       "backend": "cuda", "device_count": 1,
       "device_kind": "NVIDIA H100 80GB HBM3", "sm_count": 132,
       "compute_capability": "9.0", "target_hardware": "h100_sxm",
       "scope_version": "1.0.0-torch"}


def make_doc(run_id, means, date="2026-07-31T00:00:00", errors=()):
    """A minimal merged GB-JSON document with fixed context."""
    ctx = dict(CTX, run_id=run_id, date=date)
    benchmarks = []
    for name, mean in means.items():
        benchmarks.append({
            "name": name, "run_name": name, "run_type": "iteration",
            "repetitions": 1, "repetition_index": 0, "threads": 1,
            "iterations": 1, "real_time": mean, "cpu_time": mean,
            "time_unit": "s"})
    for name in errors:
        benchmarks.append({
            "name": name, "run_name": name, "run_type": "iteration",
            "repetitions": 1, "repetition_index": 0, "threads": 1,
            "iterations": 0, "real_time": 0.0, "cpu_time": 0.0,
            "time_unit": "s", "error_occurred": True,
            "error_message": "boom"})
    return {"context": ctx, "benchmarks": benchmarks}


def test_append_and_verdicts(tmp_path):
    d = str(tmp_path)
    r1 = hist.append_run(d, make_doc("r1", {"s/a": 1.0, "s/b": 2.0}))
    assert [r["verdict"] for r in r1] == ["new", "new"]
    assert all(r["run_id"] == "r1" for r in r1)
    assert all(r["ts"] == "2026-07-31T00:00:00" for r in r1)
    assert all(r["sysinfo"] == context_digest(CTX) for r in r1)

    r2 = hist.append_run(d, make_doc("r2", {"s/a": 1.05, "s/b": 3.0}))
    assert {r["name"]: r["verdict"] for r in r2} == \
        {"s/a": "similar", "s/b": "regression"}
    r3 = hist.append_run(d, make_doc("r3", {"s/a": 1.05, "s/b": 1.5}))
    assert {r["name"]: r["verdict"] for r in r3}["s/b"] == "improvement"
    assert r3[0]["ratio"] == pytest.approx(1.0)

    records = hist.load_history(hist.history_path(d))
    assert len(records) == 6
    assert hist.run_ids(records) == ["r1", "r2", "r3"]
    assert [r["run_id"] for r in hist.series(records, "s/a")] == \
        ["r1", "r2", "r3"]


def test_append_dedups_by_run_id(tmp_path):
    d = str(tmp_path)
    assert hist.append_run(d, make_doc("r1", {"s/a": 1.0}))
    assert hist.append_run(d, make_doc("r1", {"s/a": 9.9})) == []
    assert len(hist.load_history(hist.history_path(d))) == 1


def test_errored_instances_recorded(tmp_path):
    recs = hist.append_run(str(tmp_path), make_doc("r1", {"s/a": 1.0},
                                                   errors=["s/bad"]))
    by_name = {r["name"]: r for r in recs}
    assert by_name["s/bad"]["verdict"] == "errored"
    assert by_name["s/bad"]["mean_s"] is None
    assert by_name["s/bad"]["errors"] == 1


def test_torn_line_skipped(tmp_path):
    d = str(tmp_path)
    hist.append_run(d, make_doc("r1", {"s/a": 1.0}))
    path = hist.history_path(d)
    with open(path, "a") as f:
        f.write('{"run_id": "r2", "name": "s/a", "mea')
    records = hist.load_history(path)
    assert len(records) == 1 and records[0]["run_id"] == "r1"


def test_corrupt_lines_skipped_not_raised(tmp_path):
    d = str(tmp_path)
    hist.append_run(d, make_doc("r1", {"s/a": 1.0}))
    path = hist.history_path(d)
    with open(path, "ab") as f:
        f.write(b'{"run_id": "rX", "name": "s/a", "mean_s":\n')
        f.write(b"\xff\xfe garbage bytes \xff\n")
        f.write(b'[1, 2, 3]\n')
        f.write(b'{"run_id": "rY"}\n')
        f.write(b'\n')
    hist.append_run(d, make_doc("r2", {"s/a": 1.01}))
    records = hist.load_history(path)
    assert hist.run_ids(records) == ["r1", "r2"]
    assert len(records) == 2
    # the port has no store index: both readers scan, alike
    assert hist.scan_history(path) == records
    assert hist.load_history(path, store=False) == records


def test_window_document_pools_runs(tmp_path):
    d = str(tmp_path)
    for i, mean in enumerate([1.0, 1.1, 0.9, 1.0, 1.2, 1.05]):
        hist.append_run(d, make_doc(f"r{i}", {"s/a": mean}))
    records = hist.load_history(hist.history_path(d))
    doc = hist.window_document(records, window=4)
    assert [b["real_time"] for b in doc["benchmarks"]] == \
        [0.9, 1.0, 1.2, 1.05]
    assert all(b["time_unit"] == "s" for b in doc["benchmarks"])
    assert doc["benchmarks"][0]["run_name"] == "s/a"


def test_load_document_reads_history_as_windowed_baseline(tmp_path):
    d = str(tmp_path)
    for i in range(3):
        hist.append_run(d, make_doc(f"r{i}", {"s/a": 1.0 + 0.01 * i}))
    doc = load_document(hist.history_path(d))
    assert len(doc["benchmarks"]) == 3
    assert doc["context"]["history_window"] == hist.DEFAULT_WINDOW
    comps = compare_documents(doc, make_doc("new", {"s/a": 5.0}))
    assert [c.verdict for c in comps] == ["regression"]


def test_detect_drift_catches_slow_drift(tmp_path):
    d = str(tmp_path)
    for i, m in enumerate([1.0, 1.04, 1.08, 1.12, 1.17]):
        recs = hist.append_run(d, make_doc(f"r{i}", {"s/a": m}))
        if i:
            assert recs[0]["verdict"] == "similar"
    records = hist.load_history(hist.history_path(d))
    assert [c.verdict for c in hist.detect_drift(records, window=4)] == \
        ["regression"]
    comps = hist.detect_drift(
        [r for r in records if r["run_id"] in ("r0", "r1")], window=4)
    assert [c.verdict for c in comps] == ["similar"]


def test_detect_drift_needs_two_runs(tmp_path):
    d = str(tmp_path)
    hist.append_run(d, make_doc("r1", {"s/a": 1.0}))
    assert hist.detect_drift(
        hist.load_history(hist.history_path(d))) == []


def test_single_shot_regression_not_masked_by_old_noise(tmp_path):
    d = str(tmp_path)
    doc1 = make_doc("r1", {})
    doc1["benchmarks"] = [
        {"name": "s/a", "run_name": "s/a", "run_type": "iteration",
         "repetitions": 3, "repetition_index": i, "threads": 1,
         "iterations": 1, "real_time": t, "cpu_time": t, "time_unit": "s"}
        for i, t in enumerate([0.7, 1.0, 1.3])]
    r1 = hist.append_run(d, doc1)
    assert r1[0]["n"] == 3 and r1[0]["stddev_s"] > 0
    r2 = hist.append_run(d, make_doc("r2", {"s/a": 1.4}))
    assert r2[0]["verdict"] == "regression"


def test_cross_machine_records_never_compared(tmp_path):
    d = str(tmp_path)
    hist.append_run(d, make_doc("r1", {"s/a": 1.0}))
    other = make_doc("r2", {"s/a": 5.0})
    other["context"]["device_kind"] = "NVIDIA H100 PCIe"   # another card
    r2 = hist.append_run(d, other)
    assert r2[0]["verdict"] == "new"
    records = hist.load_history(hist.history_path(d))
    doc = hist.window_document(records)
    assert [b["real_time"] for b in doc["benchmarks"]] == [5.0]
    assert doc["context"]["history_sysinfo"] == r2[0]["sysinfo"]
    assert all(c.verdict == "added" for c in hist.detect_drift(records))


def test_context_digest_stable_and_sensitive():
    a = context_digest(CTX)
    assert a == context_digest(dict(CTX, date="1999-01-01",
                                    run_id="other"))
    assert a != context_digest(dict(CTX, host_name="elsewhere"))
    assert a != context_digest(dict(CTX, allow_tf32=True))
    assert len(a) == 12


def test_orchestrator_appends_history(tmp_path):
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.orchestrate import OrchestratorOptions, execute
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.runner import RunOptions
    from repro_torch.core.scope import ScopeManager

    results = str(tmp_path / "results")
    for rid in ("h1", "h2"):
        mgr = ScopeManager(registry=BenchmarkRegistry(),
                           flags=FlagRegistry(), hooks=HookChain())
        mgr.load(["repro_torch.scopes.example_scope"])
        mgr.register_all()
        execute(mgr, mgr.registry, OrchestratorOptions(
            jobs=1, isolate="inline", shard_grain="benchmark",
            run=RunOptions(min_time=0.002, device="cpu"),
            results_dir=results, run_id=rid))
    records = hist.load_history(hist.history_path(results))
    assert hist.run_ids(records) == ["h1", "h2"]
    assert len(hist.for_run(records, "h1")) == 8
    for rec in hist.for_run(records, "h2"):
        assert rec["verdict"] in ("similar", "regression", "improvement")
        assert rec["mean_s"] > 0


def test_history_folds_like_the_reference(tmp_path):
    """One history file, appended by both packages, reads back into the
    same records, windowed document and drift verdicts in each."""
    d = str(tmp_path)
    means = [1.0, 1.04, 1.08, 1.12, 1.17]
    for i, m in enumerate(means):
        writer = hist if i % 2 else ref_hist
        writer.append_run(d, make_doc(f"r{i}", {"s/a": m, "s/b": 2.0}))
    path = hist.history_path(d)
    assert hist.load_history(path) == ref_hist.load_history(path,
                                                            store=False)
    assert hist.window_document(path, window=3) == \
        ref_hist.window_document(path, window=3)
    records = hist.load_history(path)
    port = [(c.name, c.verdict, c.ratio)
            for c in hist.detect_drift(records, window=4)]
    ref = [(c.name, c.verdict, c.ratio)
           for c in ref_hist.detect_drift(records, window=4)]
    assert port == ref and ("s/a", "regression") == port[0][:2]
