"""The torch port's paper harness (``python -m repro_torch.benchmarks.run``)
against the repository's ``benchmarks/run.py``: the ``derived`` column
and the printed lines of a shard match the reference's on one GB-JSON
document (a failed scope, a crashed and a failed instance, a verdict
column), and ``run_all`` and ``main`` run the example and instr scopes
on the CPU — restricted to them by this test's monkeypatch of
``BUILTIN_SCOPES`` — honouring the reference's env knobs."""
import importlib.util
import json
import os

import pytest

from repro.core.orchestrate import ScopeShard as RefScopeShard
from repro_torch.benchmarks import run as port_run
from repro_torch.core.orchestrate import ScopeShard

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference_harness():
    spec = importlib.util.spec_from_file_location(
        "reference_bench_run", os.path.join(ROOT, "benchmarks", "run.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_harness()


def _rec(name, **extra):
    rec = {"name": name, "run_name": name, "run_type": "iteration",
           "iterations": 10, "real_time": 2.5, "cpu_time": 2.4,
           "time_unit": "us"}
    rec.update(extra)
    return rec


#: One GB-JSON document holding every kind of row the harness prints.
DOC = {"context": {"date": "2026-10-17"}, "benchmarks": [
    _rec("s/bytes/n:4", bytes_per_second=3.2e9),
    _rec("s/items", items_per_second=1.5e6, time_unit="ms"),
    _rec("s/modeled", modeled_s=4.2e-5, real_time=0.0),
    _rec("s/cells", cells=12),
    _rec("s/compile", compile_time_s=0.0123, time_unit="ns"),
    _rec("s/bare", time_unit="s"),
    _rec("s/crashed", error_occurred=True,
         error_message="[crashed] worker exited 42: a, b\nTraceback"),
    _rec("s/failed", error_occurred=True,
         error_message="Traceback (most recent call last):\n"
                       "ValueError: bad, shape"),
    _rec("s/skipped", skipped=True),
    _rec("s/bytes/n:4_mean", run_type="aggregate", run_name="s/bytes/n:4",
         aggregate_name="mean"),
]}


def _lines(harness, shard, capsys, verdicts=None):
    harness._print_shard(shard, verdicts)
    return capsys.readouterr().out.splitlines()


def test_derived_matches_reference():
    from repro.scopeplot import BenchmarkFile as RefFile
    from repro_torch.scopeplot import BenchmarkFile
    ours = [port_run._derived(r) for r in BenchmarkFile.from_dict(DOC)]
    want = [REF._derived(r) for r in RefFile.from_dict(DOC)]
    assert ours == want
    assert ours[:6] == ["3.200GB/s", "1.500Mitems/s", "42.000modeled_us",
                        "12.000cells", "12.300compile_ms", ""]


@pytest.mark.parametrize("verdicts", [None, {"s/bytes/n:4": "regression",
                                             "s/items": "similar"}])
def test_print_shard_matches_reference(capsys, verdicts):
    doc = json.loads(json.dumps(DOC))
    ours = _lines(port_run, ScopeShard("s", "m", "ok", doc), capsys,
                  verdicts)
    want = _lines(REF, RefScopeShard("s", "m", "ok", doc), capsys,
                  verdicts)
    assert ours == want
    assert len(ours) == 8                  # no aggregate, no skipped row
    assert ours[6].startswith("s/crashed,2.50,[crashed] worker exited 42")
    assert ours[7] == "s/failed,2.50,ValueError: bad; shape" + \
        ("" if verdicts is None else ",")


def test_failed_scope_line_matches_reference(capsys):
    err = "Traceback (most recent call last):\nImportError: no module x"
    ours = _lines(port_run, ScopeShard("s", "m", "error", None, err), capsys)
    want = _lines(REF, RefScopeShard("s", "m", "error", None, err), capsys)
    assert ours == want == ["s/SCOPE_FAILED,0.00,ImportError: no module x"]


@pytest.fixture
def two_scopes(monkeypatch, tmp_path):
    """The harness over example and instr only, in a scratch directory,
    with the process-global registry and flags restored afterwards."""
    from repro_torch.core import FLAGS, REGISTRY
    from repro_torch.core import scope as scope_mod
    monkeypatch.setattr(scope_mod, "BUILTIN_SCOPES",
                        ["repro_torch.scopes.example_scope",
                         "repro_torch.scopes.instr_scope"])
    for knob in ("BENCH_JOBS", "BENCH_SHARD_GRAIN", "BENCH_PARAM",
                 "BENCH_RESULTS_DIR", "BENCH_BASELINE", "BENCH_REPORT"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.chdir(tmp_path)
    from repro_torch.core.hooks import HOOKS
    specs, values = dict(FLAGS._specs), dict(FLAGS._values)
    hooks = list(HOOKS._pre_parse), list(HOOKS._post_parse)
    benches = dict(REGISTRY._benchmarks)
    # start as a new process does (core flags only): a scope an earlier
    # test in this process loaded left its flags declared, and loading
    # it again would fail
    for name in [n for n, spec in FLAGS._specs.items()
                 if spec.owner != "core"]:
        del FLAGS._specs[name]
        FLAGS._values.pop(name, None)
    HOOKS._pre_parse[:] = [h for h in HOOKS._pre_parse if h[0] == "core"]
    HOOKS._post_parse[:] = [h for h in HOOKS._post_parse if h[0] == "core"]
    REGISTRY._benchmarks.clear()
    yield tmp_path
    FLAGS._specs.clear(), FLAGS._specs.update(specs)
    FLAGS._values.clear(), FLAGS._values.update(values)
    HOOKS._pre_parse[:], HOOKS._post_parse[:] = hooks
    REGISTRY._benchmarks.clear(), REGISTRY._benchmarks.update(benches)


def test_run_all_runs_the_builtin_set_on_the_cpu(two_scopes):
    result, unavailable, scopes = port_run.run_all(min_time=0.002,
                                                   device="cpu")
    assert scopes == ["example", "instr"] and unavailable == {}
    assert result.doc["context"]["device_kind"] == "cpu"
    for scope in scopes:
        shard = result.shard(scope)
        assert shard.status == "ok", shard.error
        assert shard.doc["benchmarks"]


def test_main_prints_table_iv_and_figure_3(two_scopes, capsys,
                                           monkeypatch):
    results = two_scopes / "runs"
    monkeypatch.setenv("BENCH_RESULTS_DIR", str(results))
    monkeypatch.setenv("BENCH_BASELINE", str(two_scopes / "missing.json"))
    monkeypatch.setenv("BENCH_REPORT", "1")
    monkeypatch.setattr(port_run, "run_all",
                        lambda run_all=port_run.run_all, **kw:
                        run_all(min_time=0.002, **kw))
    assert port_run.main(["--device", "cpu"]) == 0
    captured = capsys.readouterr()
    rows = [line.split(",") for line in captured.out.splitlines()]
    names = [r[0] for r in rows]
    assert {n.split("/")[0] for n in names} == \
        {"example", "instr", "fig3_plot", "report"}
    assert all(len(r) == 3 for r in rows)     # no verdict column
    assert "BENCH_BASELINE" in captured.err
    fig = dict((r[0], r[2]) for r in rows)["fig3_plot"]
    assert fig.endswith("fig3_saxpy.svg") and os.path.exists(fig)
    assert os.path.exists(dict((r[0], r[2]) for r in rows)["report"])
    assert os.path.exists(results / "history.jsonl")


def test_bench_param_selects_instances(two_scopes, capsys,
                                            monkeypatch):
    monkeypatch.setenv("BENCH_PARAM", "op=exp")
    monkeypatch.setattr(port_run, "run_all",
                        lambda run_all=port_run.run_all, **kw:
                        run_all(min_time=0.002, **kw))
    assert port_run.main(["--device", "cpu"]) == 0
    names = [line.split(",")[0]
             for line in capsys.readouterr().out.splitlines()]
    # scope grain: example runs and matches nothing, so prints no row
    # (its empty document still feeds the figure)
    assert names == ["instr/elementwise/op:exp/n:1048576", "fig3_plot"]


def test_main_needs_a_card_unless_told_cpu(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_run.main([]) == 2
    assert "--device cpu" in capsys.readouterr().err
