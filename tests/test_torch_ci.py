"""Continuous benchmarking in the torch port: ``run --since`` delta runs
replay fresh instances as cached while keeping documents complete,
editing one family re-plans exactly that family, and ``ci`` gates (exit
1) on an injected regression — the reference's ``tests/test_ci.py``
through the port on ``--device cpu``.  The gate's families report a
manual time, so its clean-then-regression case does not depend on how
busy the host is; a record of a CPU run never vouches for a card run."""
import importlib
import json
import os
import sys

import pytest

from repro_torch.core import history as hist
from repro_torch.core import sysinfo
from repro_torch.core.ci import ci_main
from repro_torch.core.flags import FLAGS
from repro_torch.core.main import plan_main, run_main
from repro_torch.core.registry import REGISTRY

SCOPE_TEMPLATE = '''\
from repro_torch.core import Scope, State, benchmark


def _register(registry):
    @benchmark(scope="tmpci", registry=registry)
    def alpha(state):
        """{alpha_doc}"""
        while state.keep_running():
            state.set_iteration_time(1e-3)
        state.set_items_processed(1)
    alpha.manual_time().set_iterations(4)
    alpha.set_sync(lambda ctx: None)

    @benchmark(scope="tmpci", registry=registry)
    def beta(state):
        while state.keep_running():
            state.set_iteration_time({beta_time})
        state.set_items_processed(1)
    beta.manual_time().set_iterations(4)
    beta.set_sync(lambda ctx: None)


SCOPE = Scope(name="tmpci", register=_register)
'''

BETA_FAST = "2e-3"
BETA_SLOW = "2e-1"

MODNAME = "tmpci_torch_scope_mod"
FAST_FLAGS = ["--device", "cpu", "--benchmark_min_time", "0.002"]


@pytest.fixture
def scope_file(tmp_path, monkeypatch):
    """A throwaway scope module the tests can rewrite + reload."""
    path = tmp_path / f"{MODNAME}.py"
    path.write_text(SCOPE_TEMPLATE.format(alpha_doc="v1",
                                          beta_time=BETA_FAST))
    monkeypatch.syspath_prepend(str(tmp_path))
    device = FLAGS.get("device")
    yield path
    sys.modules.pop(MODNAME, None)
    FLAGS.set("device", device)


def rewrite(path, alpha_doc="v1", beta_time=BETA_FAST):
    path.write_text(SCOPE_TEMPLATE.format(alpha_doc=alpha_doc,
                                          beta_time=beta_time))
    importlib.reload(sys.modules[MODNAME])


def cli(fn, argv):
    REGISTRY.reset()              # run/ci register into the global registry
    return fn(argv, scope_modules=[MODNAME])


def run_args(d, run_id, *extra):
    return ["--results-dir", d, "--run-id", run_id,
            "--shard-grain", "benchmark", *extra, *FAST_FLAGS]


def merged(d, run_id):
    with open(os.path.join(d, run_id, "merged.json")) as f:
        return json.load(f)


def split_cached(doc):
    recs = [b for b in doc["benchmarks"] if b["run_type"] == "iteration"]
    live = sorted(b["name"] for b in recs if not b.get("cached"))
    cached = sorted(b["name"] for b in recs if b.get("cached"))
    return live, cached


def test_delta_run_skips_fresh_and_stays_complete(scope_file, tmp_path,
                                                  capsys):
    d = str(tmp_path / "results")

    assert cli(run_main, run_args(d, "full")) == 0
    live, cached = split_cached(merged(d, "full"))
    assert live == ["tmpci/alpha", "tmpci/beta"] and cached == []
    doc = merged(d, "full")
    assert sorted(doc["context"]["fingerprints"]) == live
    records = hist.load_history(hist.history_path(d))
    assert all(len(r.get("fingerprint", "")) == 16 for r in records)
    assert {r["name"]: r["fingerprint"] for r in records} == \
        doc["context"]["fingerprints"]

    # unchanged tree: --since plans zero instances, replays everything
    assert cli(run_main, run_args(d, "noop", "--since")) == 0
    live, cached = split_cached(merged(d, "noop"))
    assert live == [] and cached == ["tmpci/alpha", "tmpci/beta"]
    by_name = {b["name"]: b for b in merged(d, "noop")["benchmarks"]}
    assert by_name["tmpci/alpha"]["cached_from_run"] == "full"
    assert by_name["tmpci/beta"]["real_time"] == pytest.approx(2e-3)

    # the plan view agrees without running anything
    assert cli(plan_main, ["--since", "--results-dir", d,
                           "--device", "cpu"]) == 0
    assert "fingerprint-fresh (--since)" in capsys.readouterr().out

    # cached replays land in history but marked, and never vouch again
    records = hist.load_history(hist.history_path(d))
    noop = [r for r in records if r["run_id"] == "noop"]
    assert len(noop) == 2 and all(r["cached"] for r in noop)

    # edit ONE family body → exactly that family re-measures
    rewrite(scope_file, alpha_doc="v2")
    assert cli(run_main, run_args(d, "delta", "--since")) == 0
    live, cached = split_cached(merged(d, "delta"))
    assert live == ["tmpci/alpha"] and cached == ["tmpci/beta"]


def test_cpu_records_never_vouch_for_a_card_run(scope_file, tmp_path,
                                                capsys, monkeypatch):
    """The freshness digest is built for the run's own device: after a
    CPU run, a plan for the card (the default device) prunes nothing,
    and on a host without a card it is computed without touching
    CUDA."""
    d = str(tmp_path / "results")
    assert cli(run_main, run_args(d, "cpu")) == 0
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    real = sysinfo._torch_info

    def cpu_only(device):
        assert device == "cpu", "CUDA touched for a freshness digest"
        return real(device)
    monkeypatch.setattr(sysinfo, "_torch_info", cpu_only)
    capsys.readouterr()
    assert cli(plan_main, ["--since", "--results-dir", d]) == 0
    out = capsys.readouterr().out
    assert "fingerprint-fresh" not in out and "tmpci/alpha" in out
    assert cli(plan_main, ["--since", "--results-dir", d,
                           "--device", "cpu"]) == 0
    assert "all 2 fingerprint-fresh" in capsys.readouterr().out


def test_since_requires_results_dir_and_instance_grain(scope_file):
    # an ephemeral run (--results-dir '') has no history to consult
    assert cli(run_main, ["--since", "--results-dir", "",
                          *FAST_FLAGS]) == 2
    assert cli(run_main, ["--since", "--results-dir", "x",
                          "--shard-grain", "scope", *FAST_FLAGS]) == 2


def test_since_iso_floor_re_measures_old_records(scope_file, tmp_path):
    d = str(tmp_path / "results")
    assert cli(run_main, run_args(d, "full")) == 0
    # everything is fresh for a bare --since, stale against tomorrow
    assert cli(run_main, run_args(d, "n1", "--since")) == 0
    assert split_cached(merged(d, "n1"))[0] == []
    assert cli(run_main,
               run_args(d, "n2", "--since", "2999-01-01")) == 0
    live, cached = split_cached(merged(d, "n2"))
    assert live == ["tmpci/alpha", "tmpci/beta"] and cached == []


def test_ci_gate_clean_then_regression(scope_file, tmp_path, capsys):
    d = str(tmp_path / "results")
    ci = ["--results-dir", d, "--no-report", *FAST_FLAGS]

    # first run measures everything, gate clean
    assert cli(ci_main, ["--run-id", "c1", *ci]) == 0
    live, cached = split_cached(merged(d, "c1"))
    assert live == ["tmpci/alpha", "tmpci/beta"] and cached == []
    records = hist.load_history(hist.history_path(d))
    assert all(r["tag"] == "ci" for r in records)

    # unchanged tree: zero measured, still exit 0
    assert cli(ci_main, ["--run-id", "c2", *ci]) == 0
    out = capsys.readouterr().out
    assert "0 measured" in out and "2 cached" in out

    # a second real measurement so the drift window has depth
    assert cli(ci_main, ["--run-id", "c3", "--full", *ci]) == 0

    # inject a 100x regression into beta only → ci re-measures it, fails
    rewrite(scope_file, beta_time=BETA_SLOW)
    assert cli(ci_main, ["--run-id", "c4", *ci]) == 1
    live, cached = split_cached(merged(d, "c4"))
    assert live == ["tmpci/beta"] and cached == ["tmpci/alpha"]
    records = hist.load_history(hist.history_path(d))
    beta = [r for r in records if r["run_id"] == "c4"
            and r["name"] == "tmpci/beta"]
    assert beta and not beta[0].get("cached")
    assert beta[0]["mean_s"] == pytest.approx(0.2)


def test_ci_without_no_report_still_gates(scope_file, tmp_path, capsys,
                                         monkeypatch):
    """Without --no-report ci renders the run's report after the gate; a
    report that raises is logged and leaves the gate's exit code as it
    was, clean or failed."""
    d = str(tmp_path / "results")
    assert cli(ci_main, ["--results-dir", d, "--run-id", "r",
                         *FAST_FLAGS]) == 0
    assert "ci: ok — 2 measured, 0 cached" in capsys.readouterr().out
    report = os.path.join(d, "r", "report")
    assert os.path.exists(os.path.join(report, "index.html"))
    assert os.path.exists(os.path.join(report, "tmpci_times.svg"))

    import repro_torch.scopeplot.report as port_report

    def boom(argv):
        raise RuntimeError("report broke")
    monkeypatch.setattr(port_report, "report_main", boom)
    assert cli(ci_main, ["--results-dir", d, "--run-id", "r2", "--full",
                         *FAST_FLAGS]) == 0
    assert "ci: ok — 2 measured, 0 cached" in capsys.readouterr().out
    assert not os.path.exists(os.path.join(d, "r2", "report"))
    rewrite(scope_file, beta_time=BETA_SLOW)
    assert cli(ci_main, ["--results-dir", d, "--run-id", "r3",
                         *FAST_FLAGS]) == 1


def test_ci_usage_errors(scope_file, tmp_path):
    assert cli(ci_main, ["--results-dir", ""]) == 2
    assert cli(ci_main, ["--results-dir", str(tmp_path),
                         "--param", "nonsense"]) == 2
    assert cli(ci_main, ["--results-dir", str(tmp_path),
                         "--benchmark_filter", "no/such/bench"]) == 2


def test_ci_refuses_the_card_without_one(scope_file, tmp_path,
                                        monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli(ci_main, ["--results-dir", str(tmp_path), "--no-report",
                         "--device", "cuda"]) == 2
    assert not os.path.exists(hist.history_path(str(tmp_path)))
