"""The port's report (``repro_torch.scopeplot.report``) against the
reference's: ``report.md`` on the reference's fixture equals
``tests/data/report_golden.md`` outside "System" (with ``.svg`` for
``.png``), and "System" lists the port's context keys; the reference's
report cases (spec round-trips, ``load_spec``'s messages and line
numbers word for word, batch staleness, two runs then a trend, latency
columns, ``report_main``, the history report) run through the port; a
tune report over a port tune run on the CPU equals the reference's
report of the same ``tune.json``; and ``report`` and ``batch`` run in a
process that cannot import matplotlib or PyYAML."""
import json
import os
import shutil
import xml.etree.ElementTree as ET

import pytest
import yaml

from repro.scopeplot import plot as ref_plot
from repro.scopeplot.report import generate_tune_report as ref_tune_report
from repro_torch.core import history as hist
from repro_torch.core.sysinfo import build_context, context_digest
from repro_torch.scopeplot.plot import (PLOT_TYPES, SpecError, is_stale,
                                        load_spec, render_spec,
                                        render_spec_dir)
from repro_torch.scopeplot.report import (_SYSINFO_KEYS,
                                          generate_history_report,
                                          generate_run_report,
                                          generate_tune_report, report_main)
from test_report import (GOLDEN, _spec_for, _write_spec, fixture_run_dir,
                         gb_doc, latency_run_dir)
from test_torch_scopeplot import run_blocked
from test_torch_tune import port_tune, scopes  # noqa: F401 (fixture)


def sections(md):
    """``## title`` → body, in order."""
    out = {}
    for chunk in md.split("\n## ")[1:]:
        title, _, body = chunk.partition("\n")
        out[title] = body
    return out


def svg_marks(path):
    root = ET.parse(path).getroot()
    return [e for e in root.iter() if "mark" in e.get("class", "").split()]


# ---------------------------------------------------------------------------
# the golden report
# ---------------------------------------------------------------------------

def test_report_md_matches_golden_outside_system(tmp_path):
    run_dir = fixture_run_dir(tmp_path)
    got = open(generate_run_report(str(run_dir))["md"]).read()
    want = open(GOLDEN).read().replace(".png", ".svg")
    assert got.split("\n## ")[0] == want.split("\n## ")[0]    # title, meta
    got_s, want_s = sections(got), sections(want)
    assert list(got_s) == list(want_s)
    for title in want_s:
        if title != "System":
            assert got_s[title] == want_s[title], title
    # System: the port's keys, in the port's order, then the digest
    ctx = json.loads((run_dir / "merged.json").read_text())["context"]
    rows = [line.split(" | ") for line in got_s["System"].splitlines()
            if line.startswith("| ") and not line.startswith("| key")]
    keys = [r[0][2:] for r in rows]
    assert keys == [k for k in _SYSINFO_KEYS if ctx.get(k)] + \
        ["sysinfo digest"]
    assert rows[-1][1].rstrip(" |") == context_digest(ctx)
    # regenerating is byte-identical
    again = open(generate_run_report(str(run_dir))["md"]).read()
    assert again == got


def test_system_table_names_the_port_context_keys(tmp_path):
    """A context the port writes fills the table: torch and CUDA in
    place of jax, the driver, compute capability and SM count in place
    of xla_flags."""
    ctx = build_context(device="cpu")
    ctx.update({"cuda_version": "12.8", "driver_version": "570.1",
                "device_kind": "NVIDIA H100 80GB HBM3",
                "compute_capability": "9.0", "sm_count": 132,
                "backend": "cuda"})
    assert "jax_version" not in _SYSINFO_KEYS
    assert "xla_flags" not in _SYSINFO_KEYS
    order = list(_SYSINFO_KEYS)
    assert order.index("torch_version") == order.index("num_cpus") + 1
    for key in ("torch_version", "cuda_version", "driver_version",
                "compute_capability", "sm_count"):
        assert key in ctx
    run_dir = tmp_path / "results" / "r"
    run_dir.mkdir(parents=True)
    doc = gb_doc("r", {"s/a": 1.0})
    doc["context"] = {**ctx, "run_id": "r"}
    (run_dir / "merged.json").write_text(json.dumps(doc))
    system = sections(open(generate_run_report(str(run_dir))["md"]).read()
                      )["System"]
    for row in ("| device_kind | NVIDIA H100 80GB HBM3 |",
                "| cuda_version | 12.8 |", "| compute_capability | 9.0 |",
                "| sm_count | 132 |", "| driver_version | 570.1 |",
                f"| torch_version | {ctx['torch_version']} |"):
        assert row in system


# ---------------------------------------------------------------------------
# the reference's report cases, through the port
# ---------------------------------------------------------------------------

def test_report_artifacts(tmp_path):
    run_dir = fixture_run_dir(tmp_path)
    paths = generate_run_report(str(run_dir))
    out = run_dir / "report"
    assert paths["html"] == str(out / "index.html")
    for f in ("index.html", "report.md", "s_times.svg", "s_trend.svg",
              "s_speedup.svg"):
        assert (out / f).exists(), f
    html = open(paths["html"]).read()
    assert '<img src="s_times.svg"' in html
    assert "Drift watch" in html
    specs = sorted(os.listdir(out / "specs"))
    assert specs == ["s_speedup.yaml", "s_times.yaml", "s_trend.yaml"]
    for spec in specs:
        text = (out / "specs" / spec).read_text()
        loaded = yaml.safe_load(text)            # PyYAML reads them alike
        assert loaded == load_spec(str(out / "specs" / spec))
        assert loaded["output"] == f"../{spec[:-5]}.svg"
        assert len(svg_marks(str(out / f"{spec[:-5]}.svg"))) >= \
            len(loaded["series"])
    for result in render_spec_dir(str(out / "specs"), force=True):
        assert result[2] == "rendered", result
    # the reference reads and renders the port's specs (matplotlib
    # writes the .svg each names)
    for spec in specs:
        assert ref_plot.render_spec(
            ref_plot.load_spec(str(out / "specs" / spec)),
            base_dir=str(out / "specs")).endswith(".svg")


def test_report_on_older_run_ignores_later_runs(tmp_path):
    results = fixture_run_dir(tmp_path).parent
    run1 = results / "r1"
    run1.mkdir()
    (run1 / "merged.json").write_text(json.dumps(
        gb_doc("r1", {"s/a/n:1": 2.2, "s/a/n:2": 4.0},
               date="2026-07-30T00:00:00"), indent=2))
    paths = generate_run_report(str(run1))
    md = open(paths["md"]).read()
    assert "speedup" not in md
    assert "Needs at least two recorded runs" in md
    assert "`r2`" not in md.split("## Drift watch")[1]
    trend = load_spec(str(run1 / "report" / "specs" / "s_trend.yaml"))
    scoped = hist.load_history(os.path.join(
        str(run1 / "report" / "specs"), trend["series"][0]["input_file"]))
    assert hist.run_ids(scoped) == ["r1"]


def test_history_report(tmp_path):
    run_dir = fixture_run_dir(tmp_path)
    results = run_dir.parent
    paths = generate_history_report(str(results / "history.jsonl"))
    md = open(paths["md"]).read()
    assert "| r1 |" in md and "| r2 |" in md
    assert (results / "report" / "s_trend.svg").exists()
    assert svg_marks(str(results / "report" / "s_trend.svg"))


def test_report_main_cli(tmp_path, capsys):
    from repro.scopeplot.report import report_main as ref_report_main
    run_dir = fixture_run_dir(tmp_path)
    results = str(run_dir.parent)
    assert report_main(["r2", "--results-dir", results]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("index.html") and out[1].endswith("report.md")
    assert report_main(["history", "--results-dir", results]) == 0
    capsys.readouterr()
    # unknown run: exit 2, the error names the known runs, word for word
    assert report_main(["nope", "--results-dir", results]) == 2
    err = capsys.readouterr().err
    assert "r2" in err
    assert ref_report_main(["nope", "--results-dir", results]) == 2
    assert capsys.readouterr().err == err
    # no history file: exit 2 as the reference's
    empty = str(tmp_path / "empty")
    assert report_main(["history", "--results-dir", empty]) == 2
    err = capsys.readouterr().err
    assert ref_report_main(["history", "--results-dir", empty]) == 2
    assert capsys.readouterr().err == err
    # a run id or --serve is required, as the reference's parser says
    with pytest.raises(SystemExit) as e:
        report_main(["--results-dir", results])
    assert e.value.code == 2


def test_report_through_the_port_cli(tmp_path, capsys):
    from repro_torch.core.main import main
    run_dir = fixture_run_dir(tmp_path)
    assert main(["report", "r2", "--results-dir",
                 str(run_dir.parent)]) == 0
    assert capsys.readouterr().out.splitlines()[1].endswith("report.md")


@pytest.mark.parametrize("ptype", PLOT_TYPES)
def test_spec_roundtrip_each_plot_type(tmp_path, ptype):
    run_dir = fixture_run_dir(tmp_path)
    src = str(run_dir / "merged.json")
    history_file = str(run_dir.parent / "history.jsonl")
    spec = _spec_for(ptype, src, history_file)
    spec["output"] = str(tmp_path / f"{ptype}.png")
    spec_path = tmp_path / f"{ptype}.yaml"
    spec_path.write_text(yaml.safe_dump(spec))
    loaded = load_spec(str(spec_path))
    assert loaded == yaml.safe_load(spec_path.read_text())
    assert loaded["type"] == ptype
    out = render_spec(loaded)
    assert out == str(tmp_path / f"{ptype}.svg")
    assert os.path.exists(out) and os.path.getsize(out) > 0
    if ptype != "latency_cdf":          # the fixture has no latency grid
        assert len(svg_marks(out)) >= 1


# -- load_spec's error contract, word for word ------------------------------

def _both_raise(path):
    with pytest.raises(SpecError) as port:
        load_spec(path)
    with pytest.raises(ref_plot.SpecError) as ref:
        ref_plot.load_spec(path)
    return port.value, ref.value


def test_load_spec_unknown_type_line_numbered(tmp_path):
    p = _write_spec(tmp_path,
                    "title: x\ntype: pie\nseries:\n  - input_file: r.json\n")
    port, ref = _both_raise(p)
    assert str(port) == str(ref)
    assert f"{p}:2: " in str(port)
    assert "unknown plot type 'pie'" in str(port)
    for t in PLOT_TYPES:
        assert t in str(port)
    assert isinstance(port, ValueError) and port.line == 2


@pytest.mark.parametrize("text,match", [
    ("type: line\noutput: [a, b]\nseries:\n  - input_file: r.json\n",
     r"spec\.yaml:2: 'output'"),
    ("title: x\ntype: line\n", "non-empty 'series'"),
    ("type: line\nseries:\n  - label: a\n",
     r"series\[0\] needs an 'input_file'"),
    ("type: speedup\nseries:\n  - input_file: r.json\n",
     "needs a 'baseline'"),
    ("[1, 2]\n", "must be a YAML mapping"),
    ("type: line\nseries:\n  - input_file: r.json\n    params: [a]\n",
     r"'params' must be a mapping"),
    ("type: line\nseries:\n  - input_file: r.json\n    group_by: 3\n",
     r"'group_by' must be an axis"),
    ("type: timeseries\nseries:\n  - input_file: h.jsonl\n"
     "    group_by: dtype\n", "not available for timeseries"),
    ("type: line\nseries:\n  - just a string\n",
     r"series\[0\] must be a mapping"),
    ("\n\ntype: speedup\nbaseline: x\nseries:\n  - input_file: r.json\n",
     r"spec\.yaml:4: speedup spec needs a 'baseline'"),
    ("", "must be a YAML mapping"),
])
def test_load_spec_messages_equal_the_reference(tmp_path, text, match):
    p = _write_spec(tmp_path, text)
    port, ref = _both_raise(p)
    assert str(port) == str(ref)
    assert port.line == ref.line
    import re
    assert re.search(match, str(port))


def test_load_spec_invalid_yaml(tmp_path):
    p = _write_spec(tmp_path, "type: line\n  bad indent: [\n")
    port, ref = _both_raise(p)
    assert "invalid YAML" in str(port) and "invalid YAML" in str(ref)
    assert port.line == 2


def test_load_spec_refuses_outside_the_subset(tmp_path):
    """PyYAML reads an anchor; the port refuses it at its line."""
    p = _write_spec(tmp_path, "type: line\nseries:\n"
                              "  - input_file: &f r.json\n")
    assert ref_plot.load_spec(p)["series"][0]["input_file"] == "r.json"
    with pytest.raises(SpecError, match=r"spec\.yaml:3: invalid YAML "
                                        r"\(anchors"):
        load_spec(p)


# -- batch mode ---------------------------------------------------------------

def test_batch_renders_only_stale(tmp_path):
    run_dir = fixture_run_dir(tmp_path)
    src = run_dir / "merged.json"
    specs = tmp_path / "specs"
    specs.mkdir()
    for name in ("one", "two"):
        spec = {"type": "bar", "output": f"{name}.png",
                "series": [{"input_file": str(src), "xfield": "n",
                            "yfield": "real_time"}]}
        (specs / f"{name}.yaml").write_text(yaml.safe_dump(spec))
    first = render_spec_dir(str(specs))
    assert [s for _, _, s in first] == ["rendered", "rendered"]
    assert [os.path.basename(o) for _, o, _ in first] == \
        ["one.svg", "two.svg"]
    second = render_spec_dir(str(specs))
    assert [s for _, _, s in second] == ["fresh", "fresh"]
    future = os.path.getmtime(specs / "one.svg") + 60
    os.utime(src, (future, future))
    spec = load_spec(str(specs / "one.yaml"))
    assert is_stale(str(specs / "one.yaml"), spec)
    third = render_spec_dir(str(specs))
    assert [s for _, _, s in third] == ["rendered", "rendered"]
    assert not (specs / "one.png").exists()
    (specs / "zz.yaml").write_text("type: pie\nseries: []\n")
    results = render_spec_dir(str(specs), force=True)
    assert [s.split(":")[0] for _, _, s in results] == \
        ["rendered", "rendered", "error"]


# -- two orchestrated runs, then the trend ------------------------------------

def test_two_runs_then_report_shows_trend(tmp_path):
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.orchestrate import OrchestratorOptions, execute
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.runner import RunOptions
    from repro_torch.core.scope import ScopeManager

    results = str(tmp_path / "results")
    for rid in ("e1", "e2"):
        mgr = ScopeManager(registry=BenchmarkRegistry(),
                           flags=FlagRegistry(), hooks=HookChain())
        mgr.load(["repro_torch.scopes.example_scope"])
        mgr.register_all()
        execute(mgr, mgr.registry, OrchestratorOptions(
            jobs=1, isolate="inline", shard_grain="benchmark",
            run=RunOptions(min_time=0.002, device="cpu"),
            results_dir=results, run_id=rid))
    paths = generate_run_report(os.path.join(results, "e2"))
    md = open(paths["md"]).read()
    assert "history: 2 recorded run(s)" in md
    assert "![example: trend across runs](example_trend.svg)" in md
    assert "![example: speedup vs previous run](example_speedup.svg)" in md
    out = os.path.join(results, "e2", "report")
    assert os.path.getsize(os.path.join(out, "example_trend.svg")) > 0
    trend = load_spec(os.path.join(out, "specs", "example_trend.yaml"))
    history_file = os.path.join(
        out, "specs", trend["series"][0]["input_file"])
    records = hist.load_history(history_file)
    assert hist.run_ids(records) == ["e1", "e2"]
    # one line a benchmark of the example scope, two points each
    trend_svg = ET.parse(os.path.join(out, "example_trend.svg")).getroot()
    lines = [e for e in trend_svg.iter() if e.get("class") == "mark line"]
    assert len(lines) == len(hist.benchmark_names(records))


# -- latency counters -----------------------------------------------------------

def test_report_without_latency_counters_omits_latency_columns(tmp_path):
    run_dir = fixture_run_dir(tmp_path)
    md = open(generate_run_report(str(run_dir))["md"]).read()
    assert "p99 latency" not in md and "goodput" not in md
    assert "latency" not in "".join(
        os.listdir(os.path.join(str(run_dir), "report", "specs")))


def test_report_with_latency_counters_adds_columns_and_cdf(tmp_path):
    from repro.scopeplot.report import generate_run_report as ref_report
    run_dir = latency_run_dir(tmp_path)
    paths = generate_run_report(str(run_dir))
    md = open(paths["md"]).read()
    assert "| p99 latency | goodput |" in md
    assert "31.5 req/s" in md
    assert "serve_latency.svg" in md
    out = run_dir / "report"
    assert (out / "serve_latency.svg").exists()
    assert (out / "specs" / "serve_latency.yaml").exists()
    # one CDF line per record with the counters
    assert len([e for e in ET.parse(str(out / "serve_latency.svg"))
                .getroot().iter() if e.get("class") == "mark line"]) == 2
    for result in render_spec_dir(str(out / "specs"), force=True):
        assert result[2] == "rendered", result
    # outside System, the reference's report of the same run, .png → .svg
    ref_dir = tmp_path / "ref_copy"
    shutil.copytree(run_dir.parent, ref_dir)
    ref_md = open(ref_report(str(ref_dir / "r2"))["md"]).read()
    got, want = sections(md), sections(ref_md.replace(".png", ".svg"))
    assert [t for t in got if t != "System"] == \
        [t for t in want if t != "System"]
    for title in want:
        if title != "System":
            assert got[title] == want[title], title


# ---------------------------------------------------------------------------
# the tune report
# ---------------------------------------------------------------------------

def test_tune_report_over_a_port_tune_run(scopes, capsys):  # noqa: F811
    """``tune`` without --no-report renders its report and prints its
    path; the report equals the reference's report of the same
    ``tune.json`` (``.svg`` for ``.png``)."""
    args = ["tprobe/mm", "--budget", "3", "--seed", "0", "--device", "cpu",
            "--results-dir", str(scopes / "results"), "--run-id", "t1",
            "--benchmark_min_time", "0.001"]
    assert port_tune(args) == 0
    out = capsys.readouterr().out
    run_dir = scopes / "results" / "t1"
    report = run_dir / "report"
    assert f"  report:   {report / 'index.html'}" in out
    md = (report / "report.md").read_text()
    assert "## Search" in md and "## Trials" in md
    assert "![matmul: per-config speedup vs the builtin default]" \
        "(tune_speedup.svg)" in md
    marks = svg_marks(str(report / "tune_speedup.svg"))
    trials = json.loads((run_dir / "tune.json").read_text())["search"][
        "trials"]
    assert len([m for m in marks if m.get("class") == "mark bar"]) == \
        len([t for t in trials if not t.get("error")]) + 1
    # regenerating is byte-identical, and equals the reference's
    assert generate_tune_report(str(run_dir))["md"] == str(report /
                                                           "report.md")
    assert (report / "report.md").read_text() == md
    ref_dir = scopes / "ref_t1"
    shutil.copytree(run_dir, ref_dir, ignore=shutil.ignore_patterns(
        "report"))
    ref_md = open(ref_tune_report(str(ref_dir))["md"]).read()
    assert md == ref_md.replace(".png", ".svg")
    # --no-report renders nothing
    args[args.index("t1")] = "t2"
    assert port_tune([*args, "--no-report"]) == 0
    assert "report:" not in capsys.readouterr().out
    assert not (scopes / "results" / "t2" / "report").exists()
    # a tune run's directory routes report_main to the tune report
    assert report_main([str(run_dir)]) == 0
    assert capsys.readouterr().out.splitlines()[0].endswith("index.html")


# ---------------------------------------------------------------------------
# without matplotlib or PyYAML
# ---------------------------------------------------------------------------

def test_report_and_batch_without_matplotlib_or_yaml(tmp_path):
    run_dir = latency_run_dir(tmp_path)
    results = run_dir.parent
    r = run_blocked("repro_torch", "report", "r2", "--results-dir",
                    str(results))
    assert r.returncode == 0, r.stderr
    md = (run_dir / "report" / "report.md").read_text()
    for image in ("serve_times.svg", "serve_latency.svg", "serve_trend.svg",
                  "serve_speedup.svg"):
        assert f"({image})" in md
        assert svg_marks(str(run_dir / "report" / image))
    r = run_blocked("repro_torch", "report", "history", "--results-dir",
                    str(results))
    assert r.returncode == 0, r.stderr
    r = run_blocked("repro_torch.scopeplot", "batch",
                    str(run_dir / "report" / "specs"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.count(": fresh -> ") == 4
