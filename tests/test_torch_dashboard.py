"""The port's live dashboard (``python -m repro_torch report --serve``,
``repro_torch.scopeplot.dashboard``): the reference's dashboard cases
(``tests/test_dashboard.py``) through the port over its history and
store — the HTML index with sparklines and the drift panel, the JSON
endpoints, static report files with traversal protection — plus the
reference's sparklines and pages on the same store, and coverage
counted for ``--device``.  Everything runs against 127.0.0.1 on an
ephemeral port; no network beyond loopback."""
import json
import os
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import pytest

from repro.scopeplot import dashboard as ref_dashboard
from repro_torch.core import history as hist
from repro_torch.scopeplot.dashboard import (Dashboard, create_server,
                                             sparkline_svg)
from test_history import make_doc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def results(tmp_path):
    """Two runs: the second drifts s/b by +50% (a drift-panel hit)."""
    d = str(tmp_path / "results")
    hist.append_run(d, make_doc("r1", {"s/a": 1.0, "s/b": 2.0},
                                date="2026-08-01T10:00:00"))
    hist.append_run(d, make_doc("r2", {"s/a": 1.01, "s/b": 3.0},
                                date="2026-08-02T10:00:00"))
    return d


@pytest.fixture
def server(results, tmp_path):
    report_dir = tmp_path / "report"
    report_dir.mkdir()
    (report_dir / "index.html").write_text("<html>static report</html>")
    srv = create_server(results, report_dir=str(report_dir), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    thread.join(timeout=5)


def get(server, path, expect_json=True):
    host, port = server.server_address
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=10) as resp:
        body = resp.read()
        return json.loads(body) if expect_json else body.decode()


def get_code(server, path):
    host, port = server.server_address
    try:
        with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                    timeout=10) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


# ---------------------------------------------------------------------------
# HTML index
# ---------------------------------------------------------------------------

def test_index_page_renders_runs_trends_and_drift(server):
    page = get(server, "/", expect_json=False)
    assert "SCOPE result store" in page
    assert "r1" in page and "r2" in page
    assert "s/a" in page and "s/b" in page
    assert "<svg" in page                      # sparklines inline
    assert "Drift watch" in page
    assert "regression" in page                # s/b drifted +50%
    assert "/report/index.html" in page        # static report linked


def test_sparkline_svg():
    svg = sparkline_svg([1.0, 2.0, 1.5])
    assert svg.startswith("<svg") and "polyline" in svg
    assert sparkline_svg([]) == ""             # empty-safe
    assert sparkline_svg([1.0]) == ""          # one point: no trend yet
    assert sparkline_svg([3.0, 3.0]) != ""     # flat series still draws


# ---------------------------------------------------------------------------
# JSON API
# ---------------------------------------------------------------------------

def test_api_runs(server):
    runs = get(server, "/api/runs")
    assert [r["run_id"] for r in runs] == ["r1", "r2"]
    assert all(r["records"] == 2 for r in runs)
    assert runs[1]["regressions"] == 1         # s/b in r2


def test_api_benchmarks_and_trend(server):
    assert get(server, "/api/benchmarks") == ["s/a", "s/b"]
    trend = get(server, "/api/trend?name=s/b")
    assert trend["name"] == "s/b"
    assert [p["mean_s"] for p in trend["points"]] == [2.0, 3.0]
    assert trend["points"][1]["verdict"] == "regression"
    assert get_code(server, "/api/trend") == 400   # name is required


def test_api_drift_matches_cli_detector(server, results):
    drift = get(server, "/api/drift")
    assert drift["latest"] == "r2" and drift["runs"] == 2
    records = hist.load_history(hist.history_path(results))
    expected = [(c.name, c.verdict) for c in hist.detect_drift(records)]
    assert [(c["name"], c["verdict"])
            for c in drift["comparisons"]] == expected
    assert {c["name"]: c["verdict"] for c in drift["comparisons"]} == \
        {"s/a": "similar", "s/b": "regression"}
    assert get(server, "/api/drift?window=3")["window"] == 3


def test_api_query_filters_and_aggregates(server):
    out = get(server, "/api/query?name=s/a")
    assert out["records"] == 2
    assert all(m["name"] == "s/a" for m in out["matches"])
    agg = get(server, "/api/query?name=s/b&aggregate=1")
    assert agg["records"] == 2
    inst = agg["instances"][0]
    assert inst["runs"] == 2
    assert inst["mean_s"]["mean"] == pytest.approx(2.5)
    assert "p50" in inst["mean_s"]
    assert get_code(server, "/api/query?param=oops") == 400


def test_api_status_reports_store_freshness(server, results):
    status = get(server, "/api/status")
    assert status["history"] == hist.history_path(results)
    assert status["exists"] is False           # no index built yet
    from repro_torch.store.index import refresh
    refresh(hist.history_path(results))
    status = get(server, "/api/status")
    assert status["exists"] is True and status["fresh"] is True
    assert status["records"] == 4


def test_api_sees_appends_without_restart(server, results):
    hist.append_run(results, make_doc("r3", {"s/a": 1.0, "s/b": 3.1},
                                      date="2026-08-03T10:00:00"))
    runs = get(server, "/api/runs")
    assert [r["run_id"] for r in runs] == ["r1", "r2", "r3"]
    assert get(server, "/api/drift")["latest"] == "r3"


# ---------------------------------------------------------------------------
# static files + routing
# ---------------------------------------------------------------------------

def test_static_report_served(server):
    page = get(server, "/report/index.html", expect_json=False)
    assert page == "<html>static report</html>"


def test_static_traversal_rejected(server):
    assert get_code(server, "/report/../secrets.txt") == 404
    assert get_code(server, "/report/%2e%2e/secrets.txt") == 404
    assert get_code(server, "/report/nope.html") == 404


def test_unknown_endpoint_is_json_404(server):
    host, port = server.server_address
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"http://{host}:{port}/api/nope",
                               timeout=10)
    assert e.value.code == 404
    assert json.loads(e.value.read())["error"].startswith(
        "no such endpoint")


def test_empty_results_dir_serves_empty_state(tmp_path):
    srv = create_server(str(tmp_path / "nothing"), port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        page = get(srv, "/", expect_json=False)
        assert "No runs recorded yet" in page
        assert get(srv, "/api/runs") == []
        drift = get(srv, "/api/drift")
        assert drift["runs"] == 0 and drift["comparisons"] == []
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)


def test_dashboard_logic_without_http(results):
    """The Dashboard class is usable directly (what --serve wraps)."""
    dash = Dashboard(results)
    records = dash.records()
    assert len(records) == 4
    runs = dash.runs(records)
    assert [r["run_id"] for r in runs] == ["r1", "r2"]
    html = dash.index_html()
    assert "Instance trends" in html and "<svg" in html


def test_api_coverage_lazy_cached_and_refreshable(server):
    """Coverage is computed once (registry enumeration is heavy), cached
    across requests, and ?refresh=1 invalidates.  The registry walk is
    stubbed — HTTP plumbing is under test here, not the scopes."""
    dash = server.dashboard
    calls = []

    def fake_coverage():
        if dash._coverage is None:
            calls.append(1)
            dash._coverage = {
                "sysinfo": "m1",
                "scopes": {"s": {"fresh": 1, "stale": 1, "never": 0}},
                "totals": {"fresh": 1, "stale": 1, "never": 0},
                "instances": 2, "pending": ["s/b"]}
        return dash._coverage

    dash.coverage = fake_coverage
    first = get(server, "/api/coverage")
    assert first["totals"] == {"fresh": 1, "stale": 1, "never": 0}
    assert get(server, "/api/coverage") == first
    assert len(calls) == 1                        # cached
    get(server, "/api/coverage?refresh=1")
    assert len(calls) == 2                        # invalidated

    # once computed, the index page renders the staleness panel
    html = get(server, "/", expect_json=False)
    assert "Staleness" in html and "/api/coverage" in html


def test_api_coverage_degrades_to_error(server, monkeypatch):
    """A box that can't enumerate the registry still serves trends; the
    coverage endpoint degrades to an error payload, not a 500."""
    import repro_torch.core.fingerprint as fing

    def boom(*a, **k):
        raise RuntimeError("no torch here")
    monkeypatch.setattr(fing, "registered_benches", boom)
    payload = get(server, "/api/coverage")
    assert "error" in payload and "no torch here" in payload["error"]
    assert get_code(server, "/") == 200           # index still serves


# ---------------------------------------------------------------------------
# against the reference's dashboard, and coverage by --device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("values", [[1.0, 2.0, 1.5], [], [1.0], [3.0, 3.0],
                                    [0.1, 0.5, None, 0.2, 7]])
def test_sparkline_equals_the_reference(values):
    assert sparkline_svg(values) == ref_dashboard.sparkline_svg(values)
    assert sparkline_svg(values, "#c0392b") == \
        ref_dashboard.sparkline_svg(values, "#c0392b")


def test_pages_and_api_equal_the_reference(results):
    """On one store the port's index page (but the store path it names)
    and its JSON answers are the reference's."""
    port, ref = Dashboard(results), ref_dashboard.Dashboard(results)
    records, ref_records = port.records(), ref.records()
    assert records == ref_records
    assert port.runs(records) == ref.runs(ref_records)
    assert port.drift(records) == ref.drift(ref_records)
    assert port.trend(records, "s/b") == ref.trend(ref_records, "s/b")
    qs = {"name": ["s/b"], "aggregate": ["1"]}
    assert port.query(qs) == ref.query(qs)
    page = port.index_html().replace("repro_torch ci", "repro ci")
    assert page == ref.index_html()


def test_coverage_counts_the_instances_of_its_device(tmp_path):
    """``--device cpu``: the instances a CPU run registers, the example
    scope's fresh after a CPU run of it; the default ``cuda`` on a host
    without a card degrades to an error payload."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    results = str(tmp_path / "results")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--device", "cpu",
         "--enable-scope", "example", "--benchmark_min_time", "0.002",
         "--results-dir", results, "--run-id", "a", "--benchmark_out",
         os.devnull], capture_output=True, text=True, env=env, cwd=ROOT,
        timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    code = ("import json, sys, torch\n"
            "from repro_torch.scopeplot.dashboard import Dashboard\n"
            "torch.cuda.is_available = lambda: False\n"
            "out = {d: Dashboard(sys.argv[1], device=d).coverage()\n"
            "       for d in ('cpu', 'cuda')}\n"
            "print(json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code, results],
                       capture_output=True, text=True, env=env, cwd=ROOT,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    cov = json.loads(r.stdout.splitlines()[-1])
    assert cov["cpu"]["scopes"]["example"] == {"fresh": 8, "stale": 0,
                                               "never": 0}
    assert cov["cpu"]["instances"] > 8
    assert "error" in cov["cuda"]


def test_report_serve_takes_device():
    from repro_torch.scopeplot.report import build_report_parser
    ap = build_report_parser()
    assert ap.parse_args(["history", "--serve"]).device == "cuda"
    assert ap.parse_args(["history", "--serve", "--device",
                          "cpu"]).device == "cpu"
    with pytest.raises(SystemExit):
        ap.parse_args(["history", "--device", "tpu"])
    srv = create_server(".", port=0, device="cpu")
    try:
        assert srv.dashboard.device == "cpu"
    finally:
        srv.server_close()
