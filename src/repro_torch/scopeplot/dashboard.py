"""Live dashboard over the result store (``python -m repro_torch report
--serve``), a copy of ``repro.scopeplot.dashboard`` over the port's
history, store and fingerprints.

A stdlib :mod:`http.server` — no framework, no matplotlib, no network
dependencies — that serves

  * ``/`` — a server-rendered HTML dashboard: run table, per-instance
    trend **sparklines** (inline SVG over each instance's run-mean
    series), and a drift-alert panel driven by the same windowed
    detector the CLI gate uses
    (:func:`repro_torch.core.history.detect_drift`);
  * ``/api/*`` — JSON endpoints backed by the store
    (``/api/runs``, ``/api/benchmarks``, ``/api/trend?name=``,
    ``/api/drift?window=``, ``/api/query?...``, ``/api/status``);
  * ``/report/...`` — the static report directory ``repro_torch
    report`` just generated, if any.

History is re-read per request via :func:`repro_torch.core.history.
load_history`, which takes the SQLite index fast path when
``history.db`` exists and falls back to scanning the JSONL — the
dashboard always shows the file's current truth, including runs
appended or ingested after the server started.

Tests drive :func:`create_server` directly (``port=0`` picks a free
port); operators get a serving loop from ``repro_torch report --serve``.
The coverage panel counts the instances a run on ``device`` registers
(``report --serve --device``, default ``cuda``), as ``store status
--coverage --device`` does.
"""
from __future__ import annotations

import html
import json
import mimetypes
import os
import posixpath
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional
from urllib.parse import parse_qs, urlparse

from repro_torch.core import history as hist
from repro_torch.core.benchmark import parse_param_filter
from repro_torch.core.logging import get_logger
from repro_torch.store.index import store_status
from repro_torch.store.query import (QueryFilter, aggregate_records,
                                     match_record, parse_percentiles)

log = get_logger("dashboard")

_SPARK_W, _SPARK_H = 140, 30

_VERDICT_COLOR = {
    "regression": "#c0392b",
    "improvement": "#27ae60",
    "similar": "#7f8c8d",
    "new": "#2980b9",
}

_PAGE_CSS = """\
body{font-family:system-ui,sans-serif;margin:1.5rem;color:#222}
h1{font-size:1.3rem}h2{font-size:1.05rem;margin-top:1.6rem}
table{border-collapse:collapse;font-size:.85rem}
th,td{border:1px solid #ddd;padding:.25rem .55rem;text-align:left}
th{background:#f5f5f5}
td.num{text-align:right;font-variant-numeric:tabular-nums}
.verdict-regression{color:#c0392b;font-weight:600}
.verdict-improvement{color:#27ae60}
.ok{color:#27ae60}.warn{color:#c0392b;font-weight:600}
code{background:#f5f5f5;padding:0 .2rem}
.footer{margin-top:2rem;font-size:.75rem;color:#888}
"""


def sparkline_svg(values: List[float], color: str = "#2980b9") -> str:
    """Inline SVG sparkline over a run-mean series (empty-safe)."""
    pts = [v for v in values if isinstance(v, (int, float))]
    if len(pts) < 2:
        return ""
    lo, hi = min(pts), max(pts)
    span = (hi - lo) or 1.0
    n = len(pts)
    coords = []
    for i, v in enumerate(pts):
        x = 2 + i * (_SPARK_W - 4) / (n - 1)
        y = _SPARK_H - 3 - (v - lo) / span * (_SPARK_H - 6)
        coords.append(f"{x:.1f},{y:.1f}")
    last_x, last_y = coords[-1].split(",")
    return (f'<svg width="{_SPARK_W}" height="{_SPARK_H}" '
            f'role="img" aria-label="trend">'
            f'<polyline points="{" ".join(coords)}" fill="none" '
            f'stroke="{color}" stroke-width="1.5"/>'
            f'<circle cx="{last_x}" cy="{last_y}" r="2.5" '
            f'fill="{color}"/></svg>')


def _fmt_s(v: Optional[float]) -> str:
    if not isinstance(v, (int, float)):
        return "-"
    if v >= 1.0:
        return f"{v:.3f} s"
    if v >= 1e-3:
        return f"{v * 1e3:.3f} ms"
    return f"{v * 1e6:.1f} µs"


class Dashboard:
    """Query/render logic, independent of the HTTP plumbing."""

    def __init__(self, results_dir: str,
                 report_dir: Optional[str] = None,
                 history_file: Optional[str] = None,
                 window: int = hist.DEFAULT_WINDOW,
                 device: str = "cuda"):
        self.results_dir = os.path.abspath(results_dir)
        self.history_file = os.path.abspath(
            history_file or hist.history_path(self.results_dir))
        self.report_dir = os.path.abspath(report_dir) if report_dir \
            else None
        self.window = window
        self.device = device
        self._coverage: Optional[Dict[str, Any]] = None

    # -- data ------------------------------------------------------------

    def records(self) -> List[Dict[str, Any]]:
        if not os.path.exists(self.history_file):
            return []
        return hist.load_history(self.history_file)

    def runs(self, records: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
        out: List[Dict[str, Any]] = []
        for rid in hist.run_ids(records):
            rr = hist.for_run(records, rid)
            out.append({
                "run_id": rid,
                "ts": rr[0].get("ts", "") if rr else "",
                "sysinfo": rr[0].get("sysinfo", "") if rr else "",
                "tag": rr[0].get("tag") or "",
                "records": len(rr),
                "regressions": sum(1 for r in rr
                                   if r.get("verdict") == "regression"),
            })
        return out

    def trend(self, records: List[Dict[str, Any]],
              name: str) -> Dict[str, Any]:
        points = [{"run_id": r.get("run_id", ""), "ts": r.get("ts", ""),
                   "mean_s": r.get("mean_s"),
                   "stddev_s": r.get("stddev_s"),
                   "verdict": r.get("verdict", "")}
                  for r in hist.series(records, name)]
        return {"name": name, "points": points}

    def drift(self, records: List[Dict[str, Any]],
              window: Optional[int] = None) -> Dict[str, Any]:
        window = window or self.window
        ids = hist.run_ids(records)
        comps = hist.detect_drift(records, window=window) \
            if len(ids) >= 2 else []
        return {
            "window": window,
            "latest": ids[-1] if ids else None,
            "runs": len(ids),
            "comparisons": [{"name": c.name, "base_time": c.base_time,
                             "new_time": c.new_time, "ratio": c.ratio,
                             "verdict": c.verdict} for c in comps],
        }

    def coverage(self) -> Dict[str, Any]:
        """Fingerprint freshness per scope (fresh/stale/never-run) of
        the instances a run on ``self.device`` registers.

        Enumerating the registry imports every scope module (and with
        them torch + the kernel wrappers), so the result is computed
        once per server lifetime and cached; ``?refresh=1`` invalidates.
        Failures degrade to ``{"error": ...}`` — the dashboard must
        keep serving trends on a box that can't import the kernels, or
        has no card for ``device`` ``cuda``.
        """
        if self._coverage is None:
            try:
                from repro_torch.core.fingerprint import (coverage,
                                                          registered_benches)
                from repro_torch.core.sysinfo import build_context, \
                    context_digest
                benches = registered_benches(device=self.device)
                self._coverage = coverage(
                    benches, self.records(),
                    sysinfo=context_digest(build_context(
                        device=self.device)),
                    device=self.device)
            except Exception as e:  # noqa: BLE001 - degrade, don't 500
                log.warning("coverage unavailable: %s", e)
                self._coverage = {"error": str(e)}
        return self._coverage

    def query(self, qs: Dict[str, List[str]]) -> Dict[str, Any]:
        def one(key: str) -> Optional[str]:
            return qs[key][0] if qs.get(key) else None
        flt = QueryFilter(
            scope=one("scope"), family=one("family"), name=one("name"),
            params=parse_param_filter(qs.get("param", [])) or None,
            sysinfo=one("sysinfo"), tag=one("tag"),
            run_id=one("run_id"), since=one("since"), until=one("until"))
        rows = [("", r) for r in self.records() if match_record(r, flt)]
        if one("aggregate") in ("1", "true", "yes"):
            quantiles = parse_percentiles(
                one("percentiles") or "p50,p90,p99")
            return {"filter": flt.describe(),
                    "records": len(rows),
                    "instances": [a.to_json() for a in
                                  aggregate_records(rows, quantiles)]}
        return {"filter": flt.describe(), "records": len(rows),
                "matches": [r for _raw, r in rows]}

    # -- HTML ------------------------------------------------------------

    def index_html(self) -> str:
        records = self.records()
        runs = self.runs(records)
        drift = self.drift(records)
        flagged = [c for c in drift["comparisons"]
                   if c["verdict"] in ("regression", "improvement")]
        e = html.escape
        out = [f"<!doctype html><html><head><meta charset='utf-8'>"
               f"<title>SCOPE dashboard</title>"
               f"<style>{_PAGE_CSS}</style></head><body>",
               f"<h1>SCOPE result store — "
               f"<code>{e(self.history_file)}</code></h1>"]

        out.append(f"<h2>Drift watch (window={drift['window']})</h2>")
        if drift["runs"] < 2:
            out.append("<p>Needs at least two recorded runs.</p>")
        elif not flagged:
            out.append(f"<p class='ok'>No windowed drift: latest run "
                       f"<code>{e(drift['latest'] or '')}</code> is "
                       f"within noise of the pooled window.</p>")
        else:
            out.append(f"<p class='warn'>{len(flagged)} instance(s) "
                       f"drifted in <code>{e(drift['latest'] or '')}"
                       f"</code>:</p><table><tr><th>benchmark</th>"
                       f"<th>window mean</th><th>latest</th><th>ratio"
                       f"</th><th>verdict</th></tr>")
            for c in flagged:
                ratio = f"{c['ratio']:.2f}x" if c["ratio"] else "-"
                out.append(
                    f"<tr><td><code>{e(c['name'])}</code></td>"
                    f"<td class='num'>{_fmt_s(c['base_time'])}</td>"
                    f"<td class='num'>{_fmt_s(c['new_time'])}</td>"
                    f"<td class='num'>{ratio}</td>"
                    f"<td class='verdict-{e(c['verdict'])}'>"
                    f"{e(c['verdict'])}</td></tr>")
            out.append("</table>")

        cov = self._coverage      # panel only if already computed
        if cov is not None and "scopes" in cov:
            t = cov.get("totals", {})
            out.append(f"<h2>Staleness (machine <code>"
                       f"{e((cov.get('sysinfo') or '')[:12])}</code>)"
                       f"</h2>")
            out.append("<table><tr><th>scope</th><th>fresh</th>"
                       "<th>stale</th><th>never run</th></tr>")
            for scope in sorted(cov["scopes"]):
                row = cov["scopes"][scope]
                warn = " class='warn'" if (row.get("stale") or
                                           row.get("never")) else ""
                out.append(
                    f"<tr><td><code>{e(scope)}</code></td>"
                    f"<td class='num'>{row.get('fresh', 0)}</td>"
                    f"<td class='num'{warn}>{row.get('stale', 0)}</td>"
                    f"<td class='num'{warn}>{row.get('never', 0)}</td>"
                    f"</tr>")
            out.append(f"</table><p>{t.get('fresh', 0)} of "
                       f"{cov.get('instances', 0)} instance(s) are "
                       f"fingerprint-fresh; a delta run "
                       f"(<code>repro_torch ci</code>) would re-measure "
                       f"{t.get('stale', 0) + t.get('never', 0)}.</p>")

        out.append("<h2>Runs</h2>")
        if runs:
            out.append("<table><tr><th>run</th><th>timestamp</th>"
                       "<th>machine</th><th>tag</th><th>records</th>"
                       "<th>regressions</th></tr>")
            for r in reversed(runs):        # latest first
                cls = " class='warn'" if r["regressions"] else ""
                out.append(
                    f"<tr><td><code>{e(r['run_id'])}</code></td>"
                    f"<td>{e(r['ts'])}</td>"
                    f"<td><code>{e(r['sysinfo'][:12])}</code></td>"
                    f"<td>{e(r['tag'])}</td>"
                    f"<td class='num'>{r['records']}</td>"
                    f"<td class='num'{cls}>{r['regressions']}</td></tr>")
            out.append("</table>")
        else:
            out.append("<p>No runs recorded yet.</p>")

        out.append("<h2>Instance trends</h2>")
        names = hist.benchmark_names(records)
        if names:
            out.append("<table><tr><th>instance</th><th>trend</th>"
                       "<th>latest</th><th>runs</th><th>verdict</th>"
                       "</tr>")
            for name in names:
                series = hist.series(records, name)
                means = [r.get("mean_s") for r in series
                         if isinstance(r.get("mean_s"), (int, float))]
                last = series[-1] if series else {}
                verdict = last.get("verdict", "") or ""
                color = _VERDICT_COLOR.get(verdict, "#2980b9")
                out.append(
                    f"<tr><td><code>{e(name)}</code></td>"
                    f"<td>{sparkline_svg(means, color)}</td>"
                    f"<td class='num'>{_fmt_s(last.get('mean_s'))}</td>"
                    f"<td class='num'>{len(series)}</td>"
                    f"<td class='verdict-{e(verdict)}'>{e(verdict)}"
                    f"</td></tr>")
            out.append("</table>")
        else:
            out.append("<p>No instances recorded yet.</p>")

        links = ["<a href='/api/runs'>/api/runs</a>",
                 "<a href='/api/drift'>/api/drift</a>",
                 "<a href='/api/status'>/api/status</a>",
                 "<a href='/api/coverage'>/api/coverage</a>",
                 "<a href='/api/query?aggregate=1'>/api/query</a>"]
        if self.report_dir and os.path.isdir(self.report_dir):
            links.insert(0, "<a href='/report/index.html'>static "
                            "report</a>")
        out.append(f"<p class='footer'>{' · '.join(links)} — backed by "
                   f"the result store (docs/result-store.md)</p>")
        out.append("</body></html>")
        return "".join(out)


class DashboardHandler(BaseHTTPRequestHandler):
    """Routes requests to a :class:`Dashboard` (set on the server)."""

    server_version = "scope-dashboard"

    @property
    def dash(self) -> Dashboard:
        return self.server.dashboard        # type: ignore[attr-defined]

    def log_message(self, fmt: str, *args: Any) -> None:
        log.debug("%s %s", self.address_string(), fmt % args)

    def _send(self, code: int, body: bytes, ctype: str) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _json(self, payload: Any, code: int = 200) -> None:
        body = json.dumps(payload, indent=2, sort_keys=True).encode()
        self._send(code, body, "application/json; charset=utf-8")

    def _static(self, rel: str) -> None:
        root = self.dash.report_dir
        if not root or not os.path.isdir(root):
            self._json({"error": "no static report directory"}, 404)
            return
        # normalize inside the report root; reject anything that escapes
        clean = posixpath.normpath(rel).lstrip("/")
        path = os.path.realpath(os.path.join(root, clean))
        if not (path == root or path.startswith(root + os.sep)) \
                or not os.path.isfile(path):
            self._json({"error": f"no such report file: {rel}"}, 404)
            return
        ctype = mimetypes.guess_type(path)[0] or \
            "application/octet-stream"
        with open(path, "rb") as f:
            self._send(200, f.read(), ctype)

    def do_GET(self) -> None:        # noqa: N802 (http.server API)
        url = urlparse(self.path)
        qs = parse_qs(url.query)
        try:
            if url.path in ("/", "/index.html"):
                self._send(200, self.dash.index_html().encode(),
                           "text/html; charset=utf-8")
            elif url.path == "/api/runs":
                self._json(self.dash.runs(self.dash.records()))
            elif url.path == "/api/benchmarks":
                self._json(hist.benchmark_names(self.dash.records()))
            elif url.path == "/api/trend":
                name = (qs.get("name") or [""])[0]
                if not name:
                    self._json({"error": "trend needs ?name="}, 400)
                    return
                self._json(self.dash.trend(self.dash.records(), name))
            elif url.path == "/api/drift":
                window = None
                if qs.get("window"):
                    window = max(1, int(qs["window"][0]))
                self._json(self.dash.drift(self.dash.records(), window))
            elif url.path == "/api/query":
                self._json(self.dash.query(qs))
            elif url.path == "/api/coverage":
                if (qs.get("refresh") or [""])[0] in ("1", "true"):
                    self.dash._coverage = None
                self._json(self.dash.coverage())
            elif url.path == "/api/status":
                self._json(store_status(self.dash.history_file))
            elif url.path.startswith("/report/"):
                self._static(url.path[len("/report/"):])
            else:
                self._json({"error": f"no such endpoint: {url.path}"},
                           404)
        except (ValueError, OSError) as e:
            self._json({"error": str(e)}, 400)


def create_server(results_dir: str, report_dir: Optional[str] = None,
                  host: str = "127.0.0.1", port: int = 0,
                  history_file: Optional[str] = None,
                  window: int = hist.DEFAULT_WINDOW,
                  device: str = "cuda") -> ThreadingHTTPServer:
    """A ready-to-serve dashboard server (``port=0`` → ephemeral port).

    Callers own the serving loop: tests run it on a thread and shut it
    down; ``repro_torch report --serve`` calls ``serve_forever()``.
    """
    server = ThreadingHTTPServer((host, port), DashboardHandler)
    server.dashboard = Dashboard(                 # type: ignore[attr-defined]
        results_dir, report_dir=report_dir, history_file=history_file,
        window=window, device=device)
    return server


def serve_dashboard(results_dir: str, report_dir: Optional[str] = None,
                    host: str = "127.0.0.1", port: int = 8000,
                    window: int = hist.DEFAULT_WINDOW,
                    device: str = "cuda") -> int:
    """Blocking serve loop for ``python -m repro_torch report --serve``."""
    try:
        server = create_server(results_dir, report_dir=report_dir,
                               host=host, port=port, window=window,
                               device=device)
    except OSError as e:
        log.error("cannot bind %s:%d: %s", host, port, e)
        return 1
    bound = server.server_address
    print(f"dashboard: http://{bound[0]}:{bound[1]}/  (Ctrl-C stops)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0
