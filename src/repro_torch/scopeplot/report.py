"""Auto-generated run reports — ``python -m repro_torch report``
(ScopePlot's "publication-quality plots" promise, turned into a
zero-config artifact); the port of ``repro.scopeplot.report``.

No hand-written YAML needed: given a run directory (and the run-history
store ``results/history.jsonl`` the orchestrator maintains), this module
*generates* a spec per scope, renders it through the normal spec
pipeline (:mod:`repro_torch.scopeplot.plot`), and emits a static
``report/index.html`` + ``report/report.md`` with per-scope sections,
embedded plots, sysinfo, and the verdict table:

  * ``<scope>_times.svg``   — grouped-bar of per-instance mean times;
  * ``<scope>_latency.svg`` — tail-latency CDF (scopes whose records
    carry the latency meter's counters);
  * ``<scope>_trend.svg``   — cross-run time series from history.jsonl
    (appears once the store has any record for the scope; a second run
    adds its point automatically);
  * ``<scope>_speedup.svg`` — speedup vs the previous recorded run
    (appears once history holds two runs).

The generated specs are saved under ``report/specs/`` — they are plain
ScopePlot specs, written with :func:`repro_torch.scopeplot.specyaml.dump`
(``yaml.safe_load`` reads them back to the same mapping), so
``python -m repro_torch.scopeplot batch report/specs`` re-renders them
(only the stale ones) after hand-tweaking.

The port writes SVG where the reference writes PNG, and its System
table lists the port's context keys (torch, CUDA, the driver, the
card's compute capability and SM count) where the reference lists
``jax_version`` and ``xla_flags``.

Everything in the report derives from the run artifacts (context date,
sysinfo digest, history records) — regenerating a report from the same
run directory is byte-identical, which is what makes the Markdown
output golden-testable.
"""
from __future__ import annotations

import argparse
import html
import json
import os
import re
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.core import history as hist
from repro_torch.core.baseline import _fmt_time, collect_stats
from repro_torch.core.cli_examples import epilog
from repro_torch.core.history import DEFAULT_WINDOW
from repro_torch.core.logging import get_logger

from . import specyaml
from .model import load
from .plot import load_spec, render_spec

log = get_logger("report")

#: The reference's System keys, with ``jax_version`` and ``xla_flags``
#: giving way at their places to the port's context keys
#: (``repro_torch.core.sysinfo``).
_SYSINFO_KEYS = (
    "date", "host_name", "machine", "model_name", "num_cpus",
    "torch_version", "cuda_version", "backend", "device_count",
    "device_kind", "target_hardware", "driver_version",
    "compute_capability", "sm_count", "scope_version",
)


# ---------------------------------------------------------------------------
# document assembly (shared by the Markdown and HTML writers)
# ---------------------------------------------------------------------------

class Section:
    """One report section: a heading plus tables/images/paragraphs."""

    def __init__(self, title: str):
        self.title = title
        self.parts: List[Tuple[str, Any]] = []

    def text(self, s: str) -> "Section":
        self.parts.append(("text", s))
        return self

    def table(self, headers: Sequence[str],
              rows: Sequence[Sequence[str]]) -> "Section":
        self.parts.append(("table", (list(headers),
                                     [list(r) for r in rows])))
        return self

    def image(self, caption: str, relpath: str) -> "Section":
        self.parts.append(("image", (caption, relpath)))
        return self


def _write_markdown(path: str, title: str, meta: List[Tuple[str, str]],
                    sections: List[Section]) -> None:
    lines = [f"# {title}", ""]
    for k, v in meta:
        lines.append(f"- {k}: {v}")
    lines.append("")
    for sec in sections:
        lines.append(f"## {sec.title}")
        lines.append("")
        for kind, payload in sec.parts:
            if kind == "text":
                lines.append(payload)
                lines.append("")
            elif kind == "table":
                headers, rows = payload
                lines.append("| " + " | ".join(headers) + " |")
                lines.append("|" + "|".join("---" for _ in headers) + "|")
                for row in rows:
                    lines.append("| " + " | ".join(row) + " |")
                lines.append("")
            elif kind == "image":
                caption, rel = payload
                lines.append(f"![{caption}]({rel})")
                lines.append("")
    with open(path, "w") as f:
        f.write("\n".join(lines).rstrip() + "\n")


_HTML_STYLE = """
body { font-family: -apple-system, 'Segoe UI', Helvetica, Arial,
       sans-serif; margin: 2em auto; max-width: 60em; padding: 0 1em;
       color: #1c1e21; }
h1 { border-bottom: 2px solid #d0d7de; padding-bottom: .3em; }
h2 { border-bottom: 1px solid #d0d7de; padding-bottom: .2em;
     margin-top: 2em; }
table { border-collapse: collapse; margin: 1em 0; font-size: .9em; }
th, td { border: 1px solid #d0d7de; padding: .35em .7em;
         text-align: left; }
th { background: #f6f8fa; }
td.regression { color: #b42318; font-weight: 600; }
td.improvement { color: #067647; font-weight: 600; }
img { max-width: 100%; border: 1px solid #d0d7de; margin: .5em 0; }
ul.meta { list-style: none; padding: 0; color: #57606a; }
"""

_VERDICT_CLASSES = ("regression", "improvement")


def _html_cell(value: str) -> str:
    cls = value.strip().lower()
    if cls in _VERDICT_CLASSES:
        return f'<td class="{cls}">{html.escape(value)}</td>'
    return f"<td>{html.escape(value)}</td>"


def _write_html(path: str, title: str, meta: List[Tuple[str, str]],
                sections: List[Section]) -> None:
    out = ["<!DOCTYPE html>", "<html><head>",
           '<meta charset="utf-8">',
           f"<title>{html.escape(title)}</title>",
           f"<style>{_HTML_STYLE}</style>",
           "</head><body>",
           f"<h1>{html.escape(title)}</h1>",
           '<ul class="meta">']
    for k, v in meta:
        out.append(f"<li><b>{html.escape(k)}</b>: {html.escape(v)}</li>")
    out.append("</ul>")
    for sec in sections:
        out.append(f"<h2>{html.escape(sec.title)}</h2>")
        for kind, payload in sec.parts:
            if kind == "text":
                out.append(f"<p>{html.escape(payload)}</p>")
            elif kind == "table":
                headers, rows = payload
                out.append("<table><tr>"
                           + "".join(f"<th>{html.escape(h)}</th>"
                                     for h in headers) + "</tr>")
                for row in rows:
                    out.append("<tr>" + "".join(_html_cell(c) for c in row)
                               + "</tr>")
                out.append("</table>")
            elif kind == "image":
                caption, rel = payload
                out.append(f'<figure><img src="{html.escape(rel)}" '
                           f'alt="{html.escape(caption)}">'
                           f"<figcaption>{html.escape(caption)}"
                           f"</figcaption></figure>")
    out.append("</body></html>")
    with open(path, "w") as f:
        f.write("\n".join(out) + "\n")


# ---------------------------------------------------------------------------
# spec generation
# ---------------------------------------------------------------------------

def _scope_regex(scope: str) -> str:
    return f"^{re.escape(scope)}/"


def _emit_spec(specs_dir: str, name: str, spec: Dict[str, Any]) -> str:
    """Write one auto-generated spec and render it through the normal
    pipeline (load_spec validates what we generated — the report must
    not bypass the public spec contract)."""
    path = os.path.join(specs_dir, f"{name}.yaml")
    with open(path, "w") as f:
        f.write(specyaml.dump(spec))
    return render_spec(load_spec(path), base_dir=specs_dir)


def _rel(target: str, start_dir: str) -> str:
    return os.path.relpath(os.path.abspath(target),
                           os.path.abspath(start_dir))


def _scope_plots(scope: str, specs_dir: str, out_dir: str,
                 merged_path: Optional[str], history_file: Optional[str],
                 prev_doc_path: Optional[str], run_label: str,
                 history_records: Optional[List[Dict[str, Any]]] = None,
                 prev_names: Optional[set] = None,
                 latency: bool = False
                 ) -> List[Tuple[str, str]]:
    """Generate+render this scope's plots; (caption, path rel to out).

    ``history_records`` is the already-loaded content of
    ``history_file`` and ``prev_names`` the benchmark names inside
    ``prev_doc_path`` — passed in so the per-scope loop doesn't reparse
    either file (the rendered specs still read the files themselves —
    generated specs must stay standalone).  ``latency`` adds the
    tail-latency CDF page for scopes whose records carry latency-meter
    percentile counters (``--meters latency``).
    """
    plots: List[Tuple[str, str]] = []
    rx = _scope_regex(scope)
    if merged_path:
        out = _emit_spec(specs_dir, f"{scope}_times", {
            "title": f"{scope} — mean time per instance",
            "type": "grouped_bar",
            "output": f"../{scope}_times.svg",
            "x_axis": {"label": "instance"},
            "y_axis": {"label": "mean time (us)"},
            "series": [{"label": run_label,
                        "input_file": _rel(merged_path, specs_dir),
                        "regex": rx, "xfield": "name",
                        "yfield": "real_time_s", "yscale": 1e6}],
        })
        plots.append((f"{scope}: mean time per instance",
                      _rel(out, out_dir)))
    if merged_path and latency:
        out = _emit_spec(specs_dir, f"{scope}_latency", {
            "title": f"{scope} — request latency CDF (per instance)",
            "type": "latency_cdf",
            "output": f"../{scope}_latency.svg",
            "x_axis": {"label": "end-to-end latency (ms)"},
            "y_axis": {"label": "fraction of requests"},
            "series": [{"label": run_label,
                        "input_file": _rel(merged_path, specs_dir),
                        "regex": rx, "xscale": 1e3}],
        })
        plots.append((f"{scope}: tail-latency CDF", _rel(out, out_dir)))
    if history_file and os.path.exists(history_file):
        records = history_records if history_records is not None \
            else hist.load_history(history_file)
        if any(r.get("name", "").startswith(scope + "/") for r in records):
            out = _emit_spec(specs_dir, f"{scope}_trend", {
                "title": f"{scope} — mean time per run",
                "type": "timeseries",
                "output": f"../{scope}_trend.svg",
                "x_axis": {"label": "run"},
                "y_axis": {"label": "mean time (s)"},
                "series": [{"label": scope,
                            "input_file": _rel(history_file, specs_dir),
                            "regex": rx}],
            })
            plots.append((f"{scope}: trend across runs",
                          _rel(out, out_dir)))
    if prev_doc_path and merged_path:
        if prev_names is None:
            with open(prev_doc_path) as f:
                prev_names = {b.get("run_name") or b.get("name", "")
                              for b in json.load(f).get("benchmarks", [])}
        if any(n.startswith(scope + "/") for n in prev_names):
            out = _emit_spec(specs_dir, f"{scope}_speedup", {
                "title": f"{scope} — speedup vs previous run",
                "type": "speedup",
                "output": f"../{scope}_speedup.svg",
                "x_axis": {"label": "speedup (previous / this run)"},
                "baseline": {"input_file": _rel(prev_doc_path, specs_dir),
                             "regex": rx},
                "series": [{"label": "this run",
                            "input_file": _rel(merged_path, specs_dir),
                            "regex": rx}],
            })
            plots.append((f"{scope}: speedup vs previous run",
                          _rel(out, out_dir)))
    return plots


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _fmt_mean(mean: Optional[float]) -> str:
    return _fmt_time(mean) if mean is not None else "-"


def _compile_times(doc: Dict[str, Any]) -> Dict[str, float]:
    """run_name → warm-phase ``compile_time_s`` (first record wins)."""
    out: Dict[str, float] = {}
    for rec in doc.get("benchmarks", []):
        ct = rec.get("compile_time_s")
        name = rec.get("run_name") or rec.get("name", "")
        if ct is not None and name not in out:
            out[name] = float(ct)
    return out


def _fmt_flops_rate(v: float) -> str:
    for scale, prefix in ((1e12, "T"), (1e9, "G"), (1e6, "M"), (1e3, "k")):
        if v >= scale:
            return f"{v / scale:.2f} {prefix}FLOP/s"
    return f"{v:.0f} FLOP/s"


def _roofline_cells(doc: Dict[str, Any]) -> Dict[str, str]:
    """run_name → formatted cost-model cell, for runs measured with the
    cost-model meter (``--meters costmodel``, docs/measurement.md).

    Empty when no record carries cost counters — the verdict table then
    keeps its historical column set, so reports from default runs stay
    byte-identical.
    """
    counters = hist.doc_counters(doc)
    out: Dict[str, str] = {}
    for name, c in counters.items():
        fps, ai = c.get("flops_per_second"), c.get("arithmetic_intensity")
        if fps:
            cell = _fmt_flops_rate(fps)
            if ai:
                cell += f" @ {ai:.2f} F/B"
            out[name] = cell
        elif ai:
            out[name] = f"{ai:.2f} F/B"
    return out


def _latency_cells(doc: Dict[str, Any]) -> Dict[str, Tuple[str, str]]:
    """run_name → (p99 latency, goodput) cells, for runs measured with
    the latency meter (``--meters latency``, docs/serving.md).

    Empty when no record carries tail-percentile counters — like the
    roofline column, the verdict table only grows these columns when
    the data exists, so reports from default runs stay byte-identical.
    """
    counters = hist.doc_counters(doc)
    out: Dict[str, Tuple[str, str]] = {}
    for name, c in counters.items():
        p99 = c.get("latency_p99_s")
        good = c.get("goodput_rps")
        if p99 is None and good is None:
            continue
        out[name] = (_fmt_time(p99) if p99 is not None else "-",
                     f"{good:.1f} req/s" if good is not None else "-")
    return out


def _verdict_rows(doc: Dict[str, Any],
                  run_records: List[Dict[str, Any]],
                  roofline: Optional[Dict[str, str]] = None,
                  latency: Optional[Dict[str, Tuple[str, str]]] = None
                  ) -> List[List[str]]:
    """benchmark | mean | stddev | n | compile | [roofline] | [p99 |
    goodput] | vs previous | ratio — the roofline and latency columns
    appear only when their metrics are present (pass the non-empty
    ``_roofline_cells`` / ``_latency_cells`` results)."""
    by_name = {r["name"]: r for r in run_records}
    compile_by_name = _compile_times(doc)
    rows: List[List[str]] = []
    for name, st in collect_stats(doc).items():
        rec = by_name.get(name, {})
        mean = st.mean if st.has_times else None
        ratio = rec.get("ratio")
        row = [
            name, _fmt_mean(mean),
            _fmt_time(st.stddev) if st.n > 1 else "-",
            str(st.n),
            _fmt_mean(compile_by_name.get(name)),
        ]
        if roofline:
            row.append(roofline.get(name, "-"))
        if latency:
            p99, good = latency.get(name, ("-", "-"))
            row += [p99, good]
        row += [
            rec.get("verdict", "-"),
            f"{ratio:.2f}x" if ratio is not None else "-",
        ]
        rows.append(row)
    return rows


def _drift_section(records: List[Dict[str, Any]], window: int) -> Section:
    sec = Section(f"Drift watch (window={window})")
    ids = hist.run_ids(records)
    if len(ids) < 2:
        sec.text("Needs at least two recorded runs; run again to start "
                 "the trend.")
        return sec
    comps = hist.detect_drift(records, window=window)
    flagged = [c for c in comps
               if c.verdict in ("regression", "improvement")]
    sec.text(f"Latest run `{ids[-1]}` vs the pooled window of up to "
             f"{window} prior run(s).")
    if not flagged:
        sec.text("No windowed drift detected.")
        return sec
    sec.table(
        ["benchmark", "window mean", "latest", "ratio", "verdict"],
        [[c.name, _fmt_mean(c.base_time), _fmt_mean(c.new_time),
          f"{c.ratio:.2f}x" if c.ratio is not None else "-", c.verdict]
         for c in flagged])
    return sec


def _sysinfo_section(ctx: Dict[str, Any]) -> Section:
    from repro_torch.core.sysinfo import context_digest
    sec = Section("System")
    rows = [[k, str(ctx.get(k))] for k in _SYSINFO_KEYS if ctx.get(k)]
    rows.append(["sysinfo digest", context_digest(ctx)])
    return sec.table(["key", "value"], rows)


# ---------------------------------------------------------------------------
# report generators
# ---------------------------------------------------------------------------

def generate_run_report(run_dir: str, history_file: Optional[str] = None,
                        out_dir: Optional[str] = None,
                        window: int = DEFAULT_WINDOW,
                        title: Optional[str] = None) -> Dict[str, str]:
    """Render one run's report; returns {'md': ..., 'html': ...}.

    ``history_file`` defaults to ``history.jsonl`` next to the run
    directory (i.e. the results root the orchestrator appends to).
    """
    run_dir = os.path.abspath(run_dir)
    bf = load(run_dir)
    ctx = bf.context
    run_id = ctx.get("run_id") or os.path.basename(run_dir)
    if history_file is None:
        history_file = hist.history_path(os.path.dirname(run_dir))
    out_dir = os.path.abspath(out_dir or os.path.join(run_dir, "report"))
    specs_dir = os.path.join(out_dir, "specs")
    data_dir = os.path.join(out_dir, "data")
    os.makedirs(specs_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)

    merged_path = os.path.join(run_dir, "merged.json")
    if not os.path.exists(merged_path):
        # interrupted run: materialize the shard concatenation so the
        # generated specs have a real file to reference
        merged_path = os.path.join(data_dir, "merged.json")
        bf.save(merged_path)

    records = hist.load_history(history_file) \
        if os.path.exists(history_file) else []
    run_records = hist.for_run(records, run_id)
    # Everything comparative is scoped to history *up to the reported
    # run*: reporting an older run must compare it against the runs
    # before it, never against runs recorded after it.
    ids = hist.run_ids(records)
    if run_id in ids:
        prior_ids = ids[:ids.index(run_id)]
        upto = set(prior_ids) | {run_id}
        scoped_records = [r for r in records if r.get("run_id") in upto]
    else:
        prior_ids = ids
        scoped_records = records
    prev_doc_path = None
    prev_names: set = set()
    if prior_ids:
        prev_doc_path = os.path.join(data_dir, "prev.json")
        prev_doc = hist.window_document(
            hist.for_run(records, prior_ids[-1]), window=1)
        prev_names = {b.get("run_name") or b.get("name", "")
                      for b in prev_doc["benchmarks"]}
        with open(prev_doc_path, "w") as f:
            json.dump(prev_doc, f, indent=2)
    # the trend plots must not leak runs recorded *after* the reported
    # run into its report: reporting an older run reads a materialized
    # prefix of the store instead of the live file
    plot_history_file = history_file
    if records and len(scoped_records) != len(records):
        plot_history_file = os.path.join(data_dir, "history.jsonl")
        with open(plot_history_file, "w") as f:
            for r in scoped_records:
                f.write(json.dumps(r) + "\n")

    scopes = bf.scope_names()
    sections: List[Section] = [_sysinfo_section(ctx)]

    shard_meta = bf.shards()
    if shard_meta:
        sections.append(Section("Scopes").table(
            ["scope", "status", "duration"],
            [[s.get("scope", "?"), s.get("status", "?"),
              f"{s.get('duration_s', 0.0):.2f}s"] for s in shard_meta]))

    verdicts = Section("Verdicts")
    if run_records:
        verdicts.text("`vs previous` is each instance's verdict against "
                      "its previous history record.")
    else:
        verdicts.text("No history records for this run — verdicts appear "
                      "once the run is recorded in history.jsonl.")
    doc = bf.to_dict()
    roofline = _roofline_cells(doc)
    latency = _latency_cells(doc)
    headers = ["benchmark", "mean", "stddev", "n", "compile"]
    if roofline:
        headers.append("roofline")
    if latency:
        headers += ["p99 latency", "goodput"]
    headers += ["vs previous", "ratio"]
    verdicts.table(headers,
                   _verdict_rows(doc, run_records, roofline, latency))
    sections.append(verdicts)
    sections.append(_drift_section(scoped_records, window))

    for scope in scopes:
        sec = Section(f"Scope: {scope}")
        plots = _scope_plots(scope, specs_dir, out_dir, merged_path,
                             plot_history_file if scoped_records else None,
                             prev_doc_path, f"run {run_id}",
                             history_records=scoped_records,
                             prev_names=prev_names,
                             latency=any(n.startswith(scope + "/")
                                         for n in latency))
        if not plots:
            sec.text("No plottable records.")
        for caption, rel in plots:
            sec.image(caption, rel)
        sections.append(sec)

    title = title or f"SCOPE benchmark report — run {run_id}"
    meta = [
        ("run", f"`{run_id}`"),
        ("run date", str(ctx.get("date", "unknown"))),
        ("records", f"{len(bf)} across {len(scopes)} scope(s)"),
        ("history", f"{len(hist.run_ids(records))} recorded run(s)"
         if records else "no history records"),
    ]
    md = os.path.join(out_dir, "report.md")
    html_path = os.path.join(out_dir, "index.html")
    _write_markdown(md, title, meta, sections)
    _write_html(html_path, title, meta, sections)
    log.info("report: wrote %s and %s", md, html_path)
    return {"md": md, "html": html_path}


def _tune_speedup_plot(summary: Dict[str, Any], specs_dir: str,
                       data_dir: str, out_dir: str
                       ) -> List[Tuple[str, str]]:
    """Before/after speedup bars for a tune run: every successful trial
    config (plus a ``<kernel> (best)`` bar) against the builtin-default
    baseline, rendered through the normal ``speedup`` spec pipeline."""
    baseline = summary.get("baseline") or {}
    base_time = (baseline.get("metrics") or {}).get("real_time_s")
    trials = (summary.get("search") or {}).get("trials", [])
    best = summary.get("best") or {}
    if not base_time or not trials:
        return []
    kernel = summary.get("kernel", "kernel")

    def rec(name: str, seconds: float) -> Dict[str, Any]:
        return {"name": name, "run_name": name, "run_type": "iteration",
                "iterations": 1, "real_time": seconds,
                "cpu_time": seconds, "time_unit": "s"}

    names: List[Tuple[str, float]] = []
    for t in trials:
        secs = (t.get("metrics") or {}).get("real_time_s")
        if t.get("error") or not secs:
            continue
        label = "/".join(f"{k}:{v}" for k, v in t["params"].items())
        names.append((label, secs))
    best_time = (best.get("metrics") or {}).get("real_time_s")
    if best_time:
        names.append((f"{kernel} (best)", best_time))
    if not names:
        return []
    before = {"context": {}, "benchmarks": [rec(n, base_time)
                                            for n, _ in names]}
    after = {"context": {}, "benchmarks": [rec(n, s) for n, s in names]}
    before_path = os.path.join(data_dir, "tune_before.json")
    after_path = os.path.join(data_dir, "tune_after.json")
    for path, doc in ((before_path, before), (after_path, after)):
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
    out = _emit_spec(specs_dir, "tune_speedup", {
        "title": f"{kernel} — speedup vs builtin-default blocks",
        "type": "speedup",
        "output": "../tune_speedup.svg",
        "x_axis": {"label": "speedup (builtin default / config)"},
        "baseline": {"input_file": _rel(before_path, specs_dir)},
        "series": [{"label": "tuned",
                    "input_file": _rel(after_path, specs_dir)}],
    })
    return [(f"{kernel}: per-config speedup vs the builtin default",
             _rel(out, out_dir))]


def generate_tune_report(run_dir: str, out_dir: Optional[str] = None,
                         title: Optional[str] = None) -> Dict[str, str]:
    """Render a ``python -m repro_torch tune`` run's report from its
    ``tune.json`` summary: before/after speedup bars per kernel and the
    factorial-screening sensitivity table.  Byte-identical when
    regenerated from the same run directory."""
    run_dir = os.path.abspath(run_dir)
    tune_path = os.path.join(run_dir, "tune.json")
    with open(tune_path) as f:
        summary = json.load(f)
    out_dir = os.path.abspath(out_dir or os.path.join(run_dir, "report"))
    specs_dir = os.path.join(out_dir, "specs")
    data_dir = os.path.join(out_dir, "data")
    os.makedirs(specs_dir, exist_ok=True)
    os.makedirs(data_dir, exist_ok=True)

    search = summary.get("search") or {}
    objective = summary.get("objective", "real_time_s")
    trials = search.get("trials", [])
    kernel = summary.get("kernel", "?")
    best = summary.get("best") or {}
    baseline = summary.get("baseline") or {}

    def fmt_cfg(cfg: Optional[Dict[str, Any]]) -> str:
        return ", ".join(f"{k}={v}" for k, v in (cfg or {}).items()) or "-"

    def fmt_obj(metrics: Optional[Dict[str, Any]]) -> str:
        v = (metrics or {}).get(objective)
        if v is None:
            return "-"
        return _fmt_time(v) if objective.endswith("_s") else f"{v:.4g}"

    overview = Section("Search")
    speedup = summary.get("speedup")
    overview.table(["key", "value"], [
        ["family", str(summary.get("family", "?"))],
        ["instance", str(summary.get("instance", "?"))],
        ["kernel", kernel],
        ["objective", objective],
        ["strategy", str(search.get("strategy", "?"))],
        ["trials", f"{len(trials)} of budget {search.get('budget', '?')}"
                   + (" (budget exhausted)" if search.get("exhausted")
                      else "")],
        ["seed", str(search.get("seed", "?"))],
        ["best config", fmt_cfg(best.get("params"))],
        ["best " + objective, fmt_obj(best.get("metrics"))],
        ["baseline config", fmt_cfg(baseline.get("params"))],
        ["baseline " + objective, fmt_obj(baseline.get("metrics"))],
        ["speedup", f"{speedup:.2f}x" if speedup else "-"],
    ])
    sections = [overview]

    sens = Section("Axis sensitivity (factorial screening)")
    ranking = search.get("sensitivity", [])
    if ranking:
        sens.text("Objective span when one axis moves across its "
                  "extremes with the others held at the space's center "
                  "— larger span = more sensitive axis.")
        sens.table(["rank", "axis", f"{objective} span"],
                   [[str(i + 1), r["axis"], f"{r['span']:.4g}"]
                    for i, r in enumerate(ranking)])
    else:
        sens.text("No screening pass in this run "
                  "(--strategy hillclimb skips it).")
    sections.append(sens)

    frontier = set(search.get("frontier", []))
    tr = Section("Trials")
    rows = []
    for t in trials:
        rows.append([
            str(t["index"]), t.get("phase", "?"),
            fmt_cfg(t.get("params")),
            fmt_obj(t.get("metrics")),
            "yes" if t["index"] in frontier else "",
            t.get("error", ""),
        ])
    tr.table(["#", "phase", "config", objective, "pareto", "error"], rows)
    sections.append(tr)

    plots = Section("Speedup")
    images = _tune_speedup_plot(summary, specs_dir, data_dir, out_dir)
    if images:
        for caption, rel in images:
            plots.image(caption, rel)
    else:
        plots.text("No baseline measurement — speedup bars need the "
                   "builtin-default config to have been measured.")
    sections.append(plots)

    title = title or (f"SCOPE tune report — {kernel} "
                      f"(run {summary.get('run_id', '?')})")
    meta = [
        ("run", f"`{summary.get('run_id', '?')}`"),
        ("kernel", kernel),
        ("family", str(summary.get("family", "?"))),
        ("trials", str(len(trials))),
    ]
    md = os.path.join(out_dir, "report.md")
    html_path = os.path.join(out_dir, "index.html")
    _write_markdown(md, title, meta, sections)
    _write_html(html_path, title, meta, sections)
    log.info("tune report: wrote %s and %s", md, html_path)
    return {"md": md, "html": html_path}


def generate_history_report(history_file: str,
                            out_dir: Optional[str] = None,
                            window: int = DEFAULT_WINDOW,
                            title: Optional[str] = None) -> Dict[str, str]:
    """Cross-run trend report over everything in a history file."""
    history_file = os.path.abspath(history_file)
    records = hist.load_history(history_file)
    out_dir = os.path.abspath(
        out_dir or os.path.join(os.path.dirname(history_file), "report"))
    specs_dir = os.path.join(out_dir, "specs")
    os.makedirs(specs_dir, exist_ok=True)

    ids = hist.run_ids(records)
    run_rows = []
    for rid in ids:
        rr = hist.for_run(records, rid)
        regressions = sum(1 for r in rr if r.get("verdict") == "regression")
        run_rows.append([rid, rr[0].get("ts", "") if rr else "",
                         str(len(rr)), str(regressions)])
    sections = [Section("Runs").table(
        ["run", "timestamp", "records", "regressions"], run_rows)]
    sections.append(_drift_section(records, window))

    scopes: List[str] = []
    for name in hist.benchmark_names(records):
        scope = name.split("/", 1)[0]
        if scope and scope not in scopes:
            scopes.append(scope)
    for scope in scopes:
        sec = Section(f"Scope: {scope}")
        for caption, rel in _scope_plots(scope, specs_dir, out_dir,
                                         None, history_file, None, "",
                                         history_records=records):
            sec.image(caption, rel)
        sections.append(sec)

    title = title or "SCOPE benchmark trend report"
    last_ts = records[-1].get("ts", "unknown") if records else "unknown"
    meta = [
        ("source", f"`{os.path.basename(history_file)}`"),
        ("runs", str(len(ids))),
        ("benchmarks", str(len(hist.benchmark_names(records)))),
        ("latest run", f"`{ids[-1]}` ({last_ts})" if ids else "none"),
    ]
    md = os.path.join(out_dir, "report.md")
    html_path = os.path.join(out_dir, "index.html")
    _write_markdown(md, title, meta, sections)
    _write_html(html_path, title, meta, sections)
    log.info("report: wrote %s and %s", md, html_path)
    return {"md": md, "html": html_path}


# ---------------------------------------------------------------------------
# CLI (python -m repro_torch report / python -m repro_torch.scopeplot report)
# ---------------------------------------------------------------------------

def build_report_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch report",
        description="Generate a static HTML/Markdown report (auto-"
                    "generated specs, embedded plots, verdicts, trends) "
                    "for one run or for the whole run history",
        epilog=epilog("report"),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("run", nargs="?", default=None,
                    help="run id under --results-dir, a run directory "
                         "path, or 'history' for the cross-run trend "
                         "report (optional with --serve: serve the "
                         "dashboard without regenerating)")
    ap.add_argument("--results-dir", default="results",
                    help="where runs and history.jsonl live "
                         "(default: results)")
    ap.add_argument("--output", default=None,
                    help="report directory (default: <run-dir>/report, "
                         "or <results-dir>/report for 'history')")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help=f"runs pooled for drift detection "
                         f"(default {DEFAULT_WINDOW})")
    ap.add_argument("--title", default=None, help="override report title")
    ap.add_argument("--serve", action="store_true",
                    help="after rendering, serve a live dashboard over "
                         "the result store: trend sparklines, drift "
                         "alerts, JSON query endpoints, and the static "
                         "report (repro_torch.scopeplot.dashboard)")
    ap.add_argument("--host", default="127.0.0.1",
                    help="dashboard bind address (default: %(default)s)")
    ap.add_argument("--port", type=int, default=8000,
                    help="dashboard port (default: %(default)s; 0 picks "
                         "a free one)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="with --serve, the device whose instances the "
                         "dashboard's coverage counts, as run's --device "
                         "registers them (default: cuda)")
    return ap


def _known_runs(results_dir: str) -> List[str]:
    if not os.path.isdir(results_dir):
        return []
    out = []
    for name in sorted(os.listdir(results_dir)):
        d = os.path.join(results_dir, name)
        if os.path.isdir(d) and (
                os.path.exists(os.path.join(d, "merged.json"))
                or os.path.exists(os.path.join(d, "manifest.json"))):
            out.append(name)
    return out


def report_main(argv: Optional[List[str]] = None) -> int:
    ap = build_report_parser()
    ns = ap.parse_args(argv)
    if ns.run is None and not ns.serve:
        ap.error("a run id (or 'history') is required unless --serve "
                 "is given")
    paths: Dict[str, str] = {}
    try:
        if ns.run is None:
            pass                    # --serve only: no regeneration
        elif ns.run == "history":
            path = hist.history_path(ns.results_dir)
            if not os.path.exists(path):
                print(f"error: no history file {path} (runs append to it "
                      f"when --results-dir is used)", file=sys.stderr)
                return 2
            paths = generate_history_report(path, out_dir=ns.output,
                                            window=ns.window,
                                            title=ns.title)
        else:
            run_dir = ns.run if os.path.isdir(ns.run) \
                else os.path.join(ns.results_dir, ns.run)
            if not os.path.isdir(run_dir):
                known = _known_runs(ns.results_dir)
                hint = f"; known runs: {', '.join(known)}" if known \
                    else ""
                print(f"error: no run directory {run_dir}{hint}",
                      file=sys.stderr)
                return 2
            if os.path.exists(os.path.join(run_dir, "tune.json")):
                # an autotuning run: its summary drives a dedicated
                # speedup/sensitivity page instead of the scope report
                paths = generate_tune_report(run_dir, out_dir=ns.output,
                                             title=ns.title)
            else:
                paths = generate_run_report(run_dir, out_dir=ns.output,
                                            window=ns.window,
                                            title=ns.title)
    except (OSError, json.JSONDecodeError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if paths:
        print(paths["html"])
        print(paths["md"])
    if ns.serve:
        from .dashboard import serve_dashboard
        report_dir = os.path.dirname(paths["html"]) if paths else (
            ns.output or os.path.join(ns.results_dir, "report"))
        return serve_dashboard(ns.results_dir, report_dir=report_dir,
                               host=ns.host, port=ns.port,
                               window=ns.window, device=ns.device)
    return 0
