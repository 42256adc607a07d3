"""YAML-spec-driven plotting (paper §V-A.1), the port of
``repro.scopeplot.plot``.

A *spec file* controls the plot type, the source JSON file for each data
series, regex filters to extract the desired data, per-series scaling
transformations, and styling.  Mirrors ScopePlot's spec schema::

    title: SAXPY throughput
    type: line            # line | bar | grouped_bar | regression
                          #   | speedup | timeseries
    output: saxpy.svg
    x_axis: {label: elements, scale: log}
    y_axis: {label: GB/s}
    series:
      - label: cpu
        input_file: results.json
        regex: "example/saxpy.*"
        xfield: n                  # GB name-arg or record field
        yfield: bytes_per_second
        yscale: 1.0e-9

Typed parameter spaces (repro_torch.core.benchmark.ParamSpace) make two more
series keys useful:

  * ``params: {axis: value}`` — keep only records whose name carries
    the ``axis:value`` component(s) (a value list ORs together);
  * ``group_by: axis`` — expand this series into one plotted series
    per distinct value of the axis, so *one* spec plots e.g. dtype as
    series instead of a hand-written series per family clone
    (unavailable for ``timeseries``, which reads history.jsonl).

Plot types (full schema reference: ``docs/scopeplot.md``):

  * ``line`` — line with error bars (stddev aggregates when present);
  * ``bar`` / ``grouped_bar`` — bars per series; grouped_bar aligns
    series by x *category* (union across series), so runs with
    different instance sets still line up;
  * ``regression`` — scatter + least-squares fit line;
  * ``speedup`` — horizontal bars of ``baseline_time / series_time``
    per matching run_name; needs a top-level ``baseline:`` mapping;
  * ``timeseries`` — cross-run trend lines read from a run-history
    ``history.jsonl`` (one line per benchmark, x = run, y = mean ±
    stddev);
  * ``latency_cdf`` — tail-latency CDF per matching record, drawn
    through the latency meter's percentile-grid counters
    (``latency_p50_s`` … ``latency_p999_s``; ``field:`` selects
    another prefix, e.g. ``ttft``) with a log-scaled probability axis
    so p99/p999 are readable.

Error contract: :func:`load_spec` raises :class:`SpecError` (a
``ValueError``) with ``<path>:<line>: <message>`` *before* any data is
read or rendered — an invalid ``type``, ``output`` or ``series`` fails
at the offending spec line, not deep inside the renderer.

Where the port differs from the reference: specs are read with
:mod:`repro_torch.scopeplot.specyaml` (the YAML subset specs use;
anchors, tags, block scalars and several documents are refused), and
plots are drawn by :mod:`repro_torch.scopeplot.svg` and written as
SVG: a spec's ``output`` ending in ``.png`` (or another raster or
print format, or no suffix) is written beside it with ``.svg``
(:func:`svg_output`), and :func:`render_spec`, :func:`is_stale` and
:func:`render_spec_dir` name and check that file.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from . import specyaml, svg
from .model import BenchmarkFile, load
from .specyaml import SpecError

#: Every plot type render_spec understands.
PLOT_TYPES = ("line", "bar", "grouped_bar", "regression", "speedup",
              "timeseries", "latency_cdf")
#: What an output path names when it is not an SVG file already.
_RASTER_SUFFIXES = (".png", ".jpg", ".jpeg", ".pdf", ".ps", ".eps",
                    ".tif", ".tiff", ".webp")


def svg_output(path: str) -> str:
    """The file a spec's ``output`` is written to: ``x.png`` (or another
    image suffix) becomes ``x.svg``, and a path with none gains it."""
    root, ext = os.path.splitext(path)
    if ext.lower() == ".svg":
        return path
    if ext.lower() in _RASTER_SUFFIXES:
        return root + ".svg"
    return path + ".svg"


def load_spec(path: str) -> Dict[str, Any]:
    """Load + validate a spec file; all schema errors carry line numbers.

    Validated up front (the error contract documented in
    ``docs/scopeplot.md``): ``type`` must be one of :data:`PLOT_TYPES`,
    ``output`` a string path, ``series`` a non-empty list of mappings
    each naming an ``input_file``, and a ``speedup`` spec must carry a
    ``baseline: {input_file: ...}`` mapping.
    """
    with open(path) as f:
        text = f.read()
    try:
        spec, lines = specyaml.load(text, path)
    except SpecError as e:
        raise SpecError(path, e.line, f"invalid YAML ({e.message})") from e
    if not isinstance(spec, dict):
        raise SpecError(path, 1, "spec must be a YAML mapping "
                                 f"(got {type(spec).__name__})")

    ptype = spec.get("type", "line")
    if ptype not in PLOT_TYPES:
        raise SpecError(path, lines.get("type", 1),
                        f"unknown plot type {ptype!r} (expected one of: "
                        + ", ".join(PLOT_TYPES) + ")")
    out = spec.get("output")
    if out is not None and not isinstance(out, str):
        raise SpecError(path, lines.get("output", 1),
                        "'output' must be a string path "
                        f"(got {type(out).__name__})")
    series = spec.get("series")
    if not isinstance(series, list) or not series:
        raise SpecError(path, lines.get("series", 1),
                        "spec needs a non-empty 'series' list")
    sline = lines.get("series", 1)
    for i, s in enumerate(series):
        if not isinstance(s, dict):
            raise SpecError(path, sline,
                            f"series[{i}] must be a mapping "
                            f"(got {type(s).__name__})")
        if not s.get("input_file"):
            raise SpecError(path, sline,
                            f"series[{i}] needs an 'input_file'")
        if "params" in s and not isinstance(s["params"], dict):
            raise SpecError(path, sline,
                            f"series[{i}] 'params' must be a mapping "
                            f"(got {type(s['params']).__name__})")
        if "group_by" in s:
            if not isinstance(s["group_by"], str):
                raise SpecError(path, sline,
                                f"series[{i}] 'group_by' must be an axis "
                                f"name (got {type(s['group_by']).__name__})")
            if ptype == "timeseries":
                raise SpecError(path, sline,
                                f"series[{i}]: 'group_by' is not available "
                                "for timeseries specs (history records "
                                "already plot one line per benchmark)")
    if ptype == "speedup":
        base = spec.get("baseline")
        if not isinstance(base, dict) or not base.get("input_file"):
            raise SpecError(path, lines.get("baseline", lines.get("type", 1)),
                            "speedup spec needs a 'baseline' mapping with "
                            "an 'input_file'")
    return spec


def spec_dependencies(spec: Dict[str, Any]) -> List[str]:
    """Paper §V-A.2 (deps): the data files a spec reads."""
    out: List[str] = []
    for s in spec.get("series", []):
        p = s.get("input_file")
        if p and p not in out:
            out.append(p)
    base = spec.get("baseline")
    if isinstance(base, dict):
        p = base.get("input_file")
        if p and p not in out:
            out.append(p)
    return out


def _resolve(path: str, base_dir: str) -> str:
    return path if os.path.isabs(path) else os.path.join(base_dir, path)


def _series_xy(series: Dict[str, Any], base_dir: str = "."
               ) -> Tuple[List[float], List[float], List[float]]:
    path = _resolve(series["input_file"], base_dir)
    bf = load(path).without_errors()
    if "regex" in series:
        bf = bf.filter_name(series["regex"])
    if "params" in series:
        bf = bf.filter_params(series["params"])
    xs, ys = bf.xy(series.get("xfield", "name"),
                   series.get("yfield", "real_time"))
    xscale = float(series.get("xscale", 1.0))
    yscale = float(series.get("yscale", 1.0))
    xs = [x * xscale if isinstance(x, (int, float)) else x for x in xs]
    ys = [y * yscale for y in ys]
    # error bars: stddev aggregates with matching run_name, if present,
    # one per plotted point (the reference takes one per record the
    # filters kept, aggregates and pointless records included, so its
    # errors miss the points whenever the series keeps an aggregate)
    errs: List[float] = []
    agg = {r.get("run_name"): r for r in load(path).records
           if r.get("aggregate_name") == "stddev"}
    if agg:
        for r in bf.records:
            one = BenchmarkFile(records=[r])
            if not one.xy(series.get("xfield", "name"),
                          series.get("yfield", "real_time"))[0]:
                continue
            a = agg.get(r.get("run_name"))
            errs.append(float(a.real_time or 0.0) * yscale if a else 0.0)
    return xs, ys, errs


def _mean_times(source: Dict[str, Any], base_dir: str) -> Dict[str, float]:
    """run_name → mean seconds for a {input_file, regex?} mapping."""
    bf = load(_resolve(source["input_file"], base_dir)).without_errors() \
        .without_aggregates()
    if "regex" in source:
        bf = bf.filter_name(source["regex"])
    if "params" in source:
        bf = bf.filter_params(source["params"])
    pools: Dict[str, List[float]] = {}
    for r in bf.records:
        t = r.real_time_seconds()
        if t is not None:
            pools.setdefault(r.get("run_name") or r.name, []).append(t)
    return {name: sum(ts) / len(ts) for name, ts in pools.items() if ts}


def _expand_group_by(spec: Dict[str, Any], base_dir: str
                     ) -> Dict[str, Any]:
    """Expand every ``group_by: axis`` series into one concrete series
    per distinct value of that axis (series-by-param: one spec plots
    dtype as series instead of a series per family clone)."""
    if not any("group_by" in s for s in spec.get("series", [])):
        return spec
    out: List[Dict[str, Any]] = []
    for series in spec["series"]:
        key = series.get("group_by")
        if not key:
            out.append(series)
            continue
        bf = load(_resolve(series["input_file"], base_dir))
        if "regex" in series:
            bf = bf.filter_name(series["regex"])
        if "params" in series:
            bf = bf.filter_params(series["params"])
        values = bf.param_values(key)
        base_label = series.get("label")
        for value in values:
            expanded = {k: v for k, v in series.items() if k != "group_by"}
            expanded["params"] = {**series.get("params", {}), key: value}
            expanded["label"] = (f"{base_label} {key}:{value}"
                                 if base_label else f"{key}:{value}")
            out.append(expanded)
        if not values:
            out.append({k: v for k, v in series.items()
                        if k != "group_by"})
    return {**spec, "series": out}


def _category(x: Any) -> str:
    if isinstance(x, float) and x.is_integer():
        return str(int(x))
    return str(x)


# ---------------------------------------------------------------------------
# per-type renderers
# ---------------------------------------------------------------------------

def _draw_line(ax, spec: Dict[str, Any], base_dir: str) -> None:
    for i, series in enumerate(spec["series"]):
        xs, ys, errs = _series_xy(series, base_dir)
        ax.errorbar(xs, ys, yerr=errs if any(errs) else None,
                    marker="o", label=series.get("label", f"series{i}"),
                    capsize=3)


def _draw_bar(ax, spec: Dict[str, Any], base_dir: str) -> None:
    n_series = len(spec["series"])
    width = 0.8 / max(n_series, 1)
    for i, series in enumerate(spec["series"]):
        xs, ys, errs = _series_xy(series, base_dir)
        pos = np.arange(len(xs)) + i * width
        ax.bar(pos, ys, width=width, label=series.get("label", f"series{i}"),
               yerr=errs if any(errs) else None, capsize=3)
        if i == 0:
            ax.set_xticks(np.arange(len(xs)) + 0.4 - width / 2)
            ax.set_xticklabels([str(x) for x in xs], rotation=30,
                               ha="right", fontsize=8)


def _draw_grouped_bar(ax, spec: Dict[str, Any], base_dir: str) -> None:
    """Bars aligned by x *category* — the union across all series.

    Unlike ``bar`` (which assumes every series yields the same x
    sequence), series with missing categories leave a gap instead of
    shifting their remaining bars onto the wrong ticks.  A category
    repeated *within* one series (e.g. ``xfield: n`` matching two
    families with the same sweep) is disambiguated with an occurrence
    suffix rather than silently dropping the earlier bars.
    """
    categories: List[str] = []
    loaded = []
    for i, series in enumerate(spec["series"]):
        xs, ys, errs = _series_xy(series, base_dir)
        seen: Dict[str, int] = {}
        cats = []
        for x in xs:
            c = _category(x)
            seen[c] = seen.get(c, 0) + 1
            cats.append(c if seen[c] == 1 else f"{c} ({seen[c]})")
        for c in cats:
            if c not in categories:
                categories.append(c)
        loaded.append((series.get("label", f"series{i}"),
                       dict(zip(cats, ys)),
                       dict(zip(cats, errs)) if errs else {}))
    n_series = max(len(loaded), 1)
    width = 0.8 / n_series
    idx = np.arange(len(categories))
    for i, (label, ymap, emap) in enumerate(loaded):
        ys = [ymap.get(c, np.nan) for c in categories]
        errs = [emap.get(c, 0.0) for c in categories]
        ax.bar(idx + (i - (n_series - 1) / 2) * width, ys, width=width,
               label=label, yerr=errs if any(errs) else None, capsize=3)
    ax.set_xticks(idx)
    ax.set_xticklabels(categories, rotation=30, ha="right", fontsize=8)


def _draw_regression(ax, spec: Dict[str, Any], base_dir: str) -> None:
    for i, series in enumerate(spec["series"]):
        xs, ys, errs = _series_xy(series, base_dir)
        label = series.get("label", f"series{i}")
        xf = np.asarray(xs, dtype=float)
        yf = np.asarray(ys, dtype=float)
        ax.errorbar(xf, yf, yerr=errs if any(errs) else None, fmt="o",
                    label=label, capsize=3)
        if len(xf) >= 2:
            slope, icept = np.polyfit(xf, yf, 1)
            grid = np.linspace(xf.min(), xf.max(), 64)
            ax.plot(grid, slope * grid + icept, "--",
                    label=f"{label} fit ({slope:.3g}x+{icept:.3g})")


def _draw_speedup(ax, spec: Dict[str, Any], base_dir: str) -> None:
    """Horizontal bars of baseline_time / series_time (>1 = faster)."""
    base = _mean_times(spec["baseline"], base_dir)
    labels: List[str] = []
    values: List[float] = []
    colors: List[str] = []
    for i, series in enumerate(spec["series"]):
        cur = _mean_times(series, base_dir)
        tag = series.get("label", f"series{i}")
        for name in cur:
            if name not in base or cur[name] <= 0:
                continue
            sp = base[name] / cur[name]
            labels.append(name if len(spec["series"]) == 1
                          else f"{name} [{tag}]")
            values.append(sp)
            colors.append("tab:green" if sp >= 1.0 else "tab:red")
    pos = np.arange(len(labels))
    ax.barh(pos, values, color=colors, alpha=0.8)
    ax.set_yticks(pos)
    ax.set_yticklabels(labels, fontsize=8)
    ax.invert_yaxis()
    ax.axvline(1.0, color="k", linewidth=1)
    for p, v in zip(pos, values):
        ax.annotate(f"{v:.2f}x", (v, p), xytext=(3, 0),
                    textcoords="offset points", va="center", fontsize=8)


def _draw_timeseries(ax, spec: Dict[str, Any], base_dir: str) -> None:
    """Cross-run trend from a history.jsonl (repro_torch.core.history).

    The x axis is the union of every series' run order (first-seen
    across series), so multiple series reading different history files
    share one correctly-labeled axis instead of each being plotted
    against the first file's run order.
    """
    from repro_torch.core.history import load_history, run_ids
    loaded = [(series,
               load_history(_resolve(series["input_file"], base_dir)))
              for series in spec["series"]]
    tick_runs: List[str] = []
    for _, records in loaded:
        for rid in run_ids(records):
            if rid not in tick_runs:
                tick_runs.append(rid)
    run_index = {rid: k for k, rid in enumerate(tick_runs)}
    for series, records in loaded:
        if series.get("benchmark"):
            records = [r for r in records
                       if r.get("name") == series["benchmark"]]
        elif series.get("regex"):
            import re
            rx = re.compile(series["regex"])
            records = [r for r in records if rx.search(r.get("name", ""))]
        yscale = float(series.get("yscale", 1.0))
        by_name: Dict[str, List[Dict[str, Any]]] = {}
        for r in records:
            if r.get("mean_s") is not None:
                by_name.setdefault(r["name"], []).append(r)
        for name, recs in by_name.items():
            xs = [run_index[r["run_id"]] for r in recs
                  if r.get("run_id") in run_index]
            ys = [float(r["mean_s"]) * yscale for r in recs
                  if r.get("run_id") in run_index]
            errs = [float(r.get("stddev_s") or 0.0) * yscale for r in recs
                    if r.get("run_id") in run_index]
            label = name if len(by_name) > 1 else \
                series.get("label", name)
            ax.errorbar(xs, ys, yerr=errs if any(errs) else None,
                        marker="o", label=label, capsize=3)
    ax.set_xticks(range(len(tick_runs)))
    ax.set_xticklabels(tick_runs, rotation=30, ha="right", fontsize=8)
    ax.margins(x=0.05)


def _draw_latency_cdf(ax, spec: Dict[str, Any], base_dir: str) -> None:
    """Tail-latency CDF per record from percentile-grid counters.

    The latency meter puts p50/p90/p99/p999 on every record; each
    matching record becomes one CDF line through those four points
    (x = latency, y = cumulative fraction).  ``field:`` on a series
    switches the counter prefix (default ``latency``; ``ttft`` plots
    first-token CDFs).  The y axis plots ``1 - q`` on a log scale when
    ``y_axis: {scale: log}`` is requested, which is the standard way to
    make the p99/p999 decades readable.
    """
    from repro_torch.core.quantile import TAIL_QUANTILES
    tail = spec.get("y_axis", {}).get("scale") == "log"
    for i, series in enumerate(spec["series"]):
        path = _resolve(series["input_file"], base_dir)
        bf = load(path).without_errors().without_aggregates()
        if "regex" in series:
            bf = bf.filter_name(series["regex"])
        if "params" in series:
            bf = bf.filter_params(series["params"])
        field = series.get("field", "latency")
        xscale = float(series.get("xscale", 1.0))
        tag = series.get("label")
        for rec in bf.records:
            pts = [(float(rec.get(f"{field}_{suffix}_s")) * xscale, q)
                   for suffix, q in TAIL_QUANTILES
                   if rec.get(f"{field}_{suffix}_s") is not None]
            if not pts:
                continue
            xs = [p[0] for p in pts]
            ys = [1.0 - p[1] for p in pts] if tail else [p[1] for p in pts]
            name = rec.get("run_name") or rec.name
            label = f"{name} [{tag}]" if tag and len(spec["series"]) > 1 \
                else name
            ax.plot(xs, ys, marker="o", label=label)
    if tail:
        ax.set_ylabel(spec.get("y_axis", {}).get("label")
                      or "P(latency > x)")


_RENDERERS = {
    "line": _draw_line,
    "bar": _draw_bar,
    "grouped_bar": _draw_grouped_bar,
    "regression": _draw_regression,
    "speedup": _draw_speedup,
    "timeseries": _draw_timeseries,
    "latency_cdf": _draw_latency_cdf,
}


def render_spec(spec: Dict[str, Any], output: Optional[str] = None,
                base_dir: str = ".") -> str:
    """Draw ``spec`` and write it as SVG; returns the path written
    (``output``, or the spec's, through :func:`svg_output`)."""
    ptype = spec.get("type", "line")
    if ptype not in _RENDERERS:
        raise SpecError("<spec>", 0, f"unknown plot type {ptype!r} "
                        "(expected one of: " + ", ".join(PLOT_TYPES) + ")")
    if ptype != "timeseries":
        spec = _expand_group_by(spec, base_dir)
    fig, ax = svg.subplots(figsize=spec.get("figsize", (7, 4.5)))
    _RENDERERS[ptype](ax, spec, base_dir)

    xaxis = spec.get("x_axis", {})
    yaxis = spec.get("y_axis", {})
    if xaxis.get("label"):
        ax.set_xlabel(xaxis["label"])
    if yaxis.get("label"):
        ax.set_ylabel(yaxis["label"])
    if xaxis.get("scale") == "log" and ptype in ("line", "regression"):
        ax.set_xscale("log", base=2)
    if yaxis.get("scale") == "log":
        ax.set_yscale("log")
    if spec.get("title"):
        ax.set_title(spec["title"])
    ax.grid(True, alpha=0.3)
    if ax.get_legend_handles_labels()[0]:
        ax.legend(fontsize=8)
    fig.tight_layout()

    out = output or spec.get("output", "scope_plot.png")
    out = svg_output(_resolve(out, base_dir))
    fig.savefig(out, dpi=spec.get("dpi", 120))
    return out


def quick_bar(json_path: str, x: str, y: str, title: str = "",
              output: str = "bar.svg", regex: str = ".*") -> str:
    """Paper §V-A.3 (bar): one-shot bar plot without a spec file."""
    spec = {
        "title": title or os.path.basename(json_path),
        "type": "bar",
        "output": output,
        "x_axis": {"label": x},
        "y_axis": {"label": y},
        "series": [{"label": y, "input_file": json_path, "regex": regex,
                    "xfield": x, "yfield": y}],
    }
    return render_spec(spec)


# ---------------------------------------------------------------------------
# batch mode (paper §V-A.2: deps → rebuild only stale plots)
# ---------------------------------------------------------------------------

def spec_files(spec_dir: str) -> List[str]:
    return sorted(os.path.join(spec_dir, f) for f in os.listdir(spec_dir)
                  if f.endswith((".yaml", ".yml")))


def is_stale(spec_path: str, spec: Dict[str, Any]) -> bool:
    """True when the spec's output (as :func:`svg_output` names it) is
    missing or older than any input.

    Inputs are the spec file itself plus every data dependency
    (:func:`spec_dependencies`) — the same file set ``scope_plot deps``
    emits for make, applied directly.
    """
    base = os.path.dirname(spec_path) or "."
    out = svg_output(_resolve(spec.get("output", "scope_plot.png"), base))
    if not os.path.exists(out):
        return True
    out_mtime = os.path.getmtime(out)
    deps = [spec_path] + [_resolve(d, base)
                          for d in spec_dependencies(spec)]
    return any(os.path.exists(d) and os.path.getmtime(d) > out_mtime
               for d in deps)


def render_spec_dir(spec_dir: str, force: bool = False
                    ) -> List[Tuple[str, str, str]]:
    """Render every spec in a directory, skipping up-to-date outputs.

    Relative paths inside each spec resolve against the spec file's own
    directory.  Returns ``(spec_path, output_path, status)`` per spec,
    status one of ``rendered`` / ``fresh`` / ``error: <msg>`` — one bad
    spec doesn't stop the batch.
    """
    results: List[Tuple[str, str, str]] = []
    for path in spec_files(spec_dir):
        base = os.path.dirname(path) or "."
        try:
            spec = load_spec(path)
            out = svg_output(_resolve(spec.get("output", "scope_plot.png"),
                                      base))
            if not force and not is_stale(path, spec):
                results.append((path, out, "fresh"))
                continue
            render_spec(spec, base_dir=base)
            results.append((path, out, "rendered"))
        except (OSError, ValueError) as e:
            results.append((path, "", f"error: {e}"))
    return results
