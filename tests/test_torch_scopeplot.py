"""ScopePlot in the torch port (``repro_torch.scopeplot``) against the
reference's ``repro.scopeplot``: the object model and frames on the same
documents; for each of the seven plot types, what the port's renderer
draws on its SVG surface (``svg.Axes``) against what the reference's
draws on a matplotlib Agg ``Axes`` from the same spec and data (series
labels, each line's x and y, bar positions and heights, error values,
tick labels, scales, axis labels, the title, the legend); the SVG as
XML; the CLI, also in a process that cannot import matplotlib or
PyYAML; and no import of ``repro``, ``jax``, ``matplotlib`` or ``yaml``
anywhere in the port."""
import ast
import json
import math
import os
import random
import subprocess
import sys
import xml.etree.ElementTree as ET

import matplotlib
import pytest
import yaml

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.colors import to_hex  # noqa: E402
from matplotlib.container import BarContainer, ErrorbarContainer  # noqa: E402

from repro.core import history as ref_hist  # noqa: E402
from repro.scopeplot import BenchmarkFile as RefBenchmarkFile  # noqa: E402
from repro.scopeplot import Frame as RefFrame  # noqa: E402
from repro.scopeplot import cat as ref_cat  # noqa: E402
from repro.scopeplot import load as ref_load  # noqa: E402
from repro.scopeplot import plot as ref_plot  # noqa: E402
from repro_torch.core import history as port_hist  # noqa: E402
from repro_torch.scopeplot import BenchmarkFile, Frame, cat, load  # noqa: E402
from repro_torch.scopeplot import plot as port_plot  # noqa: E402
from repro_torch.scopeplot import svg  # noqa: E402
from repro_torch.scopeplot.__main__ import main as port_cli  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")

#: A sweep with repetitions (stddev aggregates give error bars), a
#: second family with a category the first lacks, typed parameters,
#: and an errored record that every plot drops.  ``POINTS_A`` keeps the
#: sweep's iteration records and not its aggregates.
DOC = {
    "context": {"host_name": "h"},
    "benchmarks": [
        *[{"name": f"s/a/dtype:{dt}/n:{n}", "run_name": f"s/a/dtype:{dt}/n:{n}",
           "run_type": "iteration", "iterations": 10,
           "real_time": t, "cpu_time": t, "time_unit": "us",
           "bytes_per_second": 1e9 * n / t}
          for dt, scale in (("f32", 1.0), ("bf16", 0.6))
          for n, t in ((256, 5.0 * scale), (1024, 9.0 * scale),
                       (4096, 31.0 * scale))],
        *[{"name": f"s/a/dtype:f32/n:{n}_stddev",
           "run_name": f"s/a/dtype:f32/n:{n}",
           "run_type": "aggregate", "aggregate_name": "stddev",
           "iterations": 3, "real_time": e, "cpu_time": e,
           "time_unit": "us"}
          for n, e in ((256, 0.4), (1024, 0.7), (4096, 1.5))],
        {"name": "s/b/n:256", "run_name": "s/b/n:256",
         "run_type": "iteration", "iterations": 10, "real_time": 4.0,
         "cpu_time": 4.0, "time_unit": "us", "bytes_per_second": 6e10},
        {"name": "s/b/n:65536", "run_name": "s/b/n:65536",
         "run_type": "iteration", "iterations": 10, "real_time": 0.2,
         "cpu_time": 0.2, "time_unit": "ms", "bytes_per_second": 3e11},
        {"name": "s/err", "run_name": "s/err", "run_type": "iteration",
         "iterations": 1, "real_time": 9.0, "cpu_time": 9.0,
         "time_unit": "ms", "error_occurred": True, "error_message": "x"},
    ],
}

#: The baseline of the speedup plot: some instances faster, some slower.
BASE_DOC = {
    "context": {},
    "benchmarks": [
        {"name": r["name"], "run_name": r["run_name"],
         "run_type": "iteration", "iterations": 10,
         "real_time": r["real_time"] * f, "cpu_time": r["real_time"] * f,
         "time_unit": r["time_unit"]}
        for r, f in zip([b for b in DOC["benchmarks"]
                         if b["run_type"] == "iteration"
                         and not b.get("error_occurred")],
                        (1.3, 0.8, 1.0, 2.0, 1.1, 0.5, 1.7, 0.9))],
}

LATENCY_DOC = {
    "context": {"host_name": "h"},
    "benchmarks": [
        {"name": "serve/load/arrival:poisson",
         "run_name": "serve/load/arrival:poisson", "run_type": "iteration",
         "iterations": 1, "real_time": 5.0, "cpu_time": 5.0,
         "time_unit": "us",
         "latency_p50_s": 0.010, "latency_p90_s": 0.020,
         "latency_p99_s": 0.050, "latency_p999_s": 0.090,
         "ttft_p50_s": 0.004, "ttft_p99_s": 0.009},
        {"name": "serve/load/arrival:bursty",
         "run_name": "serve/load/arrival:bursty", "run_type": "iteration",
         "iterations": 1, "real_time": 5.0, "cpu_time": 5.0,
         "time_unit": "us",
         "latency_p50_s": 0.012, "latency_p90_s": 0.030,
         "latency_p99_s": 0.120, "latency_p999_s": 0.400},
        {"name": "serve/load/no-latency-counters",
         "run_name": "serve/load/no-latency-counters",
         "run_type": "iteration", "iterations": 1, "real_time": 5.0,
         "cpu_time": 5.0, "time_unit": "us"},
    ],
}


POINTS_A = r"^s/a/.*[0-9]$"


def gb_doc(run_id, means_us, date):
    return {"context": {"run_id": run_id, "date": date, "host_name": "h"},
            "benchmarks": [
                {"name": n, "run_name": n, "run_type": "iteration",
                 "repetitions": 1, "repetition_index": 0, "threads": 1,
                 "iterations": 10, "real_time": us, "cpu_time": us,
                 "time_unit": "us"} for n, us in means_us.items()]}


@pytest.fixture
def data(tmp_path):
    """The documents and two history stores every plot reads."""
    paths = {}
    for name, doc in (("doc", DOC), ("base", BASE_DOC),
                      ("latency", LATENCY_DOC)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(doc))
    for store, runs in (("h1", ("r1", "r2", "r3")), ("h2", ("r2", "r4"))):
        d = tmp_path / store
        for k, rid in enumerate(runs):
            ref_hist.append_run(str(d), gb_doc(
                rid, {"s/a/n:1": 2.0 + k * 0.3, "s/a/n:2": 4.0 - k * 0.2,
                      "t/x": 7.0 + k},
                date=f"2026-07-3{k}T00:00:00"))
        paths[store] = d / "history.jsonl"
    return {k: str(v) for k, v in paths.items()}


def bf():
    return BenchmarkFile.from_dict(json.loads(json.dumps(DOC)))


def ref_bf():
    return RefBenchmarkFile.from_dict(json.loads(json.dumps(DOC)))


# ---------------------------------------------------------------------------
# the object model and frames, against the reference's
# ---------------------------------------------------------------------------

def test_model_matches_reference():
    port, ref = bf(), ref_bf()
    assert port.to_dict() == ref.to_dict()
    for method, args in (("filter_name", ("s/a",)),
                         ("filter_params", ({"dtype": "f32"},)),
                         ("filter_params", ({"n": [256, "4096"]},)),
                         ("without_aggregates", ()),
                         ("without_errors", ()),
                         ("for_scope", ("s",))):
        assert getattr(port, method)(*args).to_dict() == \
            getattr(ref, method)(*args).to_dict(), method
    for key in ("n", "dtype", "missing"):
        assert port.param_values(key) == ref.param_values(key)
    for x, y in (("n", "bytes_per_second"), ("name", "real_time"),
                 ("n", "real_time_s")):
        assert port.without_errors().xy(x, y) == \
            ref.without_errors().xy(x, y)
    assert port.scope_names() == ref.scope_names()
    for pr, rr in zip(port.records, ref.records):
        assert (pr.name, pr.scope, pr.args(), pr.params, pr.arg("n"),
                pr.arg(0), pr.counters, pr.real_time_seconds()) == \
            (rr.name, rr.scope, rr.args(), rr.params, rr.arg("n"),
             rr.arg(0), rr.counters, rr.real_time_seconds())
    assert cat([port, port]).to_dict() == ref_cat([ref, ref]).to_dict()
    doubled = port.transform("real_time", lambda t: 2 * t)
    assert doubled.to_dict() == \
        ref.transform("real_time", lambda t: 2 * t).to_dict()


def test_frame_matches_reference():
    port = bf().without_errors().to_frame(["name", "real_time"])
    ref = ref_bf().without_errors().to_frame(["name", "real_time"])
    assert port.rows() == ref.rows() and port.columns == ref.columns
    k = ["x" if i % 2 else "y" for i in range(len(port))]
    assert port.with_column("k", k).groupby(
        "k", {"real_time": sum}).rows() == \
        ref.with_column("k", k).groupby("k", {"real_time": sum}).rows()
    assert port.sort_by("real_time", reverse=True).rows() == \
        ref.sort_by("real_time", reverse=True).rows()
    assert port.to_csv() == ref.to_csv()
    assert bf().to_frame().rows() == ref_bf().to_frame().rows()
    with pytest.raises(ValueError, match="ragged"):
        Frame({"a": [1], "b": [1, 2]})


def test_frame_csv_matches_reference():
    """Lists of 1-20 floats in [0, 1e6], drawn from a seeded generator
    with the interval's ends, zero and tiny values among them."""
    rng = random.Random(0)
    edges = (0.0, 1e6, 5e-324, 1e-9, 0.5, 999999.999999)
    for _ in range(25):
        vals = [rng.choice(edges) if rng.random() < 0.2
                else rng.uniform(0, 1e6) * 10.0 ** -rng.randint(0, 12)
                for _ in range(rng.randint(1, 20))]
        assert Frame({"v": vals}).to_csv() == \
            RefFrame({"v": vals}).to_csv(), vals


def test_load_run_dir_matches_reference(tmp_path):
    """A run directory without merged.json loads as the concatenation of
    its shards, in both packages."""
    run = tmp_path / "run"
    run.mkdir()
    for scope in ("a", "b"):
        doc = json.loads(json.dumps(DOC))
        for r in doc["benchmarks"]:
            r["name"] = r["name"].replace("s/", f"{scope}/", 1)
        (run / f"{scope}.json").write_text(json.dumps(doc))
    assert load(str(run)).to_dict() == ref_load(str(run)).to_dict()
    (run / "merged.json").write_text(json.dumps(DOC))
    assert load(str(run)).to_dict() == ref_load(str(run)).to_dict()
    with pytest.raises(FileNotFoundError):
        load(str(tmp_path / "missing_dir_is_a_file.json"))


# ---------------------------------------------------------------------------
# the seven plot types: the port's drawing against matplotlib's
# ---------------------------------------------------------------------------

def _specs(d):
    """One spec per plot type, each with two series where the type
    takes them, on the data fixture."""
    return {
        "line": {
            "title": "line <&> plot", "type": "line",
            "x_axis": {"label": "elements", "scale": "log"},
            "y_axis": {"label": "GB/s"},
            "series": [
                {"label": "f32", "input_file": d["doc"], "regex": POINTS_A,
                 "params": {"dtype": "f32"}, "xfield": "n",
                 "yfield": "real_time"},
                {"input_file": d["doc"], "regex": POINTS_A,
                 "group_by": "dtype", "xfield": "n",
                 "yfield": "bytes_per_second", "yscale": 1.0e-9}]},
        "bar": {
            "title": "bars", "type": "bar",
            "x_axis": {"label": "n"}, "y_axis": {"label": "us"},
            "series": [
                {"label": "f32", "input_file": d["doc"], "regex": POINTS_A,
                 "params": {"dtype": "f32"}, "xfield": "n"},
                {"label": "bf16", "input_file": d["doc"], "regex": POINTS_A,
                 "params": {"dtype": "bf16"}, "xfield": "n"}]},
        "grouped_bar": {
            "title": "grouped", "type": "grouped_bar",
            "y_axis": {"label": "s", "scale": "log"},
            "series": [
                {"label": "a", "input_file": d["doc"], "regex": POINTS_A,
                 "xfield": "n", "yfield": "real_time_s"},
                {"label": "b", "input_file": d["doc"], "regex": "s/b/",
                 "xfield": "n", "yfield": "real_time_s"}]},
        "regression": {
            "title": "fit", "type": "regression",
            "x_axis": {"scale": "log"},
            "series": [
                {"label": "f32", "input_file": d["doc"], "regex": POINTS_A,
                 "params": {"dtype": "f32"}, "xfield": "n",
                 "yfield": "real_time"},
                {"label": "bf16", "input_file": d["doc"], "regex": POINTS_A,
                 "params": {"dtype": "bf16"}, "xfield": "n",
                 "yfield": "real_time"}]},
        "speedup": {
            "title": "speedup", "type": "speedup",
            "x_axis": {"label": "speedup"},
            "baseline": {"input_file": d["base"]},
            "series": [
                {"label": "a", "input_file": d["doc"], "regex": "s/a/"},
                {"label": "b", "input_file": d["doc"], "regex": "s/b/"}]},
        "timeseries": {
            "title": "trend", "type": "timeseries",
            "y_axis": {"label": "mean time (s)"},
            "series": [
                {"label": "s", "input_file": d["h1"], "regex": "^s/"},
                {"label": "t", "input_file": d["h2"], "benchmark": "t/x",
                 "yscale": 1e6}]},
        "latency_cdf": {
            "title": "tails", "type": "latency_cdf",
            "x_axis": {"label": "latency (ms)"},
            "y_axis": {"scale": "log"},
            "series": [
                {"label": "e2e", "input_file": d["latency"],
                 "regex": "serve/", "xscale": 1e3},
                {"label": "ttft", "input_file": d["latency"],
                 "regex": "serve/", "field": "ttft", "xscale": 1e3}]},
    }


def _floats(values):
    return [None if v is None or math.isnan(v) else round(float(v), 12)
            for v in values]


def _mpl_drawing(ax):
    """What a matplotlib Axes holds, in the shape of ``_svg_drawing``."""
    bar_errorbars = {id(c.errorbar) for c in ax.containers
                     if isinstance(c, BarContainer) and c.errorbar}
    errorbar_lines = set()
    out = {"errorbar": [], "plot": [], "bar": [], "barh": []}
    for c in ax.containers:
        if isinstance(c, ErrorbarContainer) and id(c) not in bar_errorbars:
            data_line, caps, cols = c.lines
            errorbar_lines.add(id(data_line))
            errorbar_lines.update(id(x) for x in caps)
            xy = data_line.get_xydata()
            yerr = None
            if cols:
                yerr = _floats((s[1][1] - s[0][1]) / 2
                               for s in cols[0].get_segments())
            out["errorbar"].append({
                "label": c.get_label(), "x": _floats(xy[:, 0]),
                "y": _floats(xy[:, 1]), "yerr": yerr,
                "linestyle": data_line.get_linestyle(),
                "marker": data_line.get_marker()})
        elif isinstance(c, BarContainer):
            horizontal = c.orientation == "horizontal"
            rects = c.patches
            if horizontal:
                pos = [r.get_y() + r.get_height() / 2 for r in rects]
                vals = [r.get_width() for r in rects]
                thick = {round(r.get_height(), 12) for r in rects}
            else:
                pos = [r.get_x() + r.get_width() / 2 for r in rects]
                vals = [r.get_height() for r in rects]
                thick = {round(r.get_width(), 12) for r in rects}
            errs = None
            if c.errorbar:
                data_line, caps, _ = c.errorbar.lines
                errorbar_lines.add(id(data_line))
                errorbar_lines.update(id(x) for x in caps)
                segs = c.errorbar.lines[2][0].get_segments()
                finite = [v for v in vals if not math.isnan(v)]
                errs = _floats((s[1][1] - s[0][1]) / 2 for s in segs
                               if len(s))
                assert len(errs) == len(finite)
            out["barh" if horizontal else "bar"].append({
                "label": None if c.get_label().startswith("_")
                else c.get_label(),
                "pos": _floats(pos), "values": _floats(vals),
                "thickness": sorted(thick), "err": errs,
                "colors": [to_hex(r.get_facecolor(), keep_alpha=False)
                           for r in rects] if horizontal else None,
                "alpha": (rects[0].get_alpha() or 1.0) if rects else None})
    vlines = []
    for line in ax.lines:
        if id(line) in errorbar_lines:
            continue
        if line.get_transform() is not ax.transData:    # axvline
            vlines.append((_floats(line.get_xdata())[0],
                           to_hex(line.get_color())))
            continue
        xy = line.get_xydata()
        out["plot"].append({
            "label": line.get_label(), "x": _floats(xy[:, 0]),
            "y": _floats(xy[:, 1]), "linestyle": line.get_linestyle(),
            "marker": line.get_marker()})
    fixed = isinstance(ax.xaxis.get_major_locator(),
                       matplotlib.ticker.FixedLocator)
    yfixed = isinstance(ax.yaxis.get_major_locator(),
                        matplotlib.ticker.FixedLocator)
    out["axes"] = {
        "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "title": ax.get_title(),
        "xscale": (ax.get_xscale(), ax.xaxis.get_transform().base
                   if ax.get_xscale() == "log" else None),
        "yscale": (ax.get_yscale(), ax.yaxis.get_transform().base
                   if ax.get_yscale() == "log" else None),
        "xticks": (_floats(ax.get_xticks()),
                   [t.get_text() for t in ax.get_xticklabels()])
        if fixed else None,
        "yticks": (_floats(ax.get_yticks()),
                   [t.get_text() for t in ax.get_yticklabels()])
        if yfixed else None,
        "yinverted": ax.yaxis_inverted(),
        "xmargin": round(ax.margins()[0], 12),
        "legend": ax.get_legend_handles_labels()[1]
        if ax.get_legend() is not None else None,
        "vlines": vlines,
        "annotations": [(t.get_text(), _floats(t.xy))
                        for t in ax.texts],
    }
    return out


def _svg_drawing(ax):
    out = {"errorbar": [], "plot": [], "bar": [], "barh": []}
    for a in ax.artists:
        if isinstance(a, svg.Line):
            row = {"label": a.label if a.label is not None
                   else ("_nolegend_" if a.kind == "errorbar" else None),
                   "x": _floats(a.x), "y": _floats(a.y),
                   "linestyle": a.linestyle or "None",
                   "marker": a.marker or "None"}
            if a.kind == "errorbar":
                row["yerr"] = _floats(a.yerr) if a.yerr else None
            out[a.kind].append(row)
        elif isinstance(a, svg.Bars):
            finite = [not math.isnan(v) for v in a.values]
            out["barh" if a.horizontal else "bar"].append({
                "label": a.label, "pos": _floats(a.pos),
                "values": _floats(a.values),
                "thickness": [round(a.thickness, 12)] if a.values else [],
                "err": [round(e, 12) for e, ok in zip(a.err, finite) if ok]
                if a.err else None,
                "colors": list(a.colors) if a.horizontal else None,
                "alpha": a.alpha if a.values else None})
    x, y = ax.xaxis, ax.yaxis
    out["axes"] = {
        "xlabel": x.label, "ylabel": y.label, "title": ax.title,
        "xscale": (x.scale, x.base if x.scale == "log" else None),
        "yscale": (y.scale, y.base if y.scale == "log" else None),
        "xticks": (_floats(x.ticks), x.ticklabels) if x.ticks is not None
        else None,
        "yticks": (_floats(y.ticks), y.ticklabels) if y.ticks is not None
        else None,
        "yinverted": y.inverted,
        "xmargin": round(x.margin, 12),
        "legend": ax.get_legend_handles_labels()[1]
        if ax.legend_fontsize is not None else None,
        "vlines": [(round(a.x, 12), a.color) for a in ax.artists
                   if isinstance(a, svg.VLine)],
        "annotations": [(a.text, _floats(a.xy)) for a in ax.artists
                        if isinstance(a, svg.Annotation)],
    }
    return out


def _render_both(spec, tmp_path, monkeypatch):
    """render_spec in each package, keeping the axes each drew on."""
    drawn = {}
    real_subplots = plt.subplots

    def mpl_subplots(*args, **kwargs):
        fig, ax = real_subplots(*args, **kwargs)
        drawn["mpl"] = (fig, ax)
        return fig, ax
    monkeypatch.setattr(ref_plot.plt, "subplots", mpl_subplots)
    monkeypatch.setattr(ref_plot.plt, "close", lambda fig: None)
    real_svg = svg.subplots

    def svg_subplots(*args, **kwargs):
        fig, ax = real_svg(*args, **kwargs)
        drawn["svg"] = (fig, ax)
        return fig, ax
    monkeypatch.setattr(port_plot.svg, "subplots", svg_subplots)
    ref_out = ref_plot.render_spec(dict(spec),
                                   output=str(tmp_path / "ref.png"))
    port_out = port_plot.render_spec(dict(spec),
                                     output=str(tmp_path / "port.png"))
    try:
        return (_mpl_drawing(drawn["mpl"][1]), _svg_drawing(drawn["svg"][1]),
                ref_out, port_out, drawn["svg"][1])
    finally:
        plt.close(drawn["mpl"][0])


@pytest.mark.parametrize("ptype", ref_plot.PLOT_TYPES)
def test_each_plot_type_draws_what_the_reference_draws(ptype, data,
                                                       tmp_path,
                                                       monkeypatch):
    spec = _specs(data)[ptype]
    want, got, ref_out, port_out, ax = _render_both(spec, tmp_path,
                                                    monkeypatch)
    assert got == want
    drawn = sum(len(got[k]) for k in ("errorbar", "plot", "bar", "barh"))
    assert drawn >= 1
    assert ref_out.endswith("ref.png") and port_out.endswith("port.svg")
    root = ET.parse(port_out).getroot()
    assert root.tag == "{http://www.w3.org/2000/svg}svg"
    marks = [e for e in root.iter() if "mark" in e.get("class", "").split()]
    assert len(marks) >= len(spec["series"])
    texts = "".join("".join(e.itertext()) for e in root.iter()
                    if e.tag.endswith("text"))
    assert spec["title"] in texts


def test_error_bars_follow_the_points(data, tmp_path):
    """Reference fault: ``_series_xy`` takes one error per record its
    filters keep, the stddev aggregates among them, so a series that
    keeps them hands matplotlib more errors than points and raises.  The
    port takes one error per plotted point."""
    spec = {"type": "line", "series": [
        {"label": "f32", "input_file": data["doc"], "regex": "s/a/",
         "params": {"dtype": "f32"}, "xfield": "n"}]}
    with pytest.raises(ValueError, match="yerr"):
        ref_plot.render_spec(dict(spec), output=str(tmp_path / "r.png"))
    plt.close("all")
    _, ax = svg.subplots()
    port_plot._draw_line(ax, spec, ".")
    (line,) = ax.lines()
    assert line.x == [256.0, 1024.0, 4096.0]
    assert line.yerr == [0.4, 0.7, 1.5]
    assert port_plot._series_xy(spec["series"][0])[2] == [0.4, 0.7, 1.5]


def test_grouped_bar_gap_draws_nothing(data, tmp_path, monkeypatch):
    """The NaN the grouped bar leaves for a category a series lacks is
    recorded as the reference's and drawn as no bar."""
    spec = _specs(data)["grouped_bar"]
    want, got, _, port_out, ax = _render_both(spec, tmp_path, monkeypatch)
    heights = [v for b in got["bar"] for v in b["values"]]
    assert None in heights                          # the gaps
    root = ET.parse(port_out).getroot()
    bars = [e for e in root.iter()
            if e.get("class") == "mark bar"]
    assert len(bars) == sum(v is not None for v in heights)
    # duplicate categories within one series get an occurrence suffix
    doc = gb_doc("r", {"s/a/n:1": 2.0, "s/a/n:2": 4.0,
                       "s/b/n:1": 3.0, "s/b/n:2": 5.0}, "2026-07-31")
    src = tmp_path / "dup.json"
    src.write_text(json.dumps(doc))
    _, ax = svg.subplots()
    port_plot._draw_grouped_bar(ax, {"series": [{"input_file": str(src),
                                                 "xfield": "n",
                                                 "yfield": "real_time"}]},
                                ".")
    assert ax.xaxis.ticklabels == ["1", "2", "1 (2)", "2 (2)"]


def test_svg_text_is_escaped_and_parses(tmp_path):
    fig, ax = svg.subplots(figsize=(4, 3))
    ax.errorbar([1, 2, 4], [1.0, float("nan"), 3.0], yerr=[0.1, 0.2, 0.0],
                marker="o", label='a<b & "c"', capsize=3)
    ax.plot([1, 4], [0.5, 0.5], "--", label="fit")
    ax.bar([0, 1], [2.0, -1.0], width=0.4, label="bars")
    ax.axvline(1.0, color="k", linewidth=1)
    ax.annotate("1.00x <", (1.0, 1.0), xytext=(3, 0),
                textcoords="offset points", va="center", fontsize=8)
    ax.set_title("t & <t>")
    ax.set_xlabel("x")
    ax.set_ylabel("y")
    ax.set_yscale("log")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=8)
    out = tmp_path / "t.svg"
    fig.savefig(str(out), dpi=100)
    root = ET.parse(str(out)).getroot()
    texts = ["".join(e.itertext()) for e in root.iter()
             if e.tag.endswith("text")]
    assert "t & <t>" in texts and 'a<b & "c"' in texts
    assert "1.00x <" in texts
    assert [e.get("data-label") for e in root.iter()
            if e.get("class") == "series"][:1] == ['a<b & "c"']
    # the NaN point breaks the line; the log axis drops the negative bar
    assert [e for e in root.iter() if e.get("class") == "mark bar"]
    assert root.get("width") == "400" and root.get("height") == "300"
    assert ax.calls[0][0] == "errorbar" and ax.calls[-1][0] == "legend"


def test_linear_and_log_ticks():
    """Ticks are round numbers inside the limits; a log axis labels its
    decades (base 2 on a log2 x axis); tiny values take a power-of-ten
    offset rather than unreadable labels."""
    ticks, offset = svg._auto_ticks(svg.Axis(), 0.0, 41.0)
    assert [v for v, _, _ in ticks] == [0, 10, 20, 30, 40] and \
        [t for _, t, _ in ticks] == ["0", "10", "20", "30", "40"] and \
        offset is None
    ticks, offset = svg._auto_ticks(svg.Axis(), 0.0, 4e-5)
    assert offset == -5 and ticks[-1][1] == "4"
    ticks, _ = svg._auto_ticks(svg.Axis(), 0.25, 1.0)
    assert [t for _, t, _ in ticks] == ["0.3", "0.4", "0.5", "0.6", "0.7",
                                        "0.8", "0.9", "1.0"] or \
        all(t.count(".") == 1 for _, t, _ in ticks)
    ticks, _ = svg._auto_ticks(svg.Axis(scale="log"), 0.001, 20.0)
    assert [(b, e) for _, b, e in ticks] == [("10", "-3"), ("10", "-2"),
                                              ("10", "-1"), ("10", "0"),
                                              ("10", "1")]
    ticks, _ = svg._auto_ticks(svg.Axis(scale="log", base=2.0), 200, 5000)
    assert [e for _, _, e in ticks] == ["8", "9", "10", "11", "12"]


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_cli_matches_reference(tmp_path, capsys, data):
    from repro.scopeplot.__main__ import main as ref_cli
    src = data["doc"]
    for argv in (["filter_name", src, "s/a"], ["cat", src, src]):
        assert port_cli(argv) == 0
        port = json.loads(capsys.readouterr().out)
        assert ref_cli(argv) == 0
        assert port == json.loads(capsys.readouterr().out)
    spec = {"title": "t", "type": "line", "output": "out.png",
            "series": [{"label": "a", "input_file": src, "regex": "s/a",
                        "xfield": "n", "yfield": "bytes_per_second"}]}
    sp = tmp_path / "spec.yaml"
    sp.write_text(yaml.safe_dump(spec))
    assert port_cli(["deps", str(sp)]) == 0
    assert capsys.readouterr().out == f"out.svg: {src}\n"
    assert port_cli(["spec", str(sp), "--output",
                     str(tmp_path / "o.png")]) == 0
    assert capsys.readouterr().out.strip() == str(tmp_path / "o.svg")
    assert (tmp_path / "o.svg").exists()
    assert port_cli(["bar", src, "--x-field", "n", "--y-field",
                     "real_time", "--output", str(tmp_path / "b.png")]) == 0
    capsys.readouterr()
    ET.parse(str(tmp_path / "b.svg"))
    (tmp_path / "bad.yaml").write_text("type: pie\nseries: []\n")
    assert port_cli(["spec", str(tmp_path / "bad.yaml")]) == 2
    assert "bad.yaml:1: unknown plot type 'pie'" in capsys.readouterr().err


#: Runs ``python -m <module> <args...>`` with matplotlib and PyYAML made
#: unimportable, as on a host that lacks both.
BLOCKED = ("import runpy, sys\n"
           "sys.modules['matplotlib'] = None\n"
           "sys.modules['yaml'] = None\n"
           "module = sys.argv[1]\n"
           "sys.argv = sys.argv[1:]\n"
           "runpy.run_module(module, run_name='__main__', alter_sys=True)\n")


def run_blocked(*args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [SRC, os.environ.get("PYTHONPATH")])))
    return subprocess.run([sys.executable, "-c", BLOCKED, *args],
                          capture_output=True, text=True, env=env, cwd=cwd,
                          timeout=300)


def test_cli_without_matplotlib_or_yaml(tmp_path, data):
    """``report`` and ``batch`` in a process that cannot import
    matplotlib or yaml: the report renders, batch finds its specs fresh
    and re-renders those whose data moved."""
    results = tmp_path / "results"
    run_dir = results / "r2"
    run_dir.mkdir(parents=True)
    docs = [gb_doc("r1", {"s/a/n:1": 2.2, "s/a/n:2": 4.0}, "2026-07-30"),
            gb_doc("r2", {"s/a/n:1": 2.0, "s/a/n:2": 4.0}, "2026-07-31")]
    for doc in docs:
        port_hist.append_run(str(results), doc)
    (run_dir / "merged.json").write_text(json.dumps(docs[1]))
    r = run_blocked("repro_torch", "report", "r2", "--results-dir",
                    str(results))
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[0].endswith("index.html")
    specs = run_dir / "report" / "specs"
    r = run_blocked("repro_torch.scopeplot", "batch", str(specs))
    assert r.returncode == 0, r.stderr
    assert r.stdout.count(": fresh -> ") == 3
    future = os.path.getmtime(run_dir / "report" / "s_times.svg") + 60
    os.utime(run_dir / "merged.json", (future, future))
    r = run_blocked("repro_torch.scopeplot", "batch", str(specs))
    assert r.returncode == 0, r.stderr
    assert sorted(line.split(": ")[1].split()[0]
                  for line in r.stdout.splitlines()) == \
        ["fresh", "rendered", "rendered"]
    r = run_blocked("repro_torch.scopeplot", "spec", "s_times.yaml",
                    cwd=str(specs))
    assert r.returncode == 0 and r.stdout.strip().endswith("s_times.svg")
    r = run_blocked("-c", "import matplotlib")
    assert r.returncode != 0


# ---------------------------------------------------------------------------
# the port imports none of repro, jax, matplotlib or yaml
# ---------------------------------------------------------------------------

FORBIDDEN = ("repro", "jax", "matplotlib", "yaml")


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""


def test_port_imports_no_reference_jax_matplotlib_or_yaml():
    found = []
    files = 0
    for dirpath, _, names in os.walk(os.path.join(SRC, "repro_torch")):
        for name in names:
            if not name.endswith(".py"):
                continue
            files += 1
            path = os.path.join(dirpath, name)
            for line, module in _imports(path):
                top = module.split(".")[0]
                if top in FORBIDDEN:
                    found.append(f"{os.path.relpath(path, SRC)}:{line} "
                                 f"{module}")
    assert files >= 80
    assert found == []
