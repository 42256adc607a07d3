"""Characterization scenario: run three scopes, merge with ScopePlot's
cat, filter/select by typed parameter, and produce comparison charts —
the paper's Fig. 1 data flow (SCOPE binary -> JSON -> ScopePlot) as a
script, on torch.

The instr scope's ops are one typed family (``instr/elementwise`` with
an ``op`` axis), so the per-op latency chart comes from a single
``group_by`` spec series instead of a regex per family clone, and the
compile-vs-steady-state split the runner measures is printed per
instance.  Plots are written as SVG.

Run:  PYTHONPATH=src python -m repro_torch.examples.characterize [--device cpu]
"""
import argparse
import os

from repro_torch.core import FLAGS, REGISTRY, RunOptions, run_benchmarks
from repro_torch.core.scope import ScopeManager
from repro_torch.examples import parse_args
from repro_torch.scopeplot import BenchmarkFile, cat
from repro_torch.scopeplot.plot import quick_bar, render_spec


def run_scope(name, device, param_filter=None):
    REGISTRY.reset()
    mgr = ScopeManager()
    mgr.load([f"repro_torch.scopes.{name}_scope"])
    mgr.register_all()
    doc = run_benchmarks(REGISTRY.filter(".*"),
                         RunOptions(min_time=0.02,
                                    param_filter=param_filter,
                                    device=device),
                         progress=False)
    return BenchmarkFile.from_dict(doc)


def main(argv=None):
    device = parse_args(argparse.ArgumentParser(), argv).device
    FLAGS.set("device", device)          # the scopes' fixtures read it
    os.makedirs("results", exist_ok=True)
    merged = cat([run_scope(n, device) for n in ("instr", "histo",
                                                 "linalg")])
    merged.save("results/characterize.json")
    print(f"{len(merged)} records from 3 scopes -> results/characterize.json")

    # typed-parameter selection on the loaded document: the same
    # axis:value components `--param op=exp` selects at run time
    fast = merged.without_errors().filter_params({"op": ["exp", "tanh"]})
    frame = fast.to_frame(["name", "real_time", "compile_time_s"])
    print(frame.sort_by("real_time").to_csv())

    # compile vs steady state, per instance (the runner's warm phase)
    for rec in merged.without_errors().without_aggregates():
        ct = rec.get("compile_time_s")
        if ct is not None:
            steady = rec.real_time_seconds() or 0.0
            print(f"{rec.name}: compile {ct * 1e3:.1f}ms, "
                  f"steady {steady * 1e6:.1f}us")

    out = quick_bar("results/characterize.json", "name", "real_time",
                    title="instr scope op latencies",
                    output="results/characterize.svg", regex="instr/")
    print("wrote", out)

    # series-by-param: ONE spec series expands into a plotted series
    # per dtype of the single linalg/batched_matmul family
    out = render_spec({
        "title": "batched matmul by dtype",
        "type": "grouped_bar",
        "output": "results/characterize_dtypes.svg",
        "x_axis": {"label": "n"},
        "y_axis": {"label": "time (us)"},
        "series": [{"input_file": "results/characterize.json",
                    "regex": "linalg/batched_matmul",
                    "group_by": "dtype", "xfield": "n"}],
    })
    print("wrote", out)


if __name__ == "__main__":
    main()
