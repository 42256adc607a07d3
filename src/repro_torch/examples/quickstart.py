"""Quickstart: the SCOPE workflow end-to-end in one minute, on torch.

1. register a custom benchmark through the core library (the Example|Scope
   integration surface): a torch layer norm whose body delivers its
   output, so the wall meter fences the card before the clock stops;
2. run it through the SCOPE runner → Google-Benchmark JSON;
3. manipulate + plot the results with ScopePlot (SVG).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
import argparse
import os

import torch

from repro_torch.core import (REGISTRY, RunOptions, State, benchmark,
                              run_benchmarks, write_json)
from repro_torch.examples import parse_args
from repro_torch.scopeplot import BenchmarkFile
from repro_torch.scopeplot.plot import render_spec


def main(argv=None):
    device = parse_args(argparse.ArgumentParser(), argv).device

    # -- 1. register ----------------------------------------------------
    @benchmark(scope="quickstart")
    def layer_norm(state: State):
        """Bench a layer norm across row counts."""
        n = state.range(0)
        x = torch.ones((n, 512), device=device)
        while state.keep_running():
            state.deliver((x - x.mean(-1, keepdim=True))
                          / (x.std(-1, keepdim=True) + 1e-6))
        state.set_bytes_processed(2 * 4 * n * 512)
    layer_norm.range_multiplier_args(64, 4096, mult=4).set_arg_names(["rows"])

    # -- 2. run -----------------------------------------------------------
    doc = run_benchmarks(REGISTRY.filter("quickstart"),
                         RunOptions(min_time=0.02, device=device))
    os.makedirs("results", exist_ok=True)
    write_json(doc, "results/quickstart.json")

    # -- 3. analyze + plot ------------------------------------------------
    bf = BenchmarkFile.from_dict(doc).without_errors()
    print("\nname,us,GB/s")
    for rec in bf:
        if rec.get("run_type") == "iteration":
            print(f"{rec.name},{rec.real_time:.2f},"
                  f"{rec.get('bytes_per_second', 0) / 1e9:.2f}")
    out = render_spec({
        "title": "layer_norm throughput",
        "type": "line",
        "output": "results/quickstart.svg",
        "x_axis": {"label": "rows", "scale": "log"},
        "y_axis": {"label": "GB/s"},
        "series": [{"label": "layer_norm",
                    "input_file": "results/quickstart.json",
                    "regex": "quickstart/layer_norm", "xfield": "rows",
                    "yfield": "bytes_per_second", "yscale": 1e-9}],
    })
    print(f"\nwrote {out}")


if __name__ == "__main__":
    main()
