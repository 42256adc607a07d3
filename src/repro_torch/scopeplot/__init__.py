"""repro_torch.scopeplot — the ScopePlot package (paper §V-A), the port
of ``repro.scopeplot``.

Object model + manipulation library for Google-Benchmark JSON files, plus a
CLI (``python -m repro_torch.scopeplot``) with the paper's subcommands:

  * ``spec``         — YAML-spec-driven plots (line w/ error bars, bar,
                       grouped_bar, regression, speedup, timeseries,
                       latency_cdf), written as SVG
  * ``batch``        — render a spec directory, rebuilding only stale
                       plots (paper §V-A.2 deps, applied directly)
  * ``report``       — auto-generated HTML/Markdown run report
                       (``--report`` works as an alias)
  * ``deps``         — emit make-format dependencies of a spec file
  * ``bar``          — one-shot bar plot without a spec file
  * ``cat``          — structure-preserving concatenation of JSON files
  * ``filter_name``  — keep benchmarks whose name matches a regex

Full spec-schema reference (every key, every plot type, the error
contract): ``docs/scopeplot.md``.  The port draws with the standard
library (:mod:`.svg`) and reads specs with its own reader of the YAML
subset they use (:mod:`.specyaml`): it imports neither matplotlib nor
PyYAML, so it runs on a card's host that has neither.
"""
from .model import BenchmarkFile, BenchmarkRecord, cat, filter_name, load, loads
from .frame import Frame

__all__ = [
    "BenchmarkFile", "BenchmarkRecord", "Frame",
    "cat", "filter_name", "load", "loads",
]
