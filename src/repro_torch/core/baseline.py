"""Baseline storage + regression comparison (GB ``tools/compare.py`` analogue).

A copy of ``repro.core.baseline``: the same statistics, verdicts and
exit codes, so ``python -m repro_torch compare`` and ``python -m repro
compare`` judge any pair of documents alike, whichever package wrote
them.  It compares two Google-Benchmark JSON documents (a run's
document or the orchestrator's merged shard document — same schema)
and produces per-benchmark verdicts:

  * times are normalized to seconds across time units;
  * repetitions are pooled per ``run_name``: a change is *significant*
    only if the mean shift clears ``sigmas`` pooled standard deviations
    (when repetition data exists) AND the relative change clears
    ``threshold`` — a plain ratio test on noisy single-shot numbers flags
    phantom regressions, which is why GB's compare tool uses U-tests;
  * benchmarks present on only one side are reported as added/removed,
    errored records as errors — never silently dropped.

CLI: ``python -m repro_torch compare BASELINE.json CONTENDER.json``
(also accepts ``results/<run-id>`` directories and a ``history.jsonl``
windowed baseline); exits 1 when the gate fails, 2 when a document
cannot be read.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .logging import get_logger

log = get_logger("baseline")

_TIME_SCALE = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}

# verdict values
REGRESSION = "regression"
IMPROVEMENT = "improvement"
SIMILAR = "similar"
ADDED = "added"
REMOVED = "removed"
ERRORS = "errors"


@dataclass
class Stats:
    """Pooled repetition statistics for one benchmark run_name.

    Iteration records are the primary source (``times``).  A document
    reduced by ``--aggregates-only`` carries no iteration records, so
    its mean/stddev/repetitions aggregates are kept as a fallback —
    the statistics survive even though the raw repetitions don't.
    """

    times: List[float] = field(default_factory=list)   # seconds
    errors: int = 0
    agg_mean: Optional[float] = None     # seconds, from the aggregates
    agg_stddev: Optional[float] = None
    agg_n: Optional[int] = None

    @property
    def has_times(self) -> bool:
        """True when any timing statistic exists (raw or aggregate)."""
        return bool(self.times) or self.agg_mean is not None

    @property
    def n(self) -> int:
        if self.times:
            return len(self.times)
        return self.agg_n or 0

    @property
    def mean(self) -> float:
        if self.times:
            return statistics.fmean(self.times)
        return self.agg_mean if self.agg_mean is not None else float("nan")

    @property
    def stddev(self) -> float:
        if self.times:
            return statistics.stdev(self.times) if len(self.times) > 1 \
                else 0.0
        return self.agg_stddev or 0.0


@dataclass
class Comparison:
    name: str
    verdict: str
    base_time: Optional[float] = None     # seconds
    new_time: Optional[float] = None
    ratio: Optional[float] = None         # new/base
    significant: bool = False
    note: str = ""


def collect_stats(doc: Dict[str, Any]) -> Dict[str, Stats]:
    """Pool iteration records by ``run_name``.

    Aggregate records are never pooled into ``times`` (that would
    double-count repetitions) but their mean/stddev are kept as the
    fallback statistics for names whose iteration records were dropped
    by ``--aggregates-only``.
    """
    out: Dict[str, Stats] = {}
    for rec in doc.get("benchmarks", []):
        name = rec.get("run_name") or rec.get("name", "")
        st = out.setdefault(name, Stats())
        scale = _TIME_SCALE.get(rec.get("time_unit", "ns"), 1.0)
        if rec.get("run_type") == "aggregate":
            t = rec.get("real_time")
            if t is not None:
                if rec.get("aggregate_name") == "mean":
                    st.agg_mean = t * scale
                elif rec.get("aggregate_name") == "stddev":
                    st.agg_stddev = t * scale
            if rec.get("repetitions"):
                st.agg_n = int(rec["repetitions"])
            continue
        if rec.get("error_occurred") or rec.get("skipped"):
            st.errors += 1
            continue
        t = rec.get("real_time")
        if t is None:
            continue
        st.times.append(t * scale)
    return out


def compare_documents(base: Dict[str, Any], new: Dict[str, Any],
                      threshold: float = 0.10, sigmas: float = 2.0
                      ) -> List[Comparison]:
    """Diff ``new`` against ``base``; returns one Comparison per name."""
    a, b = collect_stats(base), collect_stats(new)
    out: List[Comparison] = []
    for name in sorted(set(a) | set(b)):
        sa, sb = a.get(name), b.get(name)
        if sa is None:
            out.append(Comparison(name, ADDED,
                                  new_time=sb.mean if sb.has_times else None))
            continue
        if sb is None:
            out.append(Comparison(name, REMOVED,
                                  base_time=sa.mean if sa.has_times else None))
            continue
        if not sa.has_times or not sb.has_times:
            which = []
            if not sa.has_times:
                which.append("baseline")
            if not sb.has_times:
                which.append("contender")
            out.append(Comparison(name, ERRORS,
                                  note=f"errored in {'+'.join(which)}"))
            continue
        ma, mb = sa.mean, sb.mean
        ratio = mb / ma if ma > 0 else float("inf")
        rel = (mb - ma) / ma if ma > 0 else float("inf")
        # stddev gate: with repetition data on both sides, require the
        # mean shift to clear `sigmas` pooled standard deviations
        pooled = math.sqrt(sa.stddev ** 2 + sb.stddev ** 2)
        if sa.n > 1 and sb.n > 1 and pooled > 0:
            significant = abs(mb - ma) > sigmas * pooled
        else:
            significant = True          # no noise estimate: ratio decides
        verdict = SIMILAR
        if significant and rel > threshold:
            verdict = REGRESSION
        elif significant and rel < -threshold:
            verdict = IMPROVEMENT
        out.append(Comparison(name, verdict, base_time=ma, new_time=mb,
                              ratio=ratio, significant=significant))
    return out


def summarize(comparisons: List[Comparison]) -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for c in comparisons:
        counts[c.verdict] = counts.get(c.verdict, 0) + 1
    return counts


def gate_failures(comparisons: List[Comparison]) -> List[Comparison]:
    """Comparisons that must fail a CI gate.

    Regressions, plus benchmarks that were *healthy in the baseline* but
    are missing or errored in the contender — a scope that crashes
    outright produces no contender records, and that must not read as a
    green run.  Benchmarks already broken in the baseline don't count.
    """
    bad = []
    for c in comparisons:
        if c.verdict == REGRESSION:
            bad.append(c)
        elif c.verdict == REMOVED and c.base_time is not None:
            bad.append(c)
        elif c.verdict == ERRORS and c.note == "errored in contender":
            bad.append(c)
    return bad


def _fmt_time(t: Optional[float]) -> str:
    if t is None or math.isnan(t):
        return "-"
    for unit, scale in (("s", 1.0), ("ms", 1e-3), ("us", 1e-6)):
        if t >= scale:
            return f"{t / scale:.2f}{unit}"
    return f"{t / 1e-9:.0f}ns"


def format_comparisons(comparisons: List[Comparison]) -> str:
    width = max([len(c.name) for c in comparisons] + [9])
    lines = [f"{'benchmark':<{width}}  {'base':>9}  {'new':>9}  "
             f"{'ratio':>6}  verdict"]
    for c in comparisons:
        ratio = f"{c.ratio:.2f}x" if c.ratio is not None else "-"
        verdict = c.verdict.upper() if c.verdict in (REGRESSION,
                                                     IMPROVEMENT) \
            else c.verdict
        note = f"  ({c.note})" if c.note else ""
        lines.append(f"{c.name:<{width}}  {_fmt_time(c.base_time):>9}  "
                     f"{_fmt_time(c.new_time):>9}  {ratio:>6}  "
                     f"{verdict}{note}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# document I/O
# ---------------------------------------------------------------------------

def run_dir_shard_files(path: str) -> List[str]:
    """Shard files of a run directory, in merge order.

    Instance shards (``shards/*.json``, benchmark-grained runs) come
    first, ordered by ``manifest.json``'s plan order when it exists so an
    interrupted run reads back in the same benchmark order its
    ``merged.json`` would have had; scope-grained shards at the top level
    follow, sorted by name.
    """
    out: List[str] = []
    sub = os.path.join(path, "shards")
    if os.path.isdir(sub):
        names = sorted(f for f in os.listdir(sub) if f.endswith(".json"))
        mf = os.path.join(path, "manifest.json")
        if os.path.exists(mf):
            try:
                with open(mf) as f:
                    manifest = json.load(f)
                planned = [os.path.basename(e.get("shard", ""))
                           for e in manifest.get("items", [])]
                have = set(names)
                ordered = [n for n in planned if n in have]
                names = ordered + [n for n in names if n not in set(planned)]
            except (OSError, json.JSONDecodeError):
                pass
        out.extend(os.path.join(sub, n) for n in names)
    out.extend(os.path.join(path, f) for f in sorted(os.listdir(path))
               if f.endswith(".json")
               and f not in ("merged.json", "manifest.json"))
    return out


def load_document(path: str) -> Dict[str, Any]:
    """Load a GB-JSON document; a ``results/<run-id>`` directory works too
    — its ``merged.json`` when present, else the concatenation of its
    shards (a run interrupted before the merge still compares).  Both
    scope-grained (``<scope>.json``) and benchmark-grained
    (``shards/<instance>.json`` + ``manifest.json``) run directories read
    back through the same merged, schema-identical document.

    A ``*.jsonl`` path is read as a run-history file
    (:mod:`repro_torch.core.history`): the last
    :data:`~repro_torch.core.history.DEFAULT_WINDOW` runs of every benchmark
    fold into one synthetic document whose repetitions are the per-run
    means — so ``--baseline results/history.jsonl`` gates against the
    *windowed* history, catching slow drifts that each single-run diff
    called similar.  The port has no store index yet, so the history is
    always scanned directly."""
    if path.endswith(".jsonl"):
        from .history import window_document
        return window_document(path)
    if os.path.isdir(path):
        merged = os.path.join(path, "merged.json")
        if os.path.exists(merged):
            path = merged
        else:
            shards = run_dir_shard_files(path)
            if not shards:
                raise FileNotFoundError(f"no result JSON in {path}")
            doc: Dict[str, Any] = {"context": {}, "benchmarks": []}
            for shard_path in shards:
                with open(shard_path) as f:
                    shard = json.load(f)
                doc["context"] = doc["context"] or shard.get("context", {})
                doc["benchmarks"].extend(shard.get("benchmarks", []))
            return doc
    with open(path) as f:
        return json.load(f)


def filter_doc_params(doc: Dict[str, Any],
                      param_filter: Optional[Dict[str, List[str]]]
                      ) -> Dict[str, Any]:
    """Keep only records whose name carries matching ``axis:value``
    components (the ``--param`` selection applied to a document where
    only names survive)."""
    if not param_filter:
        return doc
    from .benchmark import match_params, name_params
    return {
        "context": doc.get("context", {}),
        "benchmarks": [
            rec for rec in doc.get("benchmarks", [])
            if match_params(
                name_params(rec.get("run_name") or rec.get("name", "")),
                param_filter)
        ],
    }


def save_baseline(doc: Dict[str, Any], path: str) -> None:
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
    log.info("saved baseline %s (%d records)", path,
             len(doc.get("benchmarks", [])))


# ---------------------------------------------------------------------------
# CLI (python -m repro_torch compare)
# ---------------------------------------------------------------------------

def build_compare_parser() -> argparse.ArgumentParser:
    from .cli_examples import epilog
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch compare",
        description="Compare two benchmark result documents "
                    "(JSON file, results/<run-id> directory, or a "
                    "history.jsonl windowed baseline)",
        epilog=epilog("compare"),
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("baseline", help="baseline JSON file, run directory, "
                                     "or history.jsonl")
    ap.add_argument("contender", help="contender JSON file or run directory")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="relative change needed to flag (default 0.10)")
    ap.add_argument("--sigmas", type=float, default=2.0,
                    help="pooled-stddev multiple the mean shift must clear "
                         "when repetition data exists (default 2.0)")
    ap.add_argument("--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="compare only instances whose name carries the "
                         "typed parameter KEY:VALUE (repeatable)")
    return ap


def compare_main(argv: Optional[List[str]] = None) -> int:
    from .benchmark import parse_param_filter
    ns = build_compare_parser().parse_args(argv)
    try:
        param_filter = parse_param_filter(ns.param)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        base = filter_doc_params(load_document(ns.baseline), param_filter)
        new = filter_doc_params(load_document(ns.contender), param_filter)
    except (OSError, json.JSONDecodeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    comps = compare_documents(base, new,
                              threshold=ns.threshold, sigmas=ns.sigmas)
    if not comps:
        print("no benchmarks to compare")
        return 0
    print(format_comparisons(comps))
    counts = summarize(comps)
    print()
    print("summary:", ", ".join(f"{v} {k}" for k, v in sorted(counts.items())))
    bad = gate_failures(comps)
    if bad:
        print(f"gate: {len(bad)} failure(s) — "
              + ", ".join(f"{c.name} [{c.verdict}]" for c in bad[:10]))
    return 1 if bad else 0
