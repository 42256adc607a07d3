"""``python -m repro_torch query`` and ``python -m repro_torch store``
entry points (a copy of ``repro.store.cli``).

``query`` filters and aggregates the run history; ``store`` manages the
SQLite index over it (``index``/``ingest``/``status``).  Query output is
independent of whether the index is used: ``--no-store`` (or a missing
index) changes cost, never answers — tests assert byte-equivalence.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import List

from repro_torch.core.benchmark import parse_param_filter
from repro_torch.core.cli_examples import epilog
from repro_torch.core.history import HISTORY_FILE
from repro_torch.core.logging import get_logger

from . import index as store_index
from .ingest import ingest_shards
from .query import (DEFAULT_PERCENTILES, QueryFilter, aggregate_records,
                    parse_percentiles, run_query)

log = get_logger("store")


def _history_path(ns: argparse.Namespace) -> str:
    if ns.history:
        return ns.history
    return os.path.join(ns.results_dir, HISTORY_FILE)


def _add_source_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--results-dir", default="results",
                    help="results directory holding history.jsonl and "
                         "its history.db index (default: results)")
    ap.add_argument("--history", default=None, metavar="PATH",
                    help="query this history JSONL instead of "
                         "<results-dir>/history.jsonl")


def build_query_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch query",
                                 epilog=epilog("query"),
                                 formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    _add_source_args(ap)
    ap.add_argument("--scope", default=None,
                    help="only records of this scope")
    ap.add_argument("--family", default=None,
                    help="only records of this benchmark family "
                         "(e.g. mxu/matmul)")
    ap.add_argument("--name", default=None,
                    help="only records with this exact instance name")
    ap.add_argument("--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="only instances whose typed parameter KEY "
                         "equals VALUE (repeatable; same KEY twice ORs, "
                         "distinct KEYs AND)")
    ap.add_argument("--sysinfo", default=None, metavar="DIGEST",
                    help="only records from this sysinfo digest "
                         "(one machine/software configuration)")
    ap.add_argument("--tag", default=None,
                    help="only records with this tag ('' for untagged)")
    ap.add_argument("--run-id", default=None,
                    help="only records of this run")
    ap.add_argument("--fingerprint", default=None, metavar="DIGEST",
                    help="only records carrying this instance "
                         "fingerprint (repro_torch.core.fingerprint)")
    ap.add_argument("--since", default=None, metavar="ISO",
                    help="only records at/after this ISO timestamp "
                         "prefix (e.g. 2026-08-01)")
    ap.add_argument("--until", default=None, metavar="ISO",
                    help="only records at/before this ISO timestamp "
                         "prefix (inclusive: 2026-08-01 keeps the whole "
                         "day)")
    ap.add_argument("--aggregate", action="store_true",
                    help="fold matches into per-instance statistics "
                         "(mean/stddev/min/max/percentiles over run "
                         "means and every numeric counter) instead of "
                         "listing records")
    ap.add_argument("--percentiles", default=",".join(DEFAULT_PERCENTILES),
                    metavar="LIST",
                    help="percentiles --aggregate reports, P² streaming "
                         "estimates (default: %(default)s; p999 = 0.999)")
    ap.add_argument("--format", default="table",
                    choices=["table", "json", "jsonl"],
                    help="output format (jsonl prints matching history "
                         "lines verbatim; default: table)")
    ap.add_argument("--no-store", action="store_true",
                    help="force a direct JSONL scan, ignoring any index "
                         "(same output, different cost)")
    return ap


def _short(s: str, width: int) -> str:
    return s if len(s) <= width else s[:width - 1] + "…"


def _print_records_table(rows: List[tuple]) -> None:
    recs = [rec for _raw, rec in rows]
    width = max([len(r.get("name", "")) for r in recs] + [8])
    print(f"{'instance':<{width}}  {'mean_s':>12}  {'stddev_s':>10}  "
          f"{'n':>5}  {'err':>3}  {'verdict':<8}  {'run':<19}  tag")
    for r in recs:
        mean = r.get("mean_s")
        std = r.get("stddev_s")
        print(f"{r.get('name', ''):<{width}}  "
              f"{mean if mean is not None else float('nan'):>12.6g}  "
              f"{std if std is not None else float('nan'):>10.4g}  "
              f"{r.get('n') or 0:>5d}  {r.get('errors') or 0:>3d}  "
              f"{_short(r.get('verdict') or '-', 8):<8}  "
              f"{_short(r.get('run_id', ''), 19):<19}  "
              f"{r.get('tag') or ''}")
    print(f"\n{len(recs)} record(s)")


def _print_aggregate_table(aggs, labels: List[str]) -> None:
    width = max([len(a.name) for a in aggs] + [8])
    cols = ["mean", "stddev"] + labels
    header = f"{'instance':<{width}}  {'recs':>5}  {'runs':>5}  {'err':>4}"
    for c in cols:
        header += f"  {c:>11}"
    print(header)
    for a in aggs:
        st = a.mean_s.result() if a.mean_s and a.mean_s.n else {}
        line = (f"{a.name:<{width}}  {a.records:>5d}  {a.runs:>5d}  "
                f"{a.errors:>4d}")
        for c in cols:
            v = st.get(c)
            line += f"  {v:>11.6g}" if v is not None else f"  {'-':>11}"
        print(line)
    print(f"\n{len(aggs)} instance(s)")


def query_main(argv: List[str]) -> int:
    ap = build_query_parser()
    ns = ap.parse_args(argv)

    try:
        params = parse_param_filter(ns.param)
        quantiles = parse_percentiles(ns.percentiles)
    except ValueError as e:
        log.error("%s", e)
        return 2

    history = _history_path(ns)
    if not os.path.exists(history):
        log.error("no history at %s (run something first, or point "
                  "--results-dir/--history at it)", history)
        return 1

    flt = QueryFilter(scope=ns.scope, family=ns.family, name=ns.name,
                      params=params or None, sysinfo=ns.sysinfo,
                      tag=ns.tag, run_id=ns.run_id, since=ns.since,
                      until=ns.until, fingerprint=ns.fingerprint)
    rows = run_query(history, flt,
                     use_store="never" if ns.no_store else "auto")

    if ns.aggregate:
        aggs = aggregate_records(rows, quantiles)
        if ns.format == "table":
            if not aggs:
                print(f"0 instance(s) match {flt.describe()}")
                return 0
            _print_aggregate_table(aggs, [lb for lb, _ in quantiles])
        else:
            doc = {"filter": flt.describe(),
                   "instances": [a.to_json() for a in aggs],
                   "records": sum(a.records for a in aggs)}
            if ns.format == "json":
                print(json.dumps(doc, indent=2, sort_keys=True))
            else:                           # jsonl: one instance per line
                for a in aggs:
                    print(json.dumps(a.to_json(), sort_keys=True))
        return 0

    if ns.format == "jsonl":
        # verbatim history lines — byte-equivalent across both paths
        for raw, _rec in rows:
            print(raw)
        return 0
    collected = list(rows)
    if ns.format == "json":
        print(json.dumps([rec for _raw, rec in collected], indent=2))
        return 0
    if not collected:
        print(f"0 record(s) match {flt.describe()}")
        return 0
    _print_records_table(collected)
    return 0


def build_store_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch store",
                                 epilog=epilog("store"),
                                 formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="command", metavar="COMMAND")

    idx = sub.add_parser("index",
                         help="build/refresh the SQLite index over "
                              "history.jsonl (incremental: only bytes "
                              "past the watermark are read)")
    _add_source_args(idx)
    idx.add_argument("--rebuild", action="store_true",
                     help="drop the index and re-read the whole JSONL "
                          "(the result is byte-deterministic)")

    ing = sub.add_parser("ingest",
                         help="merge history shards from other machines "
                              "into this store, deduplicating whole "
                              "runs by (run-id, sysinfo digest)")
    _add_source_args(ing)
    ing.add_argument("shards", nargs="+", metavar="SHARD.jsonl",
                     help="history JSONL files to merge in")

    st = sub.add_parser("status",
                        help="index freshness, watermark and table "
                             "counts")
    _add_source_args(st)
    st.add_argument("--format", default="table",
                    choices=["table", "json"])
    st.add_argument("--coverage", action="store_true",
                    help="also load the benchmark scopes and report "
                         "per-scope fingerprint coverage: instances "
                         "whose latest record is fresh (current "
                         "fingerprint), stale (code/params/tuned/stack "
                         "changed since) or never-run on this machine")
    st.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="with --coverage, count the instances a run on "
                         "this device registers and fingerprints, as "
                         "run's --device does (default: cuda)")
    return ap


def store_main(argv: List[str]) -> int:
    ap = build_store_parser()
    ns = ap.parse_args(argv)
    if not ns.command:
        ap.print_help()
        return 2
    history = _history_path(ns)

    if ns.command == "index":
        if not os.path.exists(history):
            log.error("no history at %s; nothing to index", history)
            return 1
        stats = (store_index.rebuild(history) if ns.rebuild
                 else store_index.refresh(history))
        print(f"{'rebuilt' if stats.rebuilt else 'refreshed'} "
              f"{stats.db_file}: +{stats.indexed} record(s), "
              f"{stats.total} total, watermark {stats.watermark}/"
              f"{stats.size} bytes"
              + (f", {stats.skipped} garbage line(s) skipped"
                 if stats.skipped else ""))
        if not stats.usable:
            log.warning("unindexed parseable tail (%d byte(s)); queries "
                        "will scan the JSONL until the writer finishes",
                        stats.pending)
        return 0

    if ns.command == "ingest":
        missing = [s for s in ns.shards if not os.path.exists(s)]
        if missing:
            log.error("shard(s) not found: %s", ", ".join(missing))
            return 1
        results_dir = (os.path.dirname(os.path.abspath(history))
                       if ns.history else ns.results_dir)
        stats = ingest_shards(results_dir, ns.shards,
                              history_file=history)
        print(stats.summary())
        return 0

    # status
    info = store_index.store_status(history)
    if ns.coverage:
        info["coverage"] = _coverage_info(history, ns.device)
    if ns.format == "json":
        print(json.dumps(info, indent=2, sort_keys=True))
        return 0
    for key in ("history", "history_bytes", "db", "exists", "fresh",
                "watermark", "schema_version", "records", "runs",
                "counters", "machines", "fingerprints"):
        if key in info:
            print(f"{key:15s} {info[key]}")
    if "coverage" in info:
        print()
        print(format_coverage(info["coverage"]))
    return 0


def _coverage_info(history: str, device: str = "cuda") -> dict:
    """Fingerprint coverage vs the registered benchmark suite on
    ``device``.

    Loads the scope modules (the heavy part — torch), so it only runs
    behind ``--coverage``; any load/fingerprint failure degrades to an
    ``error`` field rather than breaking plain status output.
    """
    from repro_torch.core.fingerprint import coverage, registered_benches
    from repro_torch.core.history import load_history
    try:
        benches = registered_benches(device=device)
        records = load_history(history) if os.path.exists(history) else []
        return coverage(benches, records, device=device)
    except Exception as e:  # noqa: BLE001 - diagnostics, not a gate
        return {"error": f"{type(e).__name__}: {e}"}


def format_coverage(cov: dict) -> str:
    """Render one coverage dict as the status table section."""
    if "error" in cov:
        return f"coverage unavailable: {cov['error']}"
    lines = [f"coverage (sysinfo {cov.get('sysinfo') or '-'}):",
             f"{'scope':<16}  {'fresh':>6}  {'stale':>6}  {'never':>6}"]
    for scope in sorted(cov.get("scopes", {})):
        row = cov["scopes"][scope]
        lines.append(f"{scope:<16}  {row['fresh']:>6d}  "
                     f"{row['stale']:>6d}  {row['never']:>6d}")
    t = cov.get("totals", {})
    lines.append(f"{'total':<16}  {t.get('fresh', 0):>6d}  "
                 f"{t.get('stale', 0):>6d}  {t.get('never', 0):>6d}")
    return "\n".join(lines)
