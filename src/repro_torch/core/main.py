"""The SCOPE binary entry point on PyTorch and CUDA
(``python -m repro_torch``).

The port of ``repro.core.main``::

    python -m repro_torch [run] [flags...]       # run benchmarks (default)
    python -m repro_torch plan [flags...]        # print the work plan + costs
    python -m repro_torch ci [flags...]          # incremental run + drift gate
    python -m repro_torch lint [flags...]        # static-analyze the families
    python -m repro_torch tune <family> [...]    # autotune a kernel's tiles
    python -m repro_torch compare A.json B.json  # diff two result documents
    python -m repro_torch report <run-id>        # HTML/Markdown run report
    python -m repro_torch query [filters...]     # filter/aggregate run history
    python -m repro_torch store <index|ingest|status>  # the result store

Startup follows the reference's run stage:

  1. load scopes (imports, flag declaration)
  2. run pre-parse init hooks
  3. parse CLI (core flags + every scope's declared flags)
  4. run post-parse init hooks
  5. enable/disable scopes, register their benchmarks
  6. build the work plan and hand it to the run orchestrator
     (:mod:`repro_torch.core.orchestrate`: ``--jobs N`` parallelizes
     across failure-isolated workers, ``--shard-grain benchmark``
     schedules instances, ``--resume <run-id>`` completes an interrupted
     run) on ``--device`` (default ``cuda``; with no CUDA device the run
     exits 2 rather than carry on on the CPU), write the merged GB-JSON
     document and, unless ``--results-dir ''``, persist the run under
     ``<results-dir>/<run-id>/`` and append it to
     ``<results-dir>/history.jsonl``
  7. optionally diff against / store a baseline
     (:mod:`repro_torch.core.baseline`)

Every run stamps the instances' fingerprints
(:mod:`repro_torch.core.fingerprint`) on its context, so history
records carry them, and ``--since`` turns a run into a delta run.
``report`` renders a run's (or the history's, or a tune's) static
report through :mod:`repro_torch.scopeplot.report`, drawn as SVG with
the standard library.  ``lint`` (and ``run --lint [--strict]``, its
pre-flight) analyzes the families through
:mod:`repro_torch.core.lint` without running a body.  Documents of
either package are read by either package's ``compare``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

from . import logging as scope_logging
from .baseline import (compare_documents, compare_main, format_comparisons,
                       gate_failures, load_document, save_baseline,
                       summarize)
from .benchmark import match_params, parse_param_filter
from .cli_examples import epilog
from .flags import FLAGS
from .hooks import HOOKS
from .measure import parse_meters
from .orchestrate import OrchestratorOptions, execute
from .plan import build_plan, load_cost_hints, scope_worklist
from .registry import REGISTRY
from .runner import RunOptions, write_json
from .scope import ScopeManager

log = scope_logging.get_logger("main")

#: Subcommands of ``python -m repro`` that later slices port (none
#: left).
NOT_YET_PORTED_COMMANDS: Tuple[str, ...] = ()
#: ``run`` flags of the reference that later slices port (none left).
NOT_YET_PORTED_FLAGS: Tuple[str, ...] = ()

_OVERVIEW = """\
usage: python -m repro_torch [COMMAND] [flags...]

The SCOPE binary on PyTorch and CUDA: run benchmark scopes on the card
(--device cuda, the default) or on the CPU (--device cpu), plan and
schedule the work, and compare results.

commands:
  run       run benchmarks (the default when COMMAND is omitted)
  plan      print the work plan with predicted costs and worker bins
  ci        continuous-benchmarking entrypoint: delta-plan against the
            run history (only fingerprint-stale instances re-measure),
            run, gate against windowed drift, report — exit 1 on
            regression
  lint      static-analyze benchmark families for measurement-corrupting
            bugs (nothing runs, nothing is timed)
  tune      search a tunable family's kernel tile space and write the
            winner as the kernel's tuned.json default for that card
  compare   mean/stddev-aware diff of two result documents (either
            package's)
  report    static HTML/Markdown report for a run, the run history or a
            tune run (plots as SVG; --serve: the live dashboard)
  query     filter/aggregate the run history (store-indexed when
            history.db exists; output equals a direct JSONL scan)
  store     manage the SQLite result store: index (incremental),
            ingest (merge fleet shards), status (--coverage: fingerprint
            freshness)

`python -m repro_torch COMMAND --help` shows each command's flags and
examples.
"""


def main(argv: Optional[List[str]] = None,
         scope_modules: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_OVERVIEW)
        print(epilog("run"))
        return 0
    if argv and argv[0] in NOT_YET_PORTED_COMMANDS:
        log.error("%s is not yet ported to repro_torch", argv[0])
        return 2
    if argv and argv[0] == "compare":
        return compare_main(argv[1:])
    if argv and argv[0] == "report":
        from ..scopeplot.report import report_main
        return report_main(argv[1:])
    if argv and argv[0] == "query":
        from ..store.cli import query_main
        return query_main(argv[1:])
    if argv and argv[0] == "store":
        from ..store.cli import store_main
        return store_main(argv[1:])
    if argv and argv[0] == "plan":
        return plan_main(argv[1:], scope_modules)
    if argv and argv[0] == "ci":
        from .ci import ci_main
        return ci_main(argv[1:], scope_modules)
    if argv and argv[0] == "lint":
        from .lint import lint_main
        return lint_main(argv[1:], scope_modules)
    if argv and argv[0] == "tune":
        from .tune import tune_main
        return tune_main(argv[1:], scope_modules)
    if argv and argv[0] == "run":
        argv = argv[1:]
    return run_main(argv, scope_modules)


def _setup_scopes(scope_modules: Optional[List[str]],
                  enable: Optional[List[str]], disable: List[str],
                  rest: List[str]) -> Tuple[Optional[ScopeManager], int]:
    """Steps 1–5 of the startup sequence, shared by run and plan."""
    mgr = ScopeManager()
    mgr.load(scope_modules)

    rc = HOOKS.run_pre_parse()
    if rc is not None:
        return None, rc

    FLAGS.parse(rest)
    scope_logging.set_level(FLAGS.get("log_level", "INFO"))

    rc = HOOKS.run_post_parse()
    if rc is not None:
        return None, rc

    mgr.configure(enable=enable, disable=disable)
    return mgr, 0


def _no_card_for(device: str) -> bool:
    """Log and return True when a run sent to ``cuda`` finds no card: it
    never carries on on the CPU."""
    if device != "cuda":
        return False
    import torch
    if torch.cuda.is_available():
        return False
    log.error("no CUDA device is available: the scopes run on the card; "
              "pass --device cpu to run them on the CPU")
    return True


def _refuse_unported(argv: List[str]) -> bool:
    """Log and return True when ``argv`` holds a flag not ported yet."""
    refused = sorted({a.split("=", 1)[0] for a in argv
                      if a.split("=", 1)[0] in NOT_YET_PORTED_FLAGS})
    if refused:
        log.error("%s: not yet ported to repro_torch", ", ".join(refused))
    return bool(refused)


def build_run_parser() -> argparse.ArgumentParser:
    """Core run options (scope flags are parsed separately via FLAGS)."""
    sel = argparse.ArgumentParser(prog="python -m repro_torch run",
                                  add_help=False, epilog=epilog("run"),
                                  formatter_class=
                                  argparse.RawDescriptionHelpFormatter)
    sel.add_argument("--enable-scope", action="append", default=None,
                     help="enable ONLY these scopes (repeatable)")
    sel.add_argument("--disable-scope", action="append", default=[],
                     help="disable these scopes (repeatable)")
    sel.add_argument("--list-scopes", action="store_true")
    sel.add_argument("--param", action="append", default=[],
                     metavar="KEY=VALUE",
                     help="run only instances whose typed parameter KEY "
                          "equals VALUE (repeatable; same KEY twice ORs "
                          "the values, distinct KEYs AND together — e.g. "
                          "--param dtype=bf16 --param backend=cuda)")
    sel.add_argument("--meters", default=None, metavar="LIST",
                     help="comma-separated measurement meters driven "
                          "around every batch (available: wall, cpu, "
                          "costmodel, latency; default wall,cpu).  wall "
                          "and cpu are always included — they are the "
                          "record's time sources; costmodel adds "
                          "flops/bytes_accessed counters from one call of "
                          "the fixture's callable; latency consumes "
                          "per-request samples (state.observe) and adds "
                          "tail-percentile/goodput counters")
    sel.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                     help="latency objective in milliseconds for the "
                          "latency meter: goodput_rps counts only "
                          "requests completing within the SLO and "
                          "slo_attainment reports the fraction that did "
                          "(default: no SLO — every completed request "
                          "counts toward goodput)")
    sel.add_argument("--aggregates-only", action="store_true",
                     help="with --benchmark_repetitions > 1, report only "
                          "the mean/median/stddev aggregate records "
                          "(throughput, compile time and meter counters "
                          "are carried onto them)")
    sel.add_argument("--lint", action="store_true",
                     help="static-analyze the selected families before "
                          "running (python -m repro_torch lint): "
                          "error-severity findings abort the run before "
                          "anything is timed")
    sel.add_argument("--strict", action="store_true",
                     help="with --lint, abort on warning-severity "
                          "findings too")
    sel.add_argument("--jobs", type=int, default=1,
                     help="run work in N parallel isolated workers (on "
                          "the card they share it, and their times "
                          "contend)")
    sel.add_argument("--isolate", default="auto",
                     choices=["auto", "inline", "pool", "subprocess"],
                     help="worker isolation (auto: inline when --jobs 1; "
                          "at benchmark grain, pool and subprocess both "
                          "run one batch interpreter per worker bin)")
    sel.add_argument("--shard-grain", default="auto",
                     choices=["auto", "benchmark", "scope"],
                     help="schedulable unit (auto: benchmark when "
                          "--jobs > 1 or resuming, scope otherwise)")
    sel.add_argument("--results-dir", default="results",
                     help="persist shards + manifest.json + merged.json "
                          "under <dir>/<run-id>/ and append the run to "
                          "<dir>/history.jsonl (default: results; pass "
                          "an empty string to keep the run ephemeral)")
    sel.add_argument("--run-id", default=None,
                     help="run directory name (default: timestamp)")
    sel.add_argument("--resume", default=None, metavar="RUN_ID",
                     help="re-open <results-dir>/<RUN_ID> and run only the "
                          "instances whose shard is missing or failed")
    sel.add_argument("--costs", default=None, metavar="PATH",
                     help="prior run directory or GB-JSON document used as "
                          "per-instance cost hints for LPT scheduling")
    sel.add_argument("--since", nargs="?", const="", default=None,
                     metavar="ISO",
                     help="delta run: skip instances whose current "
                          "fingerprint (body/fixture/kernel source, "
                          "params, tuned artifact, torch/CUDA/nvcc "
                          "version) already has a measured history record "
                          "on this machine and device; their latest "
                          "records replay into the merged document as "
                          "cached.  An optional ISO prefix bounds "
                          "freshness (records older than it don't count)")
    sel.add_argument("--baseline", default=None,
                     help="compare this run against a stored baseline "
                          "document/run directory (a history.jsonl path "
                          "gates against the windowed run history)")
    sel.add_argument("--save-baseline", default=None,
                     help="store the merged document as a baseline at PATH")
    return sel


def _print_run_help(sel: argparse.ArgumentParser,
                    scope_modules: Optional[List[str]]) -> None:
    """Core options + every scope flag, in one --help."""
    mgr = ScopeManager()
    mgr.load(scope_modules)
    print(sel.format_help())
    print("flags (core, and declared by the loaded scopes):")
    flag_parser = FLAGS.build_parser(
        argparse.ArgumentParser(prog="python -m repro_torch run",
                                add_help=False, usage=argparse.SUPPRESS))
    print(flag_parser.format_help())


def _delta_cached(mgr, results_dir: str, pattern: str,
                  param_filter: Optional[Dict[str, List[str]]],
                  fingerprints: Dict[str, str], since: str, device: str
                  ) -> Dict[str, Dict[str, Any]]:
    """``--since`` delta split: instance_id → vouching history record.

    Consults the run history (store fast path via
    :func:`repro_torch.core.history.load_history`, scan fallback) for the
    sysinfo digest of a run on ``device`` here: a ``--device cpu`` record
    never vouches for a card run, nor the reverse.  Instances whose
    current fingerprint already has a fresh measured record are returned
    for cached materialization, the rest will execute.  On a host with
    no card, nothing vouches for a ``cuda`` run (its digest names the
    card), and CUDA is not touched.
    """
    from .fingerprint import delta_split
    from .history import history_path, load_history
    from .sysinfo import build_context, context_digest
    plan = build_plan(mgr, REGISTRY, pattern, param_filter=param_filter)
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            log.warning("delta plan (--since): no CUDA device here, so no "
                        "history record can vouch for a card run; all %d "
                        "instance(s) to run", len(plan.items))
            return {}
    hpath = history_path(results_dir)
    records = load_history(hpath) if os.path.exists(hpath) else []
    digest = context_digest(build_context(device=device))
    pending, cached = delta_split(plan.items, fingerprints, records,
                                  digest, since=since)
    log.info("delta plan (--since%s): %d fresh (cached) / %d to run of "
             "%d instance(s)", f" {since}" if since else "",
             len(cached), len(pending), len(plan.items))
    return cached


def run_main(argv: List[str],
             scope_modules: Optional[List[str]] = None) -> int:
    # Scope selection + orchestration are core-level (not scope flags),
    # parsed separately from the FLAGS registry.
    sel = build_run_parser()
    if any(a in ("-h", "--help") for a in argv):
        _print_run_help(sel, scope_modules)
        return 0
    if _refuse_unported(argv):
        return 2
    sel_ns, rest = sel.parse_known_args(argv)

    try:
        param_filter = parse_param_filter(sel_ns.param)
        meters = parse_meters(sel_ns.meters) if sel_ns.meters else None
    except ValueError as e:
        log.error("%s", e)
        return 2

    if sel_ns.resume and not sel_ns.results_dir:
        log.error("--resume requires --results-dir")
        return 2
    if sel_ns.resume and sel_ns.shard_grain == "scope":
        log.error("--resume requires benchmark shard grain "
                  "(drop --shard-grain scope)")
        return 2
    if sel_ns.since is not None and not sel_ns.results_dir:
        log.error("--since requires --results-dir (the run history is "
                  "the freshness source)")
        return 2
    if sel_ns.since is not None and sel_ns.shard_grain == "scope":
        log.error("--since requires benchmark shard grain "
                  "(drop --shard-grain scope)")
        return 2

    # load the baseline up front: a bad path must fail before the run,
    # and a history.jsonl baseline must be snapshotted before this run
    # appends itself to the same file
    base_doc = None
    if sel_ns.baseline:
        try:
            base_doc = load_document(sel_ns.baseline)
        except (OSError, json.JSONDecodeError) as e:
            log.error("baseline %s unreadable: %s", sel_ns.baseline, e)
            return 2

    mgr, rc = _setup_scopes(scope_modules, sel_ns.enable_scope,
                            sel_ns.disable_scope, rest)
    if mgr is None:
        return rc
    if sel_ns.list_scopes:
        for name, status in sorted(mgr.status().items()):
            print(f"{name:24s} {status}")
        return 0

    mgr.register_all()

    pattern = FLAGS.get("benchmark_filter", ".*")
    benches = REGISTRY.filter(pattern, params=param_filter)
    if FLAGS.get("benchmark_list_tests"):
        for b in benches:
            for name, params in b.instances():
                if match_params(params, param_filter):
                    print(name)
        return 0
    if not benches:
        log.error("no benchmarks match %r%s", pattern,
                  f" with --param {sel_ns.param}" if param_filter else "")
        return 1

    device = FLAGS.get("device")
    if _no_card_for(device):
        return 2
    if sel_ns.lint:
        # pre-flight: a family the linter can prove mismeasures must not
        # burn a run.  Same rules as `python -m repro_torch lint`;
        # findings go to stderr so the GB-JSON stream on stdout stays
        # parseable.
        from .lint import run_lint
        report = run_lint(benches, scope_names=sorted(
            {b.scope for b in benches}))
        if report.findings:
            print(report.format_text(), file=sys.stderr)
        if report.failed(sel_ns.strict):
            log.error("lint pre-flight failed (%s); nothing was run",
                      report.summary())
            return 1
        log.info("lint pre-flight clean: %s", report.summary())
    # don't dispatch workers for scopes the filter selects nothing from —
    # each would pay a fresh interpreter and a torch import for 0 records
    matched = {b.scope for b in benches}
    mgr.configure(disable=[name for name, _ in scope_worklist(mgr)
                           if name not in matched])

    # fingerprints ride on every run's context so history records carry
    # them (delta planning and coverage read them back)
    from .fingerprint import registry_fingerprints
    fingerprints = registry_fingerprints(benches, device)

    cached = None
    if sel_ns.since is not None:
        cached = _delta_cached(mgr, sel_ns.results_dir, pattern,
                               param_filter, fingerprints, sel_ns.since,
                               device)

    opts = OrchestratorOptions(
        jobs=sel_ns.jobs,
        isolate=sel_ns.isolate,
        shard_grain=sel_ns.shard_grain,
        benchmark_filter=pattern,
        run=RunOptions(
            min_time=FLAGS.get("benchmark_min_time", 0.05),
            repetitions=FLAGS.get("benchmark_repetitions", 1),
            report_aggregates_only=sel_ns.aggregates_only,
            param_filter=param_filter,
            meters=meters,
            slo_ms=sel_ns.slo_ms,
            device=device,
        ),
        flag_values={s.name: FLAGS.get(s.name) for s in FLAGS.declared()},
        results_dir=sel_ns.results_dir or None,
        run_id=sel_ns.resume or sel_ns.run_id,
        resume=bool(sel_ns.resume),
        cost_source=sel_ns.costs,
        cached_results=cached,
    )
    result = execute(mgr, REGISTRY, opts,
                     context_extra={"scopes": mgr.status(),
                                    "fingerprints": fingerprints})
    doc = result.doc

    out = FLAGS.get("benchmark_out")
    if out:
        write_json(doc, out)
        log.info("wrote %s (%d records)", out, len(doc["benchmarks"]))
    else:
        write_json(doc, sys.stdout)
        print()
    if result.out_dir:
        log.info("run %s persisted under %s", result.run_id, result.out_dir)

    rc = 0
    if base_doc is not None:
        comps = compare_documents(base_doc, doc)
        print(format_comparisons(comps), file=sys.stderr)
        counts = summarize(comps)
        log.info("baseline diff: %s",
                 ", ".join(f"{v} {k}" for k, v in sorted(counts.items())))
        if gate_failures(comps):
            rc = 1
    if sel_ns.save_baseline:
        save_baseline(doc, sel_ns.save_baseline)
    return rc


def build_plan_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch plan",
                                 add_help=False, epilog=epilog("plan"),
                                 formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--enable-scope", action="append", default=None)
    ap.add_argument("--disable-scope", action="append", default=[])
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker count the bin column assumes")
    ap.add_argument("--costs", default=None, metavar="PATH",
                    help="prior run directory or GB-JSON document used as "
                         "per-instance cost hints")
    ap.add_argument("--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="plan only instances whose typed parameter KEY "
                         "equals VALUE (repeatable)")
    ap.add_argument("--results-dir", default="results",
                    help="history location --since consults "
                         "(default: results)")
    ap.add_argument("--since", nargs="?", const="", default=None,
                    metavar="ISO",
                    help="delta plan: drop instances whose current "
                         "fingerprint already has a measured history "
                         "record on this machine and --device (optional "
                         "ISO prefix bounds freshness)")
    return ap


def plan_main(argv: List[str],
              scope_modules: Optional[List[str]] = None) -> int:
    """``python -m repro_torch plan`` — print the work plan with
    predicted costs.

    Shows exactly what a ``--shard-grain benchmark`` run would schedule:
    every benchmark instance with its stable ID, its predicted cost
    (``--costs`` hints, else the plan default), and the worker bin LPT
    assigns it to for the given ``--jobs``.  Nothing runs, so a plan for
    ``--device cuda`` (the default) needs no card.
    """
    ap = build_plan_parser()
    if any(a in ("-h", "--help") for a in argv):
        print(ap.format_help())
        return 0
    if _refuse_unported(argv):
        return 2
    ns, rest = ap.parse_known_args(argv)

    try:
        param_filter = parse_param_filter(ns.param)
    except ValueError as e:
        log.error("%s", e)
        return 2

    mgr, rc = _setup_scopes(scope_modules, ns.enable_scope,
                            ns.disable_scope, rest)
    if mgr is None:
        return rc
    mgr.register_all()

    hints = {}
    if ns.costs:
        try:
            hints = load_cost_hints(ns.costs)
        except (OSError, json.JSONDecodeError) as e:
            log.warning("cost source %s unreadable (%s); planning without "
                        "hints", ns.costs, e)
    pattern = FLAGS.get("benchmark_filter", ".*")
    plan = build_plan(mgr, REGISTRY, pattern, cost_hints=hints,
                      param_filter=param_filter)
    if not plan.items:
        log.error("no benchmarks match %r%s", pattern,
                  f" with --param {ns.param}" if param_filter else "")
        return 1

    items = plan.items
    n_cached = 0
    if ns.since is not None:
        from .fingerprint import registry_fingerprints
        device = FLAGS.get("device")
        fingerprints = registry_fingerprints(REGISTRY.filter(
            pattern, params=param_filter), device)
        cached = _delta_cached(mgr, ns.results_dir, pattern, param_filter,
                               fingerprints, ns.since, device)
        items = [i for i in plan.items if i.instance_id not in cached]
        n_cached = len(plan.items) - len(items)
        if not items:
            print(f"0 instance(s) to run; all {n_cached} "
                  f"fingerprint-fresh (--since)")
            return 0

    bins = plan.bins(ns.jobs, items)
    bin_of = {item.instance_id: k
              for k, b in enumerate(bins) for item in b}
    width = max(len(i.name) for i in items)
    print(f"{'instance':<{width}}  {'cost_s':>9}  {'hint':>5}  bin  "
          f"instance_id")
    for item in items:
        hint = "prior" if item.cost is not None else "def"
        print(f"{item.name:<{width}}  {plan.cost_of(item):>9.4f}  "
              f"{hint:>5}  {bin_of[item.instance_id]:>3d}  "
              f"{item.instance_id}")
    loads = [sum(plan.cost_of(i) for i in b) for b in bins]
    cached_note = (f" ({n_cached} fingerprint-fresh instance(s) pruned "
                   f"by --since)" if n_cached else "")
    print(f"\n{len(items)} instance(s) across {len(bins)} worker "
          f"bin(s); predicted total "
          f"{sum(plan.cost_of(i) for i in items):.2f}s, "
          f"makespan {max(loads):.2f}s{cached_note}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
