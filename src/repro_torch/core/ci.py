"""``python -m repro_torch ci`` — the continuous-benchmarking entrypoint.

The port of ``repro.core.ci``.  One command, per commit (the ROOT
continuous-performance-framework service loop, exaCB's incremental
collections):

  1. **delta-plan** — compute every selected instance's fingerprint
     (:mod:`repro_torch.core.fingerprint`) and prune the ones whose
     current fingerprint already has a measured history record on this
     machine and ``--device``; a no-change commit plans zero instances;
  2. **run** — execute the remaining instances through the orchestrator
     (``--shard-grain benchmark``) on ``--device`` (default ``cuda``;
     with no CUDA device ``ci`` exits 2 rather than carry on on the
     CPU); skipped instances replay their latest records into the
     merged document as ``cached: true`` so the document stays complete;
  3. **append** — history records land tagged ``ci`` with their
     fingerprints (replays marked ``cached``, excluded from pooling);
  4. **gate** — the freshly-measured instances are judged against the
     windowed run history
     (:func:`repro_torch.core.history.detect_drift`, the same pooled
     cross-run stddev ``compare`` uses);
  5. **report** — re-render the run's static report
     (:func:`repro_torch.scopeplot.report.report_main`, SVG plots) unless
     ``--no-report``; a report that fails is logged and never changes
     the gate's verdict or exit code.

Exit codes: **0** clean (including "nothing changed"), **1** regression
or failed instances, **2** usage error.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from . import logging as scope_logging
from .baseline import format_comparisons, gate_failures, summarize
from .benchmark import parse_param_filter
from .cli_examples import epilog
from .flags import FLAGS
from .history import DEFAULT_WINDOW, detect_drift, history_path, load_history
from .orchestrate import OK, OrchestratorOptions, execute
from .registry import REGISTRY
from .runner import RunOptions

log = scope_logging.get_logger("ci")


def build_ci_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch ci",
                                 add_help=False, epilog=epilog("ci"),
                                 formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--enable-scope", action="append", default=None,
                    help="enable ONLY these scopes (repeatable)")
    ap.add_argument("--disable-scope", action="append", default=[],
                    help="disable these scopes (repeatable)")
    ap.add_argument("--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="gate only instances whose typed parameter KEY "
                         "equals VALUE (repeatable)")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run the delta plan in N isolated workers")
    ap.add_argument("--results-dir", default="results",
                    help="run history + run artifacts location "
                         "(default: results)")
    ap.add_argument("--run-id", default=None,
                    help="run directory name (default: timestamp)")
    ap.add_argument("--full", action="store_true",
                    help="skip delta planning: re-measure every "
                         "instance regardless of fingerprint freshness")
    ap.add_argument("--since", default="", metavar="ISO",
                    help="records older than this ISO prefix don't "
                         "count as fresh (default: any measured record "
                         "with the current fingerprint does)")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help=f"prior runs pooled for the drift gate "
                         f"(default {DEFAULT_WINDOW})")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="relative mean-shift the gate tolerates "
                         "(default: %(default)s)")
    ap.add_argument("--sigmas", type=float, default=2.0,
                    help="pooled-stddev significance bar "
                         "(default: %(default)s)")
    ap.add_argument("--no-report", action="store_true",
                    help="skip re-rendering the static report")
    return ap


def ci_main(argv: List[str],
            scope_modules: Optional[List[str]] = None) -> int:
    ap = build_ci_parser()
    if any(a in ("-h", "--help") for a in argv):
        print(ap.format_help())
        return 0
    ns, rest = ap.parse_known_args(argv)

    try:
        param_filter = parse_param_filter(ns.param)
    except ValueError as e:
        log.error("%s", e)
        return 2
    if not ns.results_dir:
        log.error("repro_torch ci needs a --results-dir (history is both "
                  "the freshness source and the drift baseline)")
        return 2

    from .main import _delta_cached, _no_card_for, _setup_scopes
    mgr, rc = _setup_scopes(scope_modules, ns.enable_scope,
                            ns.disable_scope, rest)
    if mgr is None:
        return rc
    mgr.register_all()

    pattern = FLAGS.get("benchmark_filter", ".*")
    benches = REGISTRY.filter(pattern, params=param_filter)
    if not benches:
        log.error("no benchmarks match %r%s", pattern,
                  f" with --param {ns.param}" if param_filter else "")
        return 2
    device = FLAGS.get("device")
    if _no_card_for(device):
        return 2
    from .fingerprint import registry_fingerprints
    from .plan import scope_worklist
    fingerprints = registry_fingerprints(benches, device)

    cached = {}
    if not ns.full:
        cached = _delta_cached(mgr, ns.results_dir, pattern, param_filter,
                               fingerprints, ns.since, device)

    # workers for scopes with nothing to run would pay a torch import each
    matched = {b.scope for b in benches}
    mgr.configure(disable=[name for name, _ in scope_worklist(mgr)
                           if name not in matched])

    opts = OrchestratorOptions(
        jobs=ns.jobs,
        shard_grain="benchmark",
        benchmark_filter=pattern,
        run=RunOptions(
            min_time=FLAGS.get("benchmark_min_time", 0.05),
            repetitions=FLAGS.get("benchmark_repetitions", 1),
            param_filter=param_filter,
            device=device,
        ),
        flag_values={s.name: FLAGS.get(s.name) for s in FLAGS.declared()},
        results_dir=ns.results_dir,
        run_id=ns.run_id,
        cached_results=cached,
        history_tag="ci",
    )
    result = execute(mgr, REGISTRY, opts,
                     context_extra={"scopes": mgr.status(),
                                    "fingerprints": fingerprints,
                                    "ci": True})
    measured = [r for r in result.instances if not r.cached]
    failed = [r for r in measured if r.status != OK]
    log.info("ci run %s: %d instance(s) measured, %d cached, "
             "%d failed", result.run_id, len(measured),
             len(result.instances) - len(measured), len(failed))

    # gate: freshly-measured instances vs the windowed history
    comps = detect_drift(load_history(history_path(ns.results_dir)),
                         window=ns.window, threshold=ns.threshold,
                         sigmas=ns.sigmas)
    failures = gate_failures(comps)
    if comps:
        print(format_comparisons(comps), file=sys.stderr)
        counts = summarize(comps)
        log.info("drift gate: %s",
                 ", ".join(f"{v} {k}" for k, v in sorted(counts.items())))
    else:
        log.info("drift gate: nothing to judge (no re-measured "
                 "instances, or fewer than two runs in history)")

    if not ns.no_report and result.out_dir:
        try:
            from ..scopeplot.report import report_main
            report_main([result.run_id, "--results-dir", ns.results_dir])
        except Exception:  # noqa: BLE001 - the verdict must not depend
            # on rendering; the gate already decided
            log.warning("report rendering failed for %s (gate verdict "
                        "unaffected)", result.run_id, exc_info=True)

    if failed:
        log.error("ci: %d instance(s) failed: %s", len(failed),
                  ", ".join(r.item.name for r in failed[:8]))
        return 1
    if failures:
        log.error("ci: drift gate failed (%d regression(s)/loss(es))",
                  len(failures))
        return 1
    print(f"ci: ok — {len(measured)} measured, "
          f"{len(result.instances) - len(measured)} cached, "
          f"run {result.run_id}")
    return 0
