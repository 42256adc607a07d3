"""The SCOPE binary entry point on PyTorch and CUDA
(``python -m repro_torch``).

The port of ``repro.core.main``'s ``run`` subcommand, run inline in one
process::

    python -m repro_torch [run] [flags...]

Startup follows the reference's run stage:

  1. load scopes (imports, flag declaration)
  2. run pre-parse init hooks
  3. parse CLI (core flags + every scope's declared flags)
  4. run post-parse init hooks
  5. enable/disable scopes, register their benchmarks
  6. run every selected instance (:mod:`repro_torch.core.runner`) on
     ``--device`` (default ``cuda``; with no CUDA device the run exits 2
     rather than carry on on the CPU) and write the GB-JSON document

The reference's other subcommands and its orchestration, history and
baseline flags are not ported yet: each is refused with "not yet
ported", never ignored.  The document this writes is read by the
reference's ``python -m repro compare``.
"""
from __future__ import annotations

import argparse
import sys
from typing import List, Optional, Tuple

from . import logging as scope_logging
from .benchmark import match_params, parse_param_filter
from .flags import FLAGS
from .hooks import HOOKS
from .measure import parse_meters
from .registry import REGISTRY
from .runner import RunOptions, run_benchmarks, write_json
from .scope import ScopeManager

log = scope_logging.get_logger("main")

#: Subcommands of ``python -m repro`` that later slices port.
NOT_YET_PORTED_COMMANDS = ("plan", "ci", "lint", "tune", "compare", "report",
                           "query", "store")
#: ``run`` flags of the reference that need the orchestrator, history,
#: baselines or the linter, which later slices port.
NOT_YET_PORTED_FLAGS = ("--jobs", "--isolate", "--shard-grain",
                        "--results-dir", "--run-id", "--resume", "--since",
                        "--costs", "--baseline", "--save-baseline", "--lint",
                        "--strict")

_OVERVIEW = """\
usage: python -m repro_torch [run] [flags...]

The SCOPE binary on PyTorch and CUDA: run benchmark scopes on the card
(--device cuda, the default) or on the CPU (--device cpu) and write a
Google Benchmark JSON document.  `python -m repro compare A.json B.json`
diffs two documents of either package.

examples:
  python -m repro_torch run --enable-scope mxu
  python -m repro_torch run --enable-scope histo --param backend=cuda \\
      --benchmark_out histo.json
  python -m repro_torch run --device cpu --enable-scope example
"""


def main(argv: Optional[List[str]] = None,
         scope_modules: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(_OVERVIEW)
        return 0
    if argv and argv[0] in NOT_YET_PORTED_COMMANDS:
        log.error("%s is not yet ported to repro_torch", argv[0])
        return 2
    if argv and argv[0] == "run":
        argv = argv[1:]
    return run_main(argv, scope_modules)


def _setup_scopes(scope_modules: Optional[List[str]],
                  enable: Optional[List[str]], disable: List[str],
                  rest: List[str]) -> Tuple[Optional[ScopeManager], int]:
    """Steps 1–5 of the startup sequence."""
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


def build_run_parser() -> argparse.ArgumentParser:
    """Core run options (scope flags are parsed separately via FLAGS)."""
    sel = argparse.ArgumentParser(prog="python -m repro_torch run",
                                  add_help=False)
    sel.add_argument("--enable-scope", action="append", default=None,
                     help="enable ONLY these scopes (repeatable)")
    sel.add_argument("--disable-scope", action="append", default=[],
                     help="disable these scopes (repeatable)")
    sel.add_argument("--list-scopes", action="store_true")
    sel.add_argument("--param", action="append", default=[],
                     metavar="KEY=VALUE",
                     help="run only instances whose typed parameter KEY "
                          "equals VALUE (repeatable; same KEY twice ORs "
                          "the values, distinct KEYs AND together)")
    sel.add_argument("--meters", default=None, metavar="LIST",
                     help="comma-separated measurement meters (available: "
                          "wall, cpu, latency; default wall,cpu; wall and "
                          "cpu are always included)")
    sel.add_argument("--slo-ms", type=float, default=None, metavar="MS",
                     help="latency objective for the latency meter")
    sel.add_argument("--aggregates-only", action="store_true",
                     help="with --benchmark_repetitions > 1, report only "
                          "the mean/median/stddev aggregate records")
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


def run_main(argv: List[str],
             scope_modules: Optional[List[str]] = None) -> int:
    sel = build_run_parser()
    if any(a in ("-h", "--help") for a in argv):
        _print_run_help(sel, scope_modules)
        return 0
    refused = sorted({a.split("=", 1)[0] for a in argv
                      if a.split("=", 1)[0] in NOT_YET_PORTED_FLAGS})
    if refused:
        log.error("%s: not yet ported to repro_torch", ", ".join(refused))
        return 2
    sel_ns, rest = sel.parse_known_args(argv)

    try:
        param_filter = parse_param_filter(sel_ns.param)
        meters = parse_meters(sel_ns.meters) if sel_ns.meters else None
    except ValueError as e:
        log.error("%s", e)
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
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            log.error("no CUDA device is available: the scopes run on the "
                      "card; pass --device cpu to run them on the CPU")
            return 2

    opts = RunOptions(
        min_time=FLAGS.get("benchmark_min_time", 0.05),
        repetitions=FLAGS.get("benchmark_repetitions", 1),
        report_aggregates_only=sel_ns.aggregates_only,
        param_filter=param_filter,
        meters=meters,
        slo_ms=sel_ns.slo_ms,
        device=device,
    )
    doc = run_benchmarks(benches, opts,
                         context_extra={"scopes": mgr.status()})

    out = FLAGS.get("benchmark_out")
    if out:
        write_json(doc, out)
        log.info("wrote %s (%d records)", out, len(doc["benchmarks"]))
    else:
        write_json(doc, sys.stdout)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
