"""``python -m repro_torch lint`` — the static-analysis front door (the
port of ``repro.core.lint.cli``).

Loads and registers scopes exactly like ``run`` would (same flag
parsing, ``--device`` among them, same init hooks, same registry), then
hands the registered families to :func:`repro_torch.core.lint.run_lint`
instead of the orchestrator.  No benchmark body runs; nothing is timed.
The trace tier builds each family's first fixture on ``--device``
(default ``cuda``): as ``run`` does, the command exits 2 on a host with
no card unless given ``--device cpu``.

Exit codes follow the rest of the binary: 0 clean, 1 findings gate
(errors; warnings too under ``--strict``), 2 usage error.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .. import logging as scope_logging
from ..cli_examples import epilog
from ..flags import FLAGS
from ..hooks import HOOKS
from ..registry import REGISTRY
from ..scope import ScopeManager
from .framework import RULES, LintReport, parse_rules, run_lint

log = scope_logging.get_logger("lint")


def build_lint_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch lint",
                                 add_help=False, epilog=epilog("lint"),
                                 formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--scope", action="append", default=None,
                    metavar="NAME",
                    help="lint ONLY these scopes (repeatable; default: "
                         "every enabled scope)")
    ap.add_argument("--family", default=None, metavar="REGEX",
                    help="lint only families whose registered name "
                         "matches REGEX")
    ap.add_argument("--rules", default=None, metavar="LIST",
                    help="comma-separated rule ids to run (default: all; "
                         "see --list-rules)")
    ap.add_argument("--format", default="text", choices=["text", "json"],
                    help="finding output format (json is the machine "
                         "contract consumed by CI)")
    ap.add_argument("--strict", action="store_true",
                    help="fail (exit 1) on warnings as well as errors")
    ap.add_argument("--no-compile", action="store_true",
                    help="skip the trace-tier rules that build and "
                         "trace fixture workloads (AST and registry "
                         "tiers still run)")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    return ap


def list_rules() -> str:
    lines = []
    for rule_id in sorted(RULES):
        rule = RULES[rule_id]()
        title = rule.title or (rule.__doc__ or "").strip().splitlines()[0]
        tier = " (trace tier)" if rule.requires_compile else ""
        lines.append(f"{rule_id}  {rule.severity:<7s} {title}{tier}")
    return "\n".join(lines)


def render(report: LintReport, fmt: str, strict: bool) -> str:
    if fmt == "json":
        doc = report.to_json()
        doc["failed"] = report.failed(strict)
        return json.dumps(doc, indent=2, sort_keys=True)
    return report.format_text()


def lint_main(argv: List[str],
              scope_modules: Optional[List[str]] = None) -> int:
    ap = build_lint_parser()
    if any(a in ("-h", "--help") for a in argv):
        print(ap.format_help())
        return 0
    ns, rest = ap.parse_known_args(argv)
    if ns.list_rules:
        print(list_rules())
        return 0

    rule_ids = None
    if ns.rules:
        try:
            rule_ids = parse_rules(ns.rules)
        except ValueError as e:
            log.error("%s", e)
            return 2

    # Same startup sequence as run/plan (scope flags, init hooks) so a
    # family registered conditionally on a flag is linted exactly as it
    # would be run.
    mgr = ScopeManager()
    mgr.load(scope_modules)
    rc = HOOKS.run_pre_parse()
    if rc is not None:
        return rc
    FLAGS.parse(rest)
    scope_logging.set_level(FLAGS.get("log_level", "INFO"))
    rc = HOOKS.run_post_parse()
    if rc is not None:
        return rc
    mgr.configure(enable=ns.scope)
    mgr.register_all()

    scope_names = sorted(name for name, status in mgr.status().items()
                         if status == "enabled")
    pattern = ns.family or FLAGS.get("benchmark_filter", ".*")
    benches = [b for b in REGISTRY.filter(pattern)
               if b.scope in set(scope_names)]
    if ns.family:
        if not benches:
            log.error("no families match %r", ns.family)
            return 2
        # a family filter makes unselected scopes look empty — don't
        # let the empty-scope rule cry wolf about them
        scope_names = sorted({b.scope for b in benches})
    from ..main import _no_card_for
    if _no_card_for(FLAGS.get("device")):
        return 2

    report = run_lint(benches, scope_names=scope_names, rules=rule_ids,
                      compile_checks=not ns.no_compile)
    print(render(report, ns.format, ns.strict))
    return 1 if report.failed(ns.strict) else 0


if __name__ == "__main__":
    sys.exit(lint_main(sys.argv[1:]))
