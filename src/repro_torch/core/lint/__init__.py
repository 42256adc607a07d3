"""``repro_torch.core.lint`` — static analysis for benchmark hygiene.

The port of ``repro.core.lint``.  ``python -m repro_torch lint`` reaches
a verdict about every registered family without executing a single
timed repetition, through three tiers of rules:

  * **AST** (SCOPE1xx): the body/fixture source, captured at
    registration — unfenced asynchronous launches, allocation inside the
    timed loop, dead parameter axes, missing throughput counters,
    wall-clock reads;
  * **trace** (SCOPE2xx): the fixture's workload traced once into an
    aten graph under fake tensors (``make_fx``; no kernel launches) —
    work no operand reaches (the ``benchmark::DoNotOptimize`` class of
    bugs), dead operands;
  * **registry** (SCOPE3xx): cross-family consistency — instance-name
    collisions, sweeps that collapse onto duplicate points, empty
    scopes.

Rule catalog and authoring guide: docs/linting.md.
"""
from .analysis import FamilyAnalysis
from .compiled import CompiledWorkload, compile_workload
from .framework import (RULES, SEVERITIES, FamilyContext, FamilyRule,
                        Finding, LintContext, LintReport, RegistryRule,
                        Rule, parse_rules, register_rule, run_lint,
                        validate_rule_id)

# Importing the rule modules registers the built-in rules into RULES.
from . import rules_ast as _rules_ast  # noqa: F401,E402
from . import rules_registry as _rules_registry  # noqa: F401,E402
from . import rules_trace as _rules_trace  # noqa: F401,E402
from .cli import build_lint_parser, lint_main  # noqa: E402

__all__ = [
    "RULES", "SEVERITIES", "FamilyAnalysis", "FamilyContext", "FamilyRule",
    "Finding", "LintContext", "LintReport", "CompiledWorkload", "Rule",
    "RegistryRule", "build_lint_parser", "compile_workload", "lint_main",
    "parse_rules", "register_rule", "run_lint", "validate_rule_id",
]
