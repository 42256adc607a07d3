"""Built-in trace-tier rules (SCOPE2xx): traced-graph hazards.

The port of ``repro.core.lint.rules_trace``: the same ids, severities
and conditions, read from the aten graph that
:mod:`repro_torch.core.lint.compiled` traces under fake tensors (never
running the body, never launching a kernel) instead of optimized HLO —
the ``benchmark::DoNotOptimize`` class of bugs that no amount of source
staring can find.
"""
from __future__ import annotations

from typing import Iterable

from .framework import FamilyContext, FamilyRule, Finding, LintContext, \
    register_rule


@register_rule
class WorkloadOptimizedAway(FamilyRule):
    """Traced graph has no compute on the operands.

    Compute counts only ops an operand reaches, so a workload whose
    placeholders all go unused has none either: the reference's second
    condition (no runtime parameters despite operands) is this one.
    """

    id = "SCOPE201"
    severity = "error"
    title = ""
    fix_hint = ("make the output depend on the operands (not on "
                "constants built inside the callable) and deliver it — "
                "a result no operand reaches is computed once, not per "
                "call's inputs")
    requires_compile = True

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        out = fam.compiled
        if out is None or not out.analyzed():
            return
        if out.compute_ops == 0:
            ops = ", ".join(out.passive_only_ops) or "nothing"
            yield self.finding(
                fam,
                message=(f"workload for instance {out.instance!r} traces "
                         f"to no compute on its operands (the aten graph "
                         f"holds only: {ops}, or compute on constants no "
                         f"operand reaches) — the timings measure a copy "
                         f"or a precomputed result, not the op"))


@register_rule
class DeadOperand(FamilyRule):
    """Fixture operands the traced graph never consumes."""

    id = "SCOPE202"
    severity = "warning"
    title = ""
    fix_hint = ("drop the unused operand from the fixture tuple, or fix "
                "the workload to actually consume it")
    requires_compile = True

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        out = fam.compiled
        if out is None or not out.analyzed():
            return
        if 0 < out.entry_params < out.operand_leaves:
            yield self.finding(
                fam,
                message=(f"fixture for instance {out.instance!r} supplies "
                         f"{out.operand_leaves} operand leaves but the "
                         f"traced graph consumes only {out.entry_params} "
                         f"— the rest are never read, so part of the "
                         f"declared workload is never measured"))


@register_rule
class OpaqueFixture(FamilyRule):
    """Fixture context does not follow ``(callable, *operands)``."""

    id = "SCOPE203"
    severity = "info"
    title = ("fixture context does not follow the (callable, *operands) "
             "convention — the trace tier and the cost-model meter "
             "cannot inspect this workload")
    fix_hint = ("return (fn, arg0, arg1, ...) from the fixture to opt "
                "into graph-based checks and cost metrics")
    requires_compile = True

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        out = fam.compiled
        if out is None:
            return
        if not out.convention:
            yield self.finding(fam)
        elif out.error:
            yield self.finding(
                fam,
                message=(f"workload for instance {out.instance!r} could "
                         f"not be traced for inspection: {out.error}"),
                fix_hint="")
