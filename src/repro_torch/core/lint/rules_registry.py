"""Built-in registry-tier rules (SCOPE3xx): cross-family consistency (a
copy of ``repro.core.lint.rules_registry``).

These look at the registry/plan as a whole — sweeps that collapse onto
duplicate points, names that cannot resolve uniquely, scopes and
families that schedule nothing.
"""
from __future__ import annotations

from typing import Dict, Iterable

from .framework import FamilyContext, FamilyRule, Finding, LintContext, \
    RegistryRule, register_rule


@register_rule
class DuplicateAdjacentPoints(FamilyRule):
    """Instances that are identical once dead axes are projected out."""

    id = "SCOPE301"
    severity = "warning"
    title = ""
    fix_hint = ("remove the dead axis (or read it); until then the plan "
                "schedules the same workload under several names")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        for first, dupe in fam.analysis.live_projection_duplicates():
            yield self.finding(
                fam,
                message=(f"instances {first!r} and {dupe!r} differ only "
                         f"along dead parameter axes — they measure the "
                         f"identical workload twice"))


@register_rule
class InstanceNameCollision(RegistryRule):
    """Two families emit the same instance name.

    The plan keys cost hints, resume shards and baseline joins by
    instance name; a collision means those lookups can never resolve
    (build_plan refuses to schedule such a registry at all).
    """

    id = "SCOPE302"
    severity = "error"
    title = ""
    fix_hint = ("rename one family, or disambiguate the sweeps — "
                "instance names key cost hints, resume state and "
                "baseline comparisons")

    def check_registry(self, ctx: LintContext) -> Iterable[Finding]:
        owners: Dict[str, FamilyContext] = {}
        for fam in ctx.families:
            try:
                instances = fam.bench.instances()
            except Exception:  # noqa: BLE001 - SCOPE303 owns broken sweeps
                continue
            for name, _params in instances:
                prev = owners.get(name)
                if prev is None:
                    owners[name] = fam
                elif prev.bench.name != fam.bench.name:
                    yield self.finding(
                        fam,
                        message=(f"instance name {name!r} is emitted by "
                                 f"both {prev.bench.name!r} and "
                                 f"{fam.bench.name!r} — cost hints and "
                                 f"resume shards cannot resolve it"))


@register_rule
class EmptySweep(RegistryRule):
    """Families with zero instances; scopes registering no families."""

    id = "SCOPE303"
    severity = "warning"
    title = ""
    fix_hint = ("check the ParamSpace filters (.where) and the scope's "
                "register() hook — an empty sweep silently drops out of "
                "every plan and report")

    def check_registry(self, ctx: LintContext) -> Iterable[Finding]:
        populated = set()
        for fam in ctx.families:
            populated.add(fam.scope)
            try:
                count = len(fam.bench.instances())
            except Exception as e:  # noqa: BLE001
                yield self.finding(
                    fam,
                    message=(f"sweep could not be expanded ({e!r}) — the "
                             f"family contributes nothing to any plan"))
                continue
            if count == 0:
                yield self.finding(
                    fam,
                    message=("family expands to zero instances — it is "
                             "registered but can never be scheduled"))
        for scope in ctx.scope_names:
            if scope not in populated:
                yield self.finding(
                    scope=scope,
                    message=(f"scope {scope!r} registered no benchmark "
                             f"families — nothing to measure"))
