"""Rule framework for ``repro_torch lint`` — findings, rules, registry,
report (a copy of ``repro.core.lint.framework``).

The linter's contract is the inverse of the runner's: it must reach a
verdict about every registered benchmark family **without executing a
single timed repetition**.  Rules therefore see three progressively
deeper (and progressively more expensive) views of a family:

  * its *source* — the body and fixture functions captured at
    registration time (:mod:`repro_torch.core.lint.analysis`, pure AST);
  * its *traced workload* — the fixture's ``(fn, *operands)`` traced
    once per representative instance into an aten graph under fake
    tensors (:mod:`repro_torch.core.lint.compiled`: no kernel launches,
    the body itself is never called);
  * the *registry* — cross-family facts (instance-name collisions,
    empty sweeps) no single family can see.

A rule is a class with an id (``SCOPE101``-style), a severity, a title
and a fix hint, registered into :data:`RULES` with the
:func:`register_rule` decorator — the same shape as the meter registry
(:data:`repro_torch.core.measure.METERS`), so scope authors ship custom rules
next to custom meters::

    from repro_torch.core.lint import FamilyRule, register_rule

    @register_rule
    class NoGiantSweeps(FamilyRule):
        id = "MYSCOPE901"
        severity = "warning"
        title = "family sweeps more than 100 instances"
        fix_hint = "prune the ParamSpace with .where(...)"

        def check_family(self, ctx, fam):
            if len(fam.bench.instances()) > 100:
                yield self.finding(fam)

``run_lint`` drives every selected rule over a registry and returns a
:class:`LintReport` — text/JSON rendering and the severity gate used by
the CLI (``--strict`` promotes warnings to failures) live there.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence)

from ..logging import get_logger
from .analysis import FamilyAnalysis
from .compiled import CompiledWorkload, compile_workload

log = get_logger("lint")

#: Finding severities, most severe first.  ``error`` findings corrupt
#: measurements and gate by default; ``warning`` gates under
#: ``--strict``; ``info`` is advisory and never gates.
SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Finding:
    """One rule violation, attributed to a family (or a whole scope)."""

    rule: str                  # rule id, e.g. "SCOPE101"
    severity: str              # one of SEVERITIES
    scope: str                 # owning scope name ("" for registry-wide)
    family: str                # registered family name ("" for scope-wide)
    message: str               # what is wrong, in measurement terms
    fix_hint: str = ""         # how an author makes it go away
    location: str = ""         # "file:line" of the body, when known

    def target(self) -> str:
        return self.family or self.scope or "<registry>"

    def format(self) -> str:
        loc = f" [{self.location}]" if self.location else ""
        hint = f"\n      fix: {self.fix_hint}" if self.fix_hint else ""
        return (f"{self.target()}: {self.rule} {self.severity}: "
                f"{self.message}{loc}{hint}")

    def to_json(self) -> Dict[str, Any]:
        return {
            "rule": self.rule, "severity": self.severity,
            "scope": self.scope, "family": self.family,
            "message": self.message, "fix_hint": self.fix_hint,
            "location": self.location,
        }


class FamilyContext:
    """One family under analysis: the registered :class:`Benchmark` plus
    lazily-computed AST and trace-tier views shared by every rule (the
    AST is parsed once, the workload traced once, however many rules
    read them)."""

    def __init__(self, bench, lint_ctx: "LintContext"):
        self.bench = bench
        self.scope = bench.scope
        self._ctx = lint_ctx
        self._analysis: Optional[FamilyAnalysis] = None
        self._compiled: Optional[CompiledWorkload] = None
        self._compiled_done = False

    @property
    def analysis(self) -> FamilyAnalysis:
        if self._analysis is None:
            self._analysis = FamilyAnalysis(self.bench)
        return self._analysis

    @property
    def compiled(self) -> Optional[CompiledWorkload]:
        """Trace-tier view; ``None`` when compile checks are disabled
        or the family has no fixture to trace."""
        if not self._ctx.compile_checks:
            return None
        if not self._compiled_done:
            self._compiled = compile_workload(self.bench)
            self._compiled_done = True
        return self._compiled

    def location(self) -> str:
        b = self.bench
        if b.source_file and b.source_line:
            return f"{b.source_file}:{b.source_line}"
        return ""


class LintContext:
    """Everything a rule may inspect: the family contexts, the scope
    names under analysis, and the trace-tier switch."""

    def __init__(self, benches: Sequence[Any],
                 scope_names: Optional[Sequence[str]] = None,
                 compile_checks: bool = True):
        self.families = [FamilyContext(b, self) for b in benches]
        self.scope_names = list(scope_names) if scope_names is not None \
            else sorted({b.scope for b in benches})
        self.compile_checks = compile_checks


class Rule:
    """Base rule: identity + metadata.  Subclass :class:`FamilyRule` for
    per-family checks or :class:`RegistryRule` for cross-family ones."""

    id: str = ""
    severity: str = "warning"
    title: str = ""
    fix_hint: str = ""
    #: Rules that trace the workload are skipped by --no-compile.
    requires_compile: bool = False

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, fam: Optional[FamilyContext] = None, *,
                message: str = "", scope: str = "", family: str = "",
                fix_hint: Optional[str] = None,
                location: Optional[str] = None) -> Finding:
        """Build a finding with this rule's id/severity and the family's
        attribution filled in; ``message`` defaults to the rule title."""
        if fam is not None:
            scope = scope or fam.scope
            family = family or fam.bench.name
            if location is None:
                location = fam.location()
        return Finding(
            rule=self.id, severity=self.severity, scope=scope,
            family=family, message=message or self.title,
            fix_hint=self.fix_hint if fix_hint is None else fix_hint,
            location=location or "",
        )


class FamilyRule(Rule):
    """A rule evaluated independently against every family."""

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        for fam in ctx.families:
            yield from self.check_family(ctx, fam)

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        return ()


class RegistryRule(Rule):
    """A rule evaluated once over the whole registry."""

    def run(self, ctx: LintContext) -> Iterator[Finding]:
        yield from self.check_registry(ctx)

    def check_registry(self, ctx: LintContext) -> Iterable[Finding]:
        return ()


#: Built-in + custom rule registry: rule id → rule factory (the meter
#: registry pattern — repro_torch.core.measure.METERS).
RULES: Dict[str, Callable[[], Rule]] = {}


def register_rule(cls: Callable[[], Rule]) -> Callable[[], Rule]:
    """Class decorator adding a rule to :data:`RULES` (keyed by id)."""
    rule_id = getattr(cls, "id", "")
    if not rule_id:
        raise ValueError(f"rule {cls!r} declares no id")
    if getattr(cls, "severity", None) not in SEVERITIES:
        raise ValueError(f"rule {rule_id}: severity must be one of "
                         f"{', '.join(SEVERITIES)}")
    if rule_id in RULES:
        raise ValueError(f"rule id {rule_id!r} already registered")
    RULES[rule_id] = cls
    return cls


def validate_rule_id(rule_id: str) -> str:
    """Raise ``ValueError`` (with the available set) unless registered —
    the single check behind ``--rules`` (mirrors validate_meter_name)."""
    if rule_id not in RULES:
        raise ValueError(f"unknown rule {rule_id!r} "
                         f"(available: {', '.join(sorted(RULES))})")
    return rule_id


def parse_rules(spec: str) -> List[str]:
    """``--rules SCOPE101,SCOPE201`` → validated id list."""
    ids: List[str] = []
    for part in spec.split(","):
        rule_id = part.strip()
        if not rule_id:
            continue
        validate_rule_id(rule_id)
        if rule_id not in ids:
            ids.append(rule_id)
    if not ids:
        raise ValueError("--rules needs at least one rule id")
    return ids


@dataclass
class LintReport:
    """The outcome of one lint pass: findings + what was analyzed."""

    findings: List[Finding] = field(default_factory=list)
    families_checked: int = 0
    scopes_checked: int = 0
    rules_run: List[str] = field(default_factory=list)

    def counts(self) -> Dict[str, int]:
        out = {s: 0 for s in SEVERITIES}
        for f in self.findings:
            out[f.severity] = out.get(f.severity, 0) + 1
        return out

    def by_severity(self, severity: str) -> List[Finding]:
        return [f for f in self.findings if f.severity == severity]

    def failed(self, strict: bool = False) -> bool:
        """The CLI gate: errors always fail; --strict fails warnings too."""
        counts = self.counts()
        if counts["error"]:
            return True
        return strict and counts["warning"] > 0

    def summary(self) -> str:
        c = self.counts()
        return (f"checked {self.families_checked} families across "
                f"{self.scopes_checked} scopes with "
                f"{len(self.rules_run)} rules: "
                f"{c['error']} error(s), {c['warning']} warning(s), "
                f"{c['info']} info")

    def format_text(self) -> str:
        lines: List[str] = []
        rank = {s: i for i, s in enumerate(SEVERITIES)}
        ordered = sorted(self.findings,
                         key=lambda f: (rank[f.severity], f.scope,
                                        f.family, f.rule))
        for f in ordered:
            lines.append(f.format())
        if lines:
            lines.append("")
        lines.append(self.summary())
        return "\n".join(lines)

    def to_json(self) -> Dict[str, Any]:
        return {
            "version": 1,
            "families_checked": self.families_checked,
            "scopes_checked": self.scopes_checked,
            "rules_run": list(self.rules_run),
            "counts": self.counts(),
            "findings": [f.to_json() for f in self.findings],
        }


def run_lint(benches: Sequence[Any],
             scope_names: Optional[Sequence[str]] = None,
             rules: Optional[Sequence[str]] = None,
             compile_checks: bool = True) -> LintReport:
    """Run lint rules over registered benchmark families.

    ``benches`` is a list of :class:`~repro_torch.core.benchmark.Benchmark`
    (usually ``REGISTRY.filter(...)``); ``scope_names`` the scopes under
    analysis (for the zero-instance rule — defaults to the scopes the
    families belong to); ``rules`` a subset of :data:`RULES` ids (all
    when omitted); ``compile_checks=False`` skips the rules that trace
    fixtures' workloads (the AST and registry tiers still run).

    Nothing here executes a benchmark body or starts a timer: analysis
    is source + (optionally) a fake-tensor trace.
    """
    ctx = LintContext(benches, scope_names, compile_checks)
    selected = list(rules) if rules else sorted(RULES)
    findings: List[Finding] = []
    ran: List[str] = []
    for rule_id in selected:
        rule = RULES[validate_rule_id(rule_id)]()
        if rule.requires_compile and not compile_checks:
            continue
        ran.append(rule_id)
        try:
            findings.extend(rule.run(ctx))
        except Exception as e:  # noqa: BLE001 - a broken rule must not
            # take down the whole pass (mirrors scope import isolation)
            log.warning("rule %s crashed: %r", rule_id, e)
    return LintReport(findings=findings,
                      families_checked=len(ctx.families),
                      scopes_checked=len(ctx.scope_names),
                      rules_run=ran)
