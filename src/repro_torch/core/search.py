"""Search strategies over a :class:`ParamSpace` (``python -m repro_torch
tune``): a copy of ``repro.core.search``, kept import-free of it.

Exhaustive sweeps don't scale to kernel block spaces (3 axes × 4 values
is already 64 compile-and-measure trials), so the tuner explores under a
hard trial *budget* with pluggable strategies:

  * **factorial screening** — a coarse pass over the space's center
    point plus each axis's extremes.  Cheap (1 + 2·axes trials) and it
    yields an axis-*sensitivity* ranking: how much the objective swings
    when one axis moves across its range with the others held at center.
  * **greedy hill-climb** — seeded, deterministic neighbor moves (±1
    step along one axis's sorted values) from the best screened configs;
    moves only on strict improvement, so it terminates without cycling.
  * **Pareto-frontier extraction** — the non-dominated trials across
    several objectives (e.g. ``real_time_s`` vs ``flops_per_second``
    from the cost-model meter).

Everything is deterministic for a given ``(space, strategy, budget,
seed)``: candidate enumeration is sorted, the only randomness is a
``random.Random(seed)`` shuffle of neighbor *evaluation order*, and
already-evaluated configs are served from a cache without consuming
budget.  Objectives are minimized unless the metric name ends in
``_per_second`` (a rate — maximized).  The module touches no device:
the evaluate callable owns all measurement.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple)

from .benchmark import Params, ParamSpace

#: ``--strategy`` choices; ``auto`` = screening then hill-climb.
STRATEGIES = ("auto", "screening", "hillclimb")

_INF = float("inf")


class TrialError(RuntimeError):
    """Raised by an evaluate callable when one trial fails (bad config,
    runtime error).  The failure is recorded — it still consumes budget
    — and the search moves on."""


def lower_is_better(objective: str) -> bool:
    """Orientation: rates (``*_per_second``) are maximized, everything
    else (times, bytes, footprints) minimized."""
    return not objective.endswith("_per_second")


@dataclass(frozen=True)
class Trial:
    """One evaluated configuration."""

    index: int                      # evaluation order, 0-based
    phase: str                      # "screen" | "climb"
    params: Params
    metrics: Mapping[str, float] = field(default_factory=dict)
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None

    def to_json(self) -> Dict[str, Any]:
        return {"index": self.index, "phase": self.phase,
                "params": dict(self.params),
                "metrics": dict(self.metrics),
                **({"error": self.error} if self.error else {})}


def oriented(objective: str, trial: Trial) -> float:
    """The trial's objective as a minimize-me score (+inf when failed
    or the metric is missing)."""
    if not trial.ok or objective not in trial.metrics:
        return _INF
    value = float(trial.metrics[objective])
    return value if lower_is_better(objective) else -value


def pareto_front(trials: Sequence[Trial],
                 objectives: Sequence[str]) -> List[Trial]:
    """Non-dominated trials (orientation-aware), in evaluation order.
    Trials missing any objective are excluded."""
    scored = [(t, [oriented(o, t) for o in objectives]) for t in trials
              if t.ok and all(o in t.metrics for o in objectives)]
    front = []
    for t, s in scored:
        dominated = any(
            all(u_i <= s_i for u_i, s_i in zip(u, s)) and u != s
            for _, u in scored)
        if not dominated:
            front.append(t)
    return front


@dataclass
class SearchResult:
    objective: str
    strategy: str
    budget: int
    seed: int
    trials: List[Trial]
    best: Optional[Trial]
    baseline: Optional[Trial]            # the builtin-default config, if run
    sensitivity: List[Tuple[str, float]]  # axis → objective span, ranked
    frontier: List[Trial]
    exhausted: bool                       # budget ran out with work left

    def to_json(self) -> Dict[str, Any]:
        return {
            "objective": self.objective, "strategy": self.strategy,
            "budget": self.budget, "seed": self.seed,
            "trials": [t.to_json() for t in self.trials],
            "best": self.best.to_json() if self.best else None,
            "baseline": self.baseline.to_json() if self.baseline else None,
            "sensitivity": [{"axis": a, "span": s}
                            for a, s in self.sensitivity],
            "frontier": [t.index for t in self.frontier],
            "exhausted": self.exhausted,
        }


def _axis_values(space: ParamSpace) -> Dict[str, List[Any]]:
    """Sorted distinct values per axis (mixed-type safe)."""
    values: Dict[str, List[Any]] = {}
    for axis in space.axes():
        seen = {p[axis] for p in space.points() if axis in p}
        values[axis] = sorted(seen, key=lambda v: (str(type(v)), v))
    return values


class SearchSession:
    """Shared trial bookkeeping: the budgeted, cached evaluate loop."""

    def __init__(self, space: ParamSpace,
                 evaluate: Callable[[Params], Mapping[str, float]],
                 objective: str, budget: int,
                 cost_hint: Optional[Callable[[Params],
                                              Optional[float]]] = None):
        if not len(space):
            raise ValueError("cannot search an empty ParamSpace")
        self.space = space
        self.objective = objective
        self.budget = budget
        self._evaluate = evaluate
        self._cost_hint = cost_hint
        self._members = {p.canonical(): p for p in space.points()}
        self.values = _axis_values(space)
        self.trials: List[Trial] = []
        self._by_key: Dict[str, Trial] = {}
        self.truncated = False      # a candidate was dropped for budget

    # -- membership / budget -----------------------------------------
    def contains(self, params: Params) -> bool:
        return params.canonical() in self._members

    def cached(self, params: Params) -> bool:
        return params.canonical() in self._by_key

    @property
    def spent(self) -> int:
        return len(self.trials)

    @property
    def remaining(self) -> int:
        return max(0, self.budget - self.spent)

    # -- evaluation ----------------------------------------------------
    def run(self, params: Params, phase: str) -> Optional[Trial]:
        """Evaluate ``params`` (or serve the cached trial — free).
        Returns None when the budget is spent."""
        key = params.canonical()
        if key in self._by_key:
            return self._by_key[key]
        if self.remaining <= 0:
            self.truncated = True
            return None
        try:
            metrics = dict(self._evaluate(params))
            trial = Trial(index=len(self.trials), phase=phase,
                          params=params, metrics=metrics)
        except TrialError as e:
            trial = Trial(index=len(self.trials), phase=phase,
                          params=params, error=str(e))
        self.trials.append(trial)
        self._by_key[key] = trial
        return trial

    def score(self, trial: Optional[Trial]) -> float:
        if trial is None:
            return _INF
        return oriented(self.objective, trial)

    def order_by_cost(self, candidates: List[Params]) -> List[Params]:
        """Cheapest-hinted first (stable: unhinted keep their order,
        after the hinted) — how ``--costs`` steers the budget."""
        if self._cost_hint is None:
            return candidates
        hints = [self._cost_hint(c) for c in candidates]
        return [c for _, c in sorted(
            zip(hints, candidates),
            key=lambda hc: hc[0] if hc[0] is not None else _INF)]

    def best(self) -> Optional[Trial]:
        finite = [t for t in self.trials if self.score(t) < _INF]
        if not finite:
            return None
        return min(finite, key=lambda t: (self.score(t), t.index))


def screening_plan(space: ParamSpace) -> List[Tuple[str, Params]]:
    """The factorial-screening candidates as ``(label, params)``:
    the center point first (label ``"center"``), then each axis's
    extreme variants (labeled by axis).  Variants pruned out of the
    space by constraints are skipped."""
    values = _axis_values(space)
    members = {p.canonical(): p for p in space.points()}
    center_map = {a: vals[(len(vals) - 1) // 2] for a, vals in
                  values.items()}
    center = Params(center_map)
    if center.canonical() not in members:
        # constraints pruned the geometric center — anchor on the first
        # point of the space instead (deterministic)
        center = space.points()[0]
    plan = [("center", center)]
    seen = {center.canonical()}
    for axis, vals in values.items():
        for v in (vals[0], vals[-1]):
            cand = Params({**dict(center), axis: v})
            key = cand.canonical()
            if key in members and key not in seen:
                plan.append((axis, cand))
                seen.add(key)
    return plan


def _screen(session: SearchSession) -> List[Tuple[str, float]]:
    """Run the screening plan; returns the sensitivity ranking (axis →
    oriented-objective span over that axis's variants + center)."""
    plan = screening_plan(session.space)
    center_trial = session.run(plan[0][1], "screen")
    variants = session.order_by_cost([p for _, p in plan[1:]])
    label_of = {p.canonical(): label for label, p in plan}
    trials_by_axis: Dict[str, List[Trial]] = {}
    for cand in variants:
        t = session.run(cand, "screen")
        if t is not None:
            trials_by_axis.setdefault(label_of[cand.canonical()],
                                      []).append(t)
    sensitivity = []
    for axis in session.space.axes():
        scores = [session.score(t)
                  for t in trials_by_axis.get(axis, []) + (
                      [center_trial] if center_trial else [])]
        finite = [s for s in scores if s < _INF]
        span = (max(finite) - min(finite)) if len(finite) > 1 else 0.0
        sensitivity.append((axis, span))
    sensitivity.sort(key=lambda kv: -kv[1])
    return sensitivity


def _neighbors(session: SearchSession, current: Params) -> List[Params]:
    """In-space configs one step away along one axis's sorted values."""
    out = []
    for axis, vals in session.values.items():
        if axis not in current:
            continue
        i = vals.index(current[axis])
        for j in (i - 1, i + 1):
            if 0 <= j < len(vals):
                cand = Params({**dict(current), axis: vals[j]})
                if session.contains(cand):
                    out.append(cand)
    return out


def _hill_climb(session: SearchSession, start: Params,
                rng: random.Random) -> None:
    """Steepest-descent neighbor moves from ``start``; strict
    improvement only, so it cannot cycle."""
    current = session.run(start, "climb")
    if current is None or session.score(current) == _INF:
        return
    while True:
        candidates = _neighbors(session, current.params)
        # seeded shuffle decides which equal-cost neighbor is tried
        # first when the budget can't cover them all ...
        rng.shuffle(candidates)
        # ... and cost hints (stable sort) still put cheap ones first
        candidates = session.order_by_cost(candidates)
        evaluated = [t for t in (session.run(c, "climb")
                                 for c in candidates) if t is not None]
        if not evaluated:
            break
        best = min(evaluated, key=lambda t: (session.score(t), t.index))
        if session.score(best) < session.score(current):
            current = best
        else:
            break
        if session.remaining <= 0:
            break


def run_search(space: ParamSpace,
               evaluate: Callable[[Params], Mapping[str, float]],
               *, objective: str = "real_time_s", strategy: str = "auto",
               budget: int = 16, seed: int = 0,
               cost_hint: Optional[Callable[[Params],
                                            Optional[float]]] = None,
               baseline: Optional[Params] = None,
               frontier_objectives: Optional[Sequence[str]] = None,
               top_k: int = 2) -> SearchResult:
    """Search ``space`` for the config minimizing (or maximizing, for
    rates) ``objective`` under a hard ``budget`` of evaluations.

    ``baseline`` (e.g. the builtin default config) is evaluated first
    when given and it lies in the space — it anchors the speedup
    report but otherwise competes like any trial.  ``cost_hint(params)
    -> seconds|None`` steers evaluation order toward cheap configs.
    """
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r} "
                         f"(choices: {', '.join(STRATEGIES)})")
    if budget < 1:
        raise ValueError("budget must be >= 1")
    session = SearchSession(space, evaluate, objective, budget,
                            cost_hint=cost_hint)
    rng = random.Random(seed)

    baseline_trial = None
    if baseline is not None and session.contains(baseline):
        baseline_trial = session.run(baseline, "screen")

    sensitivity: List[Tuple[str, float]] = []
    if strategy in ("auto", "screening"):
        sensitivity = _screen(session)
    if strategy in ("auto", "hillclimb"):
        if session.trials:
            ranked = sorted(
                (t for t in session.trials if session.score(t) < _INF),
                key=lambda t: (session.score(t), t.index))
            seeds = [t.params for t in ranked[:top_k]]
        else:
            seeds = [screening_plan(space)[0][1]]
        for start in seeds:
            if session.remaining <= 0 and not session.cached(start):
                break
            _hill_climb(session, start, rng)

    objectives = list(frontier_objectives or [])
    if not objectives:
        objectives = [objective]
        for extra in ("flops_per_second",):
            if extra != objective and any(
                    extra in t.metrics for t in session.trials if t.ok):
                objectives.append(extra)
    return SearchResult(
        objective=objective, strategy=strategy, budget=budget, seed=seed,
        trials=session.trials, best=session.best(),
        baseline=baseline_trial, sensitivity=sensitivity,
        frontier=pareto_front(session.trials, objectives),
        exhausted=session.truncated,
    )
