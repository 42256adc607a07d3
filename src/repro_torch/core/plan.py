"""Work-plan layer — benchmark instances as the schedulable unit.

A copy of ``repro.core.plan``: instance IDs come from instance names
alone, so for the same instances the two packages give identical IDs.

The paper's run stage (Fig. 2(d)) treats each scope as an opaque unit; the
orchestrator originally did too, so one slow scope serialized the tail of a
parallel run and a crashing benchmark poisoned its whole scope's shard.
Continuous-benchmarking systems (exaCB's incremental collections, ROOT's
continuous performance framework) schedule and cache at the granularity of
individual benchmark *runs*.  This module is that regranularization:

  * :func:`build_plan` enumerates a configured/registered
    :class:`~repro_torch.core.scope.ScopeManager` + registry into addressable
    *benchmark instances* — ``(scope, family, arg-set)`` triples;
  * every :class:`PlanItem` carries a **stable instance ID** (derived only
    from the instance name, so it is identical across runs — the property
    that makes ``--resume`` and shard caching possible) and an optional
    **cost hint** pulled from a prior baseline/run document
    (:func:`load_cost_hints`);
  * :meth:`Plan.bins` packs items across workers with greedy
    longest-processing-time (LPT) using the cost hints, so a known-slow
    instance starts first instead of landing last on a busy worker.

The orchestrator (:mod:`repro_torch.core.orchestrate`) schedules plan items when
``--shard-grain benchmark`` is active, and still derives its scope-grained
work list from :func:`scope_worklist` otherwise.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import statistics
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .logging import get_logger

log = get_logger("plan")

#: Predicted seconds for an instance with no cost hint and no prior data.
DEFAULT_COST = 1.0


def instance_id(name: str) -> str:
    """Stable, filesystem-safe ID for a benchmark instance name.

    A readable sanitized prefix plus a short digest of the *exact* name —
    sanitizing alone could collide (``a/b:1`` vs ``a/b_1``), the digest
    restores uniqueness while staying deterministic across runs.
    """
    safe = re.sub(r"[^A-Za-z0-9._-]+", "_", name).strip("_")[:80]
    digest = hashlib.sha1(name.encode("utf-8")).hexdigest()[:8]
    return f"{safe}-{digest}"


@dataclass(frozen=True)
class PlanItem:
    """One addressable benchmark instance: (scope, family, params).

    ``params`` is the instance's typed parameter point as (axis, value)
    pairs in axis order — its canonical JSON is recorded in the
    manifest, so instances stay addressable by parameter, not just by
    name.  ``arg_set`` keeps the int-valued axes as a tuple (the legacy
    view; identical to the old arg tuples for int-only families).
    """

    instance_id: str
    name: str                      # GB instance name, e.g. "example/saxpy/n:256"
    scope: str
    family: str                    # registered family name, e.g. "example/saxpy"
    module: str                    # scope module ("<external>" → inline only)
    arg_set: Tuple[int, ...]
    params: Tuple[Tuple[str, Any], ...] = ()
    cost: Optional[float] = None   # predicted seconds (None → plan default)

    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)

    def meta(self) -> Dict[str, Any]:
        return {
            "instance_id": self.instance_id,
            "name": self.name,
            "scope": self.scope,
            "family": self.family,
            "module": self.module,
            "arg_set": list(self.arg_set),
            "params": self.params_dict(),
            "cost": self.cost,
        }

    @classmethod
    def from_meta(cls, m: Dict[str, Any]) -> "PlanItem":
        return cls(instance_id=m["instance_id"], name=m["name"],
                   scope=m["scope"], family=m["family"], module=m["module"],
                   arg_set=tuple(m.get("arg_set", ())),
                   params=tuple((m.get("params") or {}).items()),
                   cost=m.get("cost"))


@dataclass
class Plan:
    """An ordered list of benchmark instances plus cost bookkeeping.

    Item order is the *document order*: merging instance shards in plan
    order reproduces exactly the benchmark sequence an inline scope-grained
    run emits, which is what keeps ``merged.json`` deterministic across
    ``--jobs``/``--shard-grain`` settings.
    """

    items: List[PlanItem] = field(default_factory=list)
    default_cost: float = DEFAULT_COST

    def cost_of(self, item: PlanItem) -> float:
        return item.cost if item.cost is not None else self.default_cost

    def total_cost(self) -> float:
        return sum(self.cost_of(i) for i in self.items)

    def by_id(self) -> Dict[str, PlanItem]:
        return {i.instance_id: i for i in self.items}

    def scopes(self) -> List[str]:
        out: List[str] = []
        for i in self.items:
            if i.scope not in out:
                out.append(i.scope)
        return out

    def bins(self, jobs: int,
             items: Optional[Sequence[PlanItem]] = None
             ) -> List[List[PlanItem]]:
        """Greedy LPT packing of ``items`` (default: all) into ``jobs`` bins.

        Deterministic: ties broken by plan position; within each bin the
        plan order is restored so workers execute (and stream shards) in
        document order.  Empty bins are dropped.
        """
        items = list(self.items if items is None else items)
        n = max(1, int(jobs))
        index = {i.instance_id: k for k, i in enumerate(items)}
        order = sorted(items,
                       key=lambda i: (-self.cost_of(i), index[i.instance_id]))
        loads = [0.0] * n
        bins: List[List[PlanItem]] = [[] for _ in range(n)]
        for item in order:
            k = min(range(n), key=lambda j: (loads[j], j))
            bins[k].append(item)
            loads[k] += self.cost_of(item)
        for b in bins:
            b.sort(key=lambda i: index[i.instance_id])
        return [b for b in bins if b]


def scope_worklist(mgr) -> List[Tuple[str, str]]:
    """(name, module) for every enabled+available scope, in load order.

    The scope-grained orchestrator work list (the old
    ``ScopeManager.dispatchable()``); module names are re-imported by
    workers, ``"<external>"`` scopes must run inline.
    """
    return [(s.scope.name, s.module) for s in mgr.scopes()
            if s.enabled and s.available]


def build_plan(mgr, registry, pattern: str = ".*",
               cost_hints: Optional[Dict[str, float]] = None,
               param_filter: Optional[Dict[str, List[str]]] = None) -> Plan:
    """Enumerate the registered benchmarks into an ordered instance plan.

    ``mgr`` must be loaded/configured/registered.  Families are selected
    per scope with ``registry.filter`` (same semantics as a scope-grained
    run: a family whose name or any instance matches runs *all* its
    instances), then expanded instance by instance in sweep order.
    ``param_filter`` (the ``--param key=value`` selection) prunes at the
    *instance* level: only points whose typed parameters match are
    planned.  Duplicate instance names — possible across families even
    though each family rejects duplicate points — are a hard error here,
    before they can collide as plan-ID duplicates.
    """
    from .benchmark import match_params
    hints = cost_hints or {}
    items: List[PlanItem] = []
    seen: Dict[str, str] = {}
    for scope_name, module in scope_worklist(mgr):
        for bench in registry.filter(pattern, scopes=[scope_name]):
            for name, params in bench.instances():
                if not match_params(params, param_filter):
                    continue
                if name in seen:
                    raise ValueError(
                        f"duplicate benchmark instance name {name!r} "
                        f"(families {seen[name]!r} and {bench.name!r})")
                seen[name] = bench.name
                items.append(PlanItem(
                    instance_id=instance_id(name),
                    name=name, scope=scope_name, family=bench.name,
                    module=module, arg_set=params.int_values(),
                    params=tuple(params.items()),
                    cost=hints.get(name),
                ))
    default = DEFAULT_COST
    known = [i.cost for i in items if i.cost is not None]
    if known:
        default = statistics.median(known)
    return Plan(items=items, default_cost=default)


def load_cost_hints(path: str) -> Dict[str, float]:
    """Per-instance predicted seconds from a prior baseline/run document.

    Two sources, best first:

      * a run directory with a ``manifest.json`` — the recorded wall
        duration of each completed instance (exactly what LPT wants);
      * any GB-JSON document / run directory — mean per-iteration seconds
        per ``run_name`` (a *relative* proxy: slow instances still sort
        ahead of fast ones even though calibration hides absolute cost).
    """
    manifest = os.path.join(path, "manifest.json") if os.path.isdir(path) \
        else None
    if manifest and os.path.exists(manifest):
        with open(manifest) as f:
            doc = json.load(f)
        out: Dict[str, float] = {}
        for entry in doc.get("items", []):
            dur = entry.get("duration_s")
            if entry.get("status") == "ok" and dur:
                out[entry["name"]] = float(dur)
        if out:
            return out
    from .baseline import collect_stats, load_document
    stats = collect_stats(load_document(path))
    return {name: st.mean for name, st in stats.items() if st.has_times}
