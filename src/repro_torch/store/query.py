"""Filter + aggregate queries over the result store (``repro_torch query``).

Two execution paths, one contract:

  * **store** — SQL pre-filter on the indexed columns (scope, family,
    run, digest, tag, timestamp), then the *same* Python predicate the
    scan path uses re-verifies every candidate row's parsed record;
  * **scan** — a direct pass over ``history.jsonl``
    (:func:`repro_torch.core.history.scan_history` semantics).

Because the index stores every record's original line and the final
predicate is shared, the two paths return byte-identical output for
identical filters — ``--no-store`` (or a missing/stale index) changes
the cost of a query, never its answer.

Aggregation is **streaming**: per-name means/stddevs via Welford and
percentiles via the P² estimator (:class:`repro_torch.core.quantile.
StreamingQuantile`), so a fleet-scale percentile query over counters
holds five markers per quantile instead of materializing per-record
sample lists.  Below five samples P² is exact — tests pin it against
:func:`repro_torch.core.quantile.percentile`.
"""
from __future__ import annotations

import json
import math
import os
import sqlite3
from dataclasses import dataclass, field
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

from repro_torch.core.benchmark import match_params, name_params
from repro_torch.core.logging import get_logger
from repro_torch.core.quantile import StreamingQuantile

from . import index as store_index

log = get_logger("store")

Record = Dict[str, Any]
#: (original line text, parsed record) — what both query paths yield.
Row = Tuple[str, Record]

DEFAULT_PERCENTILES = ("p50", "p90", "p99")


def split_name(name: str) -> Tuple[str, str]:
    """``(scope, family)`` of an instance name.

    The family is the leading components before the first typed
    ``axis:value`` (or legacy integer) argument: ``mxu/matmul/dtype:bf16
    /n:512`` → ``("mxu", "mxu/matmul")``; ``example/saxpy/1024`` →
    ``("example", "example/saxpy")``.
    """
    parts = name.split("/")
    fam: List[str] = []
    for part in parts:
        if ":" in part:
            break
        if fam and (part.isdigit()
                    or (part.startswith("-") and part[1:].isdigit())):
            break
        fam.append(part)
    return parts[0], "/".join(fam) if fam else name


def parse_percentiles(spec: str) -> List[Tuple[str, float]]:
    """``"p50,p99,p999"`` → ``[("p50", 0.50), ...]``; validates range."""
    out: List[Tuple[str, float]] = []
    for part in spec.split(","):
        label = part.strip().lower()
        if not label:
            continue
        digits = label[1:] if label.startswith("p") else ""
        if not digits.isdigit():
            raise ValueError(f"bad percentile {part!r} "
                             f"(expected p50/p90/p99/p999 style)")
        q = int(digits) / (10 ** len(digits))
        if not 0.0 < q < 1.0:
            raise ValueError(f"percentile {part!r} out of (0, 1)")
        if label not in [lb for lb, _ in out]:
            out.append((label, q))
    if not out:
        raise ValueError("--percentiles needs at least one pN value")
    return out


@dataclass
class QueryFilter:
    """What ``repro_torch query`` selects.  All fields AND together; ``params``
    follows ``--param`` semantics (values for one key OR together)."""

    scope: Optional[str] = None
    family: Optional[str] = None
    name: Optional[str] = None            # exact instance name
    params: Optional[Dict[str, List[str]]] = None
    sysinfo: Optional[str] = None         # sysinfo digest
    tag: Optional[str] = None             # "" selects untagged records
    run_id: Optional[str] = None
    since: Optional[str] = None           # ISO prefix, inclusive
    until: Optional[str] = None           # ISO prefix, inclusive
    fingerprint: Optional[str] = None     # instance fingerprint digest

    def describe(self) -> str:
        parts = []
        for key in ("scope", "family", "name", "sysinfo", "tag",
                    "run_id", "since", "until", "fingerprint"):
            v = getattr(self, key)
            if v is not None:
                parts.append(f"{key}={v}")
        if self.params:
            parts += [f"param {k}={'|'.join(v)}"
                      for k, v in self.params.items()]
        return ", ".join(parts) or "everything"


def match_record(rec: Record, flt: QueryFilter) -> bool:
    """The single predicate both query paths apply to a parsed record."""
    name = rec.get("name", "")
    scope, family = split_name(name)
    if flt.scope is not None and scope != flt.scope:
        return False
    if flt.family is not None and family != flt.family:
        return False
    if flt.name is not None and name != flt.name:
        return False
    if flt.sysinfo is not None and rec.get("sysinfo", "") != flt.sysinfo:
        return False
    if flt.tag is not None and (rec.get("tag") or "") != flt.tag:
        return False
    if flt.run_id is not None and rec.get("run_id", "") != flt.run_id:
        return False
    if flt.fingerprint is not None \
            and (rec.get("fingerprint") or "") != flt.fingerprint:
        return False
    ts = rec.get("ts", "") or ""
    if flt.since is not None and ts < flt.since:
        return False
    if flt.until is not None and ts > flt.until \
            and not ts.startswith(flt.until):
        return False
    if flt.params and not match_params(name_params(name), flt.params):
        return False
    return True


def scan_records(history_file: str, flt: QueryFilter) -> Iterator[Row]:
    """Direct JSONL scan — the reference the store path must equal."""
    from repro_torch.core.history import iter_lines
    for raw, rec in iter_lines(history_file):
        if match_record(rec, flt):
            yield raw, rec


def _store_rows(history_file: str, flt: QueryFilter) -> Iterator[Row]:
    """SQL pre-filter on indexed columns, re-verified in Python.

    Raises :class:`repro_torch.store.index.StoreStale` when the index can't
    mirror the file right now — callers fall back to the scan.
    """
    stats = store_index.refresh(history_file)
    if not stats.usable:
        raise store_index.StoreStale(history_file)
    where, args = ["1=1"], []
    for col, val in (("scope", flt.scope), ("family", flt.family),
                     ("name", flt.name), ("sysinfo", flt.sysinfo),
                     ("tag", flt.tag), ("run_id", flt.run_id),
                     ("fingerprint", flt.fingerprint)):
        if val is not None:
            where.append(f"{col} = ?")
            args.append(val)
    if flt.since is not None:
        where.append("ts >= ?")
        args.append(flt.since)
    if flt.until is not None:
        # inclusive ISO-prefix: "2026-07-31" keeps "2026-07-31T23:59"
        where.append("(ts <= ? OR ts LIKE ?)")
        args += [flt.until, flt.until + "%"]
    con = sqlite3.connect(stats.db_file)
    try:
        rows = con.execute(
            f"SELECT raw FROM records WHERE {' AND '.join(where)} "
            f"ORDER BY id", args)
        for (raw,) in rows:
            rec = json.loads(raw)
            if match_record(rec, flt):    # shared final predicate
                yield raw, rec
    finally:
        con.close()


def run_query(history_file: str, flt: QueryFilter,
              use_store: str = "auto") -> Iterator[Row]:
    """Yield matching ``(raw line, record)`` pairs in append order.

    ``use_store``: ``"auto"`` takes the index when present (building it
    is ``repro_torch store index``'s job, not a query side effect) and falls
    back to the scan on any index problem; ``"never"`` forces the scan;
    ``"always"`` builds/refreshes the index first.
    """
    history_file = os.path.abspath(history_file)
    if use_store != "never":
        has_db = os.path.exists(store_index.db_path(history_file))
        if use_store == "always" or has_db:
            try:
                yield from _store_rows(history_file, flt)
                return
            except store_index.StoreStale as e:
                log.warning("store index unusable (%s); scanning %s "
                            "directly", e, history_file)
            except sqlite3.Error as e:
                log.warning("store index broken (%r); scanning %s "
                            "directly", e, history_file)
    yield from scan_records(history_file, flt)


# ---------------------------------------------------------------------------
# streaming aggregation
# ---------------------------------------------------------------------------

class StreamStats:
    """O(1)-memory statistics: Welford mean/stddev + P² percentiles.

    This is the store's counter-aggregation primitive: a fleet-scale
    percentile query feeds every value through five P² markers per
    quantile instead of materializing a sample list.  Exact below five
    samples (pinned against ``repro_torch.core.quantile.percentile``).
    """

    def __init__(self, quantiles: Sequence[Tuple[str, float]] = ()):
        self.n = 0
        self._mean = 0.0
        self._m2 = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._sq = {label: StreamingQuantile(q) for label, q in quantiles}

    def add(self, value: float) -> None:
        v = float(value)
        self.n += 1
        d = v - self._mean
        self._mean += d / self.n
        self._m2 += d * (v - self._mean)
        self._min = min(self._min, v)
        self._max = max(self._max, v)
        for sq in self._sq.values():
            sq.observe(v)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def stddev(self) -> float:
        if self.n < 2:
            return 0.0
        return math.sqrt(self._m2 / (self.n - 1))

    def result(self) -> Dict[str, float]:
        out = {"n": self.n, "mean": self._mean, "stddev": self.stddev,
               "min": self._min, "max": self._max}
        for label, sq in self._sq.items():
            out[label] = sq.value()
        return out


@dataclass
class Aggregate:
    """Per-instance-name aggregate over a query's record stream."""

    name: str
    records: int = 0
    runs: int = 0
    errors: int = 0
    mean_s: Optional[StreamStats] = None
    counters: Dict[str, StreamStats] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "records": self.records,
                               "runs": self.runs, "errors": self.errors}
        if self.mean_s is not None and self.mean_s.n:
            out["mean_s"] = self.mean_s.result()
        if self.counters:
            out["counters"] = {k: v.result()
                               for k, v in sorted(self.counters.items())}
        return out


def aggregate_records(rows: Iterable[Row],
                      quantiles: Sequence[Tuple[str, float]] = ()
                      ) -> List[Aggregate]:
    """Fold a record stream into per-name aggregates, single pass.

    ``mean_s`` pools each record's per-run mean; every numeric counter
    is pooled under its own key.  Nothing is buffered per record — the
    stream can be a full fleet store.
    """
    by_name: Dict[str, Aggregate] = {}
    run_seen: Dict[str, set] = {}
    for _raw, rec in rows:
        name = rec.get("name", "")
        agg = by_name.get(name)
        if agg is None:
            agg = by_name[name] = Aggregate(
                name=name, mean_s=StreamStats(quantiles))
            run_seen[name] = set()
        agg.records += 1
        agg.errors += int(rec.get("errors") or 0)
        rid = (rec.get("run_id", ""), rec.get("sysinfo", ""))
        if rid not in run_seen[name]:
            run_seen[name].add(rid)
            agg.runs += 1
        mean = rec.get("mean_s")
        if isinstance(mean, (int, float)) and not isinstance(mean, bool):
            agg.mean_s.add(mean)
        counters = rec.get("counters")
        if isinstance(counters, dict):
            for key, value in counters.items():
                if isinstance(value, (int, float)) \
                        and not isinstance(value, bool):
                    st = agg.counters.get(key)
                    if st is None:
                        st = agg.counters[key] = StreamStats(quantiles)
                    st.add(value)
    return [by_name[n] for n in by_name]     # first-seen order
