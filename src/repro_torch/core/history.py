"""Append-only run-history store — ``results/history.jsonl``.

A copy of ``repro.core.history``: records carry the instance
``fingerprint`` (:mod:`repro_torch.core.fingerprint`) and mark delta-run
replays ``cached``, and a history is read through its SQLite store
index (``history.db``, :mod:`repro_torch.store.index`) when one sits
beside the file — the records a direct scan returns, by construction.

One-shot runs answer "how fast is it now"; continuous benchmarking
(ROOT's continuous performance framework, exaCB's incremental
collections) needs "how fast has it *been*".  This module is that
memory: every merged run appends one JSON line per benchmark instance
to ``<results-dir>/history.jsonl``:

.. code-block:: json

    {"run_id": "20260731T120000-42", "ts": "2026-07-31T12:00:00",
     "name": "example/saxpy/n:256", "mean_s": 1.1e-05, "stddev_s": 0.0,
     "n": 1, "errors": 0, "sysinfo": "9f2b6c01d3e4",
     "verdict": "similar", "ratio": 0.98}

  * the orchestrator (:mod:`repro_torch.core.orchestrate`) appends at merge
    time whenever a run persists to a results directory;
  * ``verdict`` is the instance's fate versus its *previous* history
    record (``new`` / ``similar`` / ``improvement`` / ``regression`` /
    ``errored``), so the file is a readable changelog on its own;
  * ``counters`` (when present) carries the mean of every inlined GB
    counter on the instance's records — meter metrics (``flops``,
    ``flops_per_second``, docs/measurement.md) and body counters alike
    survive into the store (:func:`doc_counters`);
  * ``sysinfo`` is :func:`repro_torch.core.sysinfo.context_digest` of the
    run's context — records from different machines/stacks are never
    compared or pooled: verdicts only look at same-digest predecessors,
    and windowed queries fold only the newest digest's records;
  * :func:`window_document` folds the last N runs per benchmark into a
    synthetic GB-JSON document whose "repetitions" are the per-run
    means.  :func:`repro_torch.core.baseline.load_document` loads any
    ``*.jsonl`` path through it, so ``python -m repro_torch run --baseline
    results/history.jsonl`` (or ``compare results/history.jsonl
    results/<run-id>``) gates against the *windowed* history — the
    pooled cross-run stddev catches slow drifts that single-run compare
    calls "similar" at every step;
  * :func:`detect_drift` is that same query as an API: latest run
    versus the window of runs before it.

The file is append-only JSONL on purpose: a crashed writer can at worst
leave one torn final line (readers skip it), and two sequential runs
never rewrite each other's records.
"""
from __future__ import annotations

import json
import math
import os
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple, Union

from .logging import get_logger
from .sysinfo import context_digest

log = get_logger("history")

HISTORY_FILE = "history.jsonl"

#: Default number of prior runs pooled for windowed comparisons.
DEFAULT_WINDOW = 5

# verdict values (superset of baseline's: adds NEW/ERRORED)
NEW = "new"
ERRORED = "errored"

Record = Dict[str, Any]


def history_path(results_dir: str) -> str:
    return os.path.join(results_dir, HISTORY_FILE)


def iter_lines(path: str):
    """Yield ``(line text, record)`` for every valid record line.

    The file is read as *bytes* and decoded per line: a fleet writer
    killed mid-append can tear a line anywhere — including inside a
    multi-byte UTF-8 sequence — and one torn tail must not poison every
    later query or index build.  Undecodable, unparseable and non-record
    lines are warned about and skipped, never raised.
    """
    with open(path, "rb") as f:
        for lineno, raw in enumerate(f, 1):
            try:
                line = raw.decode("utf-8").strip()
            except UnicodeDecodeError:
                log.warning("%s:%d: skipping undecodable history line",
                            path, lineno)
                continue
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                log.warning("%s:%d: skipping unparseable history line",
                            path, lineno)
                continue
            if isinstance(rec, dict) and "name" in rec:
                yield line, rec


def scan_history(path: str) -> List[Record]:
    """Direct linear scan of a history file — torn/garbage lines are
    skipped, not fatal.  This is the reference semantics the store
    index (:mod:`repro_torch.store.index`) must reproduce exactly."""
    return [rec for _line, rec in iter_lines(path)]


def load_history(path: str, store: bool = True) -> List[Record]:
    """Read a history file; a torn/garbage line is skipped, not fatal.

    When an SQLite index (``history.db``, :mod:`repro_torch.store.index`)
    sits next to the file, records come from it after a cheap
    watermark refresh instead of a full re-parse — the store-backed
    fast path behind ``compare --baseline results/history.jsonl``,
    drift gating and the report's trend pages.  Any index problem
    falls back to the direct scan (``store=False`` forces it); both
    paths return identical records by construction.
    """
    if store:
        records = _store_records(path)
        if records is not None:
            return records
    return scan_history(path)


def _store_records(path: str) -> Optional[List[Record]]:
    """Records via the SQLite index, or None when there is no usable
    index for ``path`` (no db next to it, stale, or unreadable)."""
    if not path.endswith(".jsonl") or not os.path.exists(path):
        return None
    from repro_torch.store.index import StoreStale, db_path, load_records
    if not os.path.exists(db_path(path)):
        return None
    try:
        return load_records(path)
    except StoreStale as e:
        log.warning("store index unusable (%s); scanning %s directly",
                    e, path)
    except Exception as e:  # noqa: BLE001 - a broken index must never
        # break a read; the JSONL is the source of truth
        log.warning("store index broken (%r); scanning %s directly",
                    e, path)
    return None


def run_ids(records: Iterable[Record]) -> List[str]:
    """Distinct run IDs in append (chronological) order."""
    out: List[str] = []
    for r in records:
        rid = r.get("run_id", "")
        if rid and rid not in out:
            out.append(rid)
    return out


def for_run(records: Iterable[Record], run_id: str) -> List[Record]:
    return [r for r in records if r.get("run_id") == run_id]


def series(records: Iterable[Record], name: str) -> List[Record]:
    """All records of one benchmark instance, in append order."""
    return [r for r in records if r.get("name") == name]


def benchmark_names(records: Iterable[Record]) -> List[str]:
    """Distinct benchmark names in first-seen order."""
    out: List[str] = []
    for r in records:
        n = r.get("name", "")
        if n and n not in out:
            out.append(n)
    return out


def doc_counters(doc: Dict[str, Any]) -> Dict[str, Dict[str, float]]:
    """Mean numeric counters per ``run_name`` of a merged document.

    GB inlines counters at the record's top level, so a counter is any
    numeric field that is not a canonical record key — which is exactly
    how meter metrics (``flops``, ``flops_per_second``, ...) and body
    counters reach history.  Iteration records are averaged; a name
    reduced to aggregates by ``--aggregates-only`` falls back to its
    ``mean`` aggregate's counters.
    """
    from .runner import RESERVED_RECORD_KEYS
    sums: Dict[str, Dict[str, float]] = {}
    counts: Dict[str, Dict[str, int]] = {}
    agg: Dict[str, Dict[str, float]] = {}
    for rec in doc.get("benchmarks", []):
        if rec.get("error_occurred") or rec.get("skipped"):
            continue
        name = rec.get("run_name") or rec.get("name", "")
        extras = {k: float(v) for k, v in rec.items()
                  if k not in RESERVED_RECORD_KEYS
                  and isinstance(v, (int, float))
                  and not isinstance(v, bool)}
        if not extras:
            continue
        if rec.get("run_type") == "aggregate":
            if rec.get("aggregate_name") == "mean":
                agg[name] = extras
            continue
        s = sums.setdefault(name, {})
        c = counts.setdefault(name, {})
        for k, v in extras.items():
            s[k] = s.get(k, 0.0) + v
            c[k] = c.get(k, 0) + 1
    out: Dict[str, Dict[str, float]] = {}
    for name, s in sums.items():
        out[name] = {k: v / counts[name][k] for k, v in s.items()}
    for name, extras in agg.items():
        out.setdefault(name, extras)
    return out


def _cached_names(doc: Dict[str, Any]) -> set:
    """Instance names whose every document record was materialized from
    history (``cached: true``) rather than measured — a delta run's
    skipped instances (repro_torch.core.fingerprint)."""
    measured, cached = set(), set()
    for rec in doc.get("benchmarks", []):
        name = rec.get("run_name") or rec.get("name", "")
        if not name:
            continue
        (cached if rec.get("cached") else measured).add(name)
    return cached - measured


def _verdict(prev: Optional[Record], mean: Optional[float],
             stddev: float, n: int, threshold: float, sigmas: float
             ) -> Tuple[str, Optional[float]]:
    """Verdict + ratio of a fresh measurement vs its previous record.

    Mirrors :func:`repro_torch.core.baseline.compare_documents` semantics: the
    relative change must clear ``threshold`` AND — only when *both*
    sides carry repetition data (n > 1) — the mean shift must clear
    ``sigmas`` pooled standard deviations.  A single-shot measurement
    has no noise estimate, so the ratio alone decides, exactly as in
    ``compare_documents``.
    """
    from .baseline import IMPROVEMENT, REGRESSION, SIMILAR
    if mean is None:
        return ERRORED, None
    if prev is None or prev.get("mean_s") is None:
        return NEW, None
    pm = float(prev["mean_s"])
    if pm <= 0:
        return NEW, None
    ratio = mean / pm
    rel = (mean - pm) / pm
    pooled = math.sqrt(float(prev.get("stddev_s") or 0.0) ** 2
                       + stddev ** 2)
    prev_n = int(prev.get("n") or 0)
    if prev_n > 1 and n > 1 and pooled > 0:
        significant = abs(mean - pm) > sigmas * pooled
    else:
        significant = True
    if significant and rel > threshold:
        return REGRESSION, ratio
    if significant and rel < -threshold:
        return IMPROVEMENT, ratio
    return SIMILAR, ratio


def append_run(results_dir: str, doc: Dict[str, Any],
               run_id: Optional[str] = None,
               threshold: float = 0.10, sigmas: float = 2.0,
               tag: Optional[str] = None) -> List[Record]:
    """Append one record per benchmark instance of a merged document.

    Returns the appended records ([] when the run is already recorded —
    a resumed run merges twice but must not double-append).  ``ts`` and
    the sysinfo digest come from the document's own context, so history
    records stay reproducible from the run artifacts.  ``tag`` marks
    what produced the run (``"tune"`` for autotuning trials) so
    consumers can tell trial records from ordinary benchmark runs.
    """
    from .baseline import collect_stats
    ctx = doc.get("context", {})
    run_id = run_id or ctx.get("run_id") or "run"
    fingerprints = ctx.get("fingerprints") or {}
    cached_names = _cached_names(doc)
    path = history_path(results_dir)
    prior: List[Record] = []
    if os.path.exists(path):
        prior = load_history(path)
        if any(r.get("run_id") == run_id for r in prior):
            log.info("history already has run %s; not appending", run_id)
            return []
    ts = ctx.get("date", "")
    digest = context_digest(ctx)
    # verdicts only ever compare same-digest records: a record produced
    # on a different machine/stack is not a valid "previous" — the new
    # environment starts its own series ("new")
    last: Dict[str, Record] = {}
    for r in prior:
        if r.get("sysinfo") == digest and not r.get("cached"):
            last[r.get("name", "")] = r

    counters = doc_counters(doc)
    records: List[Record] = []
    for name, st in collect_stats(doc).items():
        mean = st.mean if st.has_times else None
        stddev = st.stddev if st.has_times else 0.0
        verdict, ratio = _verdict(last.get(name), mean, stddev, st.n,
                                  threshold, sigmas)
        rec: Record = {
            "run_id": run_id, "ts": ts, "name": name,
            "mean_s": mean, "stddev_s": stddev, "n": st.n,
            "errors": st.errors, "sysinfo": digest, "verdict": verdict,
        }
        if tag:
            rec["tag"] = tag
        if name in fingerprints:
            rec["fingerprint"] = fingerprints[name]
        if name in cached_names:
            # a replayed (delta-skipped) instance: its mean is an echo of
            # an older run, not a new measurement — drift pooling and
            # delta freshness both ignore it
            rec["cached"] = True
        if ratio is not None:
            rec["ratio"] = round(ratio, 6)
        if name in counters:
            rec["counters"] = counters[name]
        records.append(rec)
    if not records:
        return []
    os.makedirs(results_dir, exist_ok=True)
    with open(path, "a") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
    log.info("history: appended %d record(s) for run %s to %s",
             len(records), run_id, path)
    return records


# ---------------------------------------------------------------------------
# windowed queries (what single-run compare misses)
# ---------------------------------------------------------------------------

def window_document(source: Union[str, Sequence[Record]],
                    window: int = DEFAULT_WINDOW,
                    sysinfo: Optional[str] = None) -> Dict[str, Any]:
    """Fold the last ``window`` runs per benchmark into a GB-JSON doc.

    Each benchmark's recent per-run means become repetition records, so
    :func:`repro_torch.core.baseline.compare_documents` pools them into a
    cross-run mean *and stddev* — the windowed baseline a drifting
    benchmark is judged against.  ``source`` is a ``history.jsonl`` path
    or an already-loaded record list.

    Only records from one machine/stack configuration are folded:
    ``sysinfo`` selects the digest (default: the digest of the newest
    record), so a history shared across machines never pools
    incomparable numbers into one baseline.  Replayed ``cached`` records
    (a delta run's skipped instances) are excluded — pooling the same
    mean twice would deflate the cross-run stddev and make the window
    look artificially stable.
    """
    records = load_history(source) if isinstance(source, str) \
        else list(source)
    records = [r for r in records if not r.get("cached")]
    if sysinfo is None and records:
        sysinfo = records[-1].get("sysinfo")
    if sysinfo is not None:
        records = [r for r in records if r.get("sysinfo") == sysinfo]
    benchmarks: List[Dict[str, Any]] = []
    for name in benchmark_names(records):
        recent = [r for r in series(records, name)
                  if r.get("mean_s") is not None][-max(1, window):]
        for i, r in enumerate(recent):
            benchmarks.append({
                "name": name, "run_name": name, "run_type": "iteration",
                "repetitions": len(recent), "repetition_index": i,
                "threads": 1, "iterations": 1,
                "real_time": float(r["mean_s"]),
                "cpu_time": float(r["mean_s"]),
                "time_unit": "s",
                "history_run_id": r.get("run_id", ""),
            })
    src = source if isinstance(source, str) else "<records>"
    return {"context": {"history_source": src, "history_window": window,
                        "history_sysinfo": sysinfo},
            "benchmarks": benchmarks}


def detect_drift(records: Sequence[Record], window: int = DEFAULT_WINDOW,
                 threshold: float = 0.10, sigmas: float = 2.0):
    """Latest run vs the window of runs before it.

    Returns :class:`repro_torch.core.baseline.Comparison` objects — the same
    verdicts ``python -m repro_torch compare`` prints — computed against the
    pooled window, which flags slow drifts where every consecutive pair
    of runs looked "similar".  Empty when history holds fewer than two
    runs.  Prior runs from a different machine/stack (sysinfo digest)
    than the latest run are excluded from the window.

    ``cached`` records are no-ops on both sides: a delta run
    (``--since`` / ``repro ci``) re-measures only changed instances, so
    drift is judged exactly on those — replayed records neither trigger
    verdicts nor count skipped instances as "removed".
    """
    from .baseline import compare_documents
    ids = run_ids(records)
    if len(ids) < 2:
        return []
    latest = ids[-1]
    all_latest = for_run(records, latest)
    latest_records = [r for r in all_latest if not r.get("cached")]
    if not latest_records:
        return []                     # fully-cached run: nothing new
    digest = latest_records[-1].get("sysinfo")
    prior = [r for r in records if r.get("run_id") != latest]
    if len(latest_records) < len(all_latest):
        # a delta run: judge only what was re-measured — skipped
        # instances are vouched for by their cached records, not missing
        fresh_names = {r.get("name") for r in latest_records}
        prior = [r for r in prior if r.get("name") in fresh_names]
    base = window_document(prior, window, sysinfo=digest)
    contender = window_document(latest_records, window=1, sysinfo=digest)
    return compare_documents(base, contender,
                             threshold=threshold, sigmas=sigmas)
