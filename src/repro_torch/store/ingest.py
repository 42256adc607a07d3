"""Fleet ingest — merge history shards from many machines into one store.

``python -m repro_torch store ingest lab-a.jsonl lab-b.jsonl ...`` appends
other machines' history records to this results directory's
``history.jsonl`` and refreshes the index.  The JSONL stays the source
of truth: shard lines are appended **verbatim** (the shards' bytes are
the fleet's measurement record, not something to re-serialize), and
dedup works at *run* granularity — a run is identified by its
``(run_id, sysinfo digest)`` pair, so

  * re-ingesting the same shard is a no-op,
  * a run present in two overlapping shards lands once,
  * two machines that happened to mint the same timestamp run-id keep
    both runs (their sysinfo digests differ — they are different
    measurements, not duplicates).

Partial runs are all-or-nothing per shard: either every record of a
``(run_id, sysinfo)`` group is appended or none is, so a half-ingested
shard can't interleave torn runs into the store.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.core.history import HISTORY_FILE, iter_lines
from repro_torch.core.logging import get_logger

from . import index as store_index

log = get_logger("store")

RunKey = Tuple[str, str]     # (run_id, sysinfo digest)


@dataclass
class IngestStats:
    """Outcome of one :func:`ingest_shards` pass."""

    history_file: str
    shards: int = 0
    appended: int = 0                       # records written
    new_runs: List[RunKey] = field(default_factory=list)
    duplicate_runs: List[RunKey] = field(default_factory=list)
    skipped_lines: int = 0                  # garbage lines in shards

    def summary(self) -> str:
        return (f"ingested {self.shards} shard(s): {self.appended} "
                f"record(s) across {len(self.new_runs)} new run(s), "
                f"{len(self.duplicate_runs)} duplicate run(s) skipped, "
                f"{self.skipped_lines} garbage line(s) dropped")


def _run_key(rec: Dict) -> RunKey:
    return rec.get("run_id", "") or "", rec.get("sysinfo", "") or ""


def ingest_shards(results_dir: str, shard_paths: List[str],
                  history_file: Optional[str] = None,
                  reindex: bool = True) -> IngestStats:
    """Merge shard JSONL files into ``<results-dir>/history.jsonl``.

    Shards are processed in argument order; within a shard, line order
    is preserved (append order is chronology in a history file).  The
    index is refreshed afterwards (created if this store never had
    one) unless ``reindex=False``.
    """
    if history_file is None:
        history_file = os.path.join(results_dir, HISTORY_FILE)
    history_file = os.path.abspath(history_file)
    stats = IngestStats(history_file=history_file)

    existing: Set[RunKey] = set()
    if os.path.exists(history_file):
        for _line, rec in iter_lines(history_file):
            existing.add(_run_key(rec))

    to_append: List[str] = []
    for shard in shard_paths:
        shard = os.path.abspath(shard)
        if shard == history_file:
            log.warning("ingest: skipping %s (it is the destination "
                        "history file)", shard)
            continue
        stats.shards += 1
        # group the shard's lines by run so a run is appended whole
        groups: Dict[RunKey, List[str]] = {}
        order: List[RunKey] = []
        seen_lines = 0
        for line, rec in iter_lines(shard):
            seen_lines += 1
            key = _run_key(rec)
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(line)
        with open(shard, "rb") as f:
            total_lines = sum(1 for raw in f if raw.strip())
        stats.skipped_lines += total_lines - seen_lines
        for key in order:
            if key in existing:
                if key not in stats.duplicate_runs:
                    stats.duplicate_runs.append(key)
                continue
            existing.add(key)
            stats.new_runs.append(key)
            to_append.extend(groups[key])

    if to_append:
        os.makedirs(os.path.dirname(history_file), exist_ok=True)
        with open(history_file, "a") as f:
            for line in to_append:
                f.write(line + "\n")
        stats.appended = len(to_append)
    if reindex and (to_append
                    or os.path.exists(store_index.db_path(history_file))):
        if os.path.exists(history_file):
            store_index.refresh(history_file)
    log.info("ingest: %s", stats.summary())
    return stats
