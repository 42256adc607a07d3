"""``repro_torch.store`` — the queryable fleet result store.

A copy of the JAX package's ``repro.store`` (sqlite and JSON, no jax),
importing the port's core: its index, queries and ingest read the
history the port's runs write, with the same answers as the
reference's on the same file.

``results/history.jsonl`` (:mod:`repro_torch.core.history`) is the portable
source of truth: append-only JSON lines, one per benchmark instance per
run.  At fleet scale — many machines × instances × runs — every
consumer re-scanning that file linearly stops holding up, and a single
machine's file cannot absorb other machines' runs at all.  This package
adds the indexed layer a fleet-scale benchmark collection needs,
without demoting the JSONL:

  * :mod:`repro_torch.store.index` — an SQLite mirror (``history.db`` next to
    the JSONL; runs / records / counters tables keyed by scope, family,
    canonical params JSON, sysinfo digest, tag and timestamp).  Built
    *incrementally* from the JSONL by a byte-offset watermark, so
    re-indexing after a run appends is O(new bytes); the whole file is
    rebuildable from scratch at any time (``repro_torch store index
    --rebuild``) and deleting it loses nothing.
  * :mod:`repro_torch.store.query` — filter/aggregate queries over the store
    (``python -m repro_torch query``) whose record output is byte-equivalent
    to a direct JSONL scan: the index stores each record's original
    line, and every SQL pre-filter is re-verified by the same Python
    predicate the scan path uses.
  * :mod:`repro_torch.store.ingest` — ``python -m repro_torch store ingest
    <shard.jsonl>...`` merges history shards from other machines into
    one fleet store, deduplicating whole runs by (run-id, sysinfo
    digest).

The live dashboard over this store (``report --serve``) is
``repro_torch.scopeplot.dashboard``.
"""
from .index import (DB_FILE, db_path, is_fresh, load_records, rebuild,
                    refresh, store_status)
from .ingest import IngestStats, ingest_shards
from .query import (QueryFilter, StreamStats, aggregate_records,
                    match_record, parse_percentiles, run_query,
                    scan_records, split_name)

__all__ = [
    "DB_FILE", "IngestStats", "QueryFilter", "StreamStats",
    "aggregate_records", "db_path", "ingest_shards", "is_fresh",
    "load_records", "match_record", "parse_percentiles", "rebuild",
    "refresh", "run_query", "scan_records", "split_name", "store_status",
]
