"""SQLite mirror of ``history.jsonl`` — incremental, rebuildable, droppable.

The JSONL stays the portable source of truth; the database
(``history.db`` next to it) is a *derived index* over the same records:

  * ``records`` — one row per history line, keyed by scope, family,
    canonical params JSON, sysinfo digest, tag, run-id and timestamp,
    plus the **original line text** (``raw``) so query output can be
    byte-equivalent to a direct JSONL scan;
  * ``runs`` — one row per (run-id, sysinfo digest) pair with its
    record count (the fleet-dedup key :mod:`repro_torch.store.ingest` uses);
  * ``counters`` — one row per numeric counter per record, so counter
    aggregation streams through an index instead of re-parsing JSON;
  * ``meta`` — schema version, source path, and the **byte-offset
    watermark**: how far into the JSONL the index has consumed.

Incremental refresh reads only the bytes past the watermark, so
re-indexing after a run appends costs O(new bytes), not O(file).  The
index is rebuilt from scratch whenever the file shrank or its head
bytes changed (the JSONL was truncated or replaced — the watermark is
meaningless then); a rebuild from the same JSONL is byte-deterministic
(nothing time- or environment-dependent is stored).

Torn tails: a final line without a newline is a writer that died
mid-append.  The watermark stops *before* it — the bytes are re-read
on the next refresh, by which time the writer either completed the
line or never will (and the skip-with-warning path takes it).  A
complete-but-unparseable line is warned about and skipped, exactly as
:func:`repro_torch.core.history.scan_history` does, so the two paths always
agree on the record set.
"""
from __future__ import annotations

import hashlib
import json
import os
import sqlite3
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.logging import get_logger

log = get_logger("store")

DB_FILE = "history.db"
SCHEMA_VERSION = 2      # v2: fingerprint + cached columns (repro ci);
#                         v1 databases rebuild from the JSONL on first touch

#: Bytes of the JSONL head fingerprinted to detect file replacement.
_HEAD_SPAN = 512

_SCHEMA = """
CREATE TABLE IF NOT EXISTS meta (
    key TEXT PRIMARY KEY,
    value TEXT NOT NULL
);
CREATE TABLE IF NOT EXISTS records (
    id INTEGER PRIMARY KEY,
    run_id TEXT NOT NULL,
    name TEXT NOT NULL,
    scope TEXT NOT NULL,
    family TEXT NOT NULL,
    params TEXT NOT NULL,
    sysinfo TEXT NOT NULL DEFAULT '',
    tag TEXT NOT NULL DEFAULT '',
    ts TEXT NOT NULL DEFAULT '',
    mean_s REAL,
    stddev_s REAL,
    n INTEGER,
    errors INTEGER,
    verdict TEXT NOT NULL DEFAULT '',
    fingerprint TEXT NOT NULL DEFAULT '',
    cached INTEGER NOT NULL DEFAULT 0,
    raw TEXT NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_records_name ON records(name);
CREATE INDEX IF NOT EXISTS idx_records_scope ON records(scope);
CREATE INDEX IF NOT EXISTS idx_records_family ON records(family);
CREATE INDEX IF NOT EXISTS idx_records_run ON records(run_id);
CREATE INDEX IF NOT EXISTS idx_records_sysinfo ON records(sysinfo);
CREATE INDEX IF NOT EXISTS idx_records_ts ON records(ts);
CREATE INDEX IF NOT EXISTS idx_records_fingerprint
    ON records(fingerprint);
CREATE TABLE IF NOT EXISTS runs (
    run_id TEXT NOT NULL,
    sysinfo TEXT NOT NULL,
    tag TEXT NOT NULL DEFAULT '',
    first_ts TEXT NOT NULL DEFAULT '',
    records INTEGER NOT NULL DEFAULT 0,
    PRIMARY KEY (run_id, sysinfo)
);
CREATE TABLE IF NOT EXISTS counters (
    record_id INTEGER NOT NULL REFERENCES records(id),
    key TEXT NOT NULL,
    value REAL NOT NULL
);
CREATE INDEX IF NOT EXISTS idx_counters_record ON counters(record_id);
CREATE INDEX IF NOT EXISTS idx_counters_key ON counters(key);
"""


class StoreStale(RuntimeError):
    """The index cannot currently mirror the JSONL exactly (e.g. the
    file ends in a complete record with no newline, which appending
    writers never produce) — consumers must fall back to a direct scan."""


@dataclass
class RefreshStats:
    """Outcome of one :func:`refresh` pass."""

    db_file: str
    rebuilt: bool = False
    indexed: int = 0          # records added this pass
    skipped: int = 0          # complete-but-unparseable lines skipped
    total: int = 0            # records now in the index
    watermark: int = 0        # byte offset consumed
    size: int = 0             # JSONL size at refresh time
    usable: bool = True       # False: fall back to a direct scan

    @property
    def pending(self) -> int:
        """Unconsumed tail bytes (a torn trailing write, usually)."""
        return self.size - self.watermark


def db_path(history_file: str) -> str:
    """The index lives next to its JSONL: ``<dir>/history.db``."""
    return os.path.join(os.path.dirname(os.path.abspath(history_file)),
                        DB_FILE)


def connect(db_file: str) -> sqlite3.Connection:
    con = sqlite3.connect(db_file)
    con.executescript(_SCHEMA)
    return con


def _meta(con: sqlite3.Connection) -> Dict[str, str]:
    return dict(con.execute("SELECT key, value FROM meta"))


def _set_meta(con: sqlite3.Connection, **kv: Any) -> None:
    con.executemany(
        "INSERT INTO meta(key, value) VALUES(?, ?) "
        "ON CONFLICT(key) DO UPDATE SET value = excluded.value",
        [(k, str(v)) for k, v in kv.items()])


def _head_fingerprint(data_head: bytes) -> str:
    return hashlib.sha1(data_head).hexdigest()


def _needs_rebuild(con: sqlite3.Connection, history_file: str,
                   size: int) -> bool:
    meta = _meta(con)
    if meta.get("schema_version") != str(SCHEMA_VERSION):
        return bool(meta)           # fresh empty db needs no "rebuild"
    try:
        watermark = int(meta.get("watermark", "0"))
        head_len = int(meta.get("head_len", "0"))
    except ValueError:
        return True
    if size < watermark or size < head_len:
        return True                 # file shrank: the offsets are lies
    if head_len:
        with open(history_file, "rb") as f:
            head = f.read(head_len)
        if _head_fingerprint(head) != meta.get("head"):
            return True             # file replaced under the same name
    return False


def record_columns(rec: Dict[str, Any]) -> Dict[str, Any]:
    """The indexed columns of one parsed history record."""
    # lazy: query.py imports this module at its top level
    from repro_torch.core.benchmark import name_params

    from .query import split_name
    name = rec.get("name", "")
    scope, family = split_name(name)
    params = name_params(name)
    return {
        "run_id": rec.get("run_id", ""),
        "name": name,
        "scope": scope,
        "family": family,
        "params": json.dumps(params, sort_keys=True),
        "sysinfo": rec.get("sysinfo", "") or "",
        "tag": rec.get("tag", "") or "",
        "ts": rec.get("ts", "") or "",
        "mean_s": rec.get("mean_s"),
        "stddev_s": rec.get("stddev_s"),
        "n": rec.get("n"),
        "errors": rec.get("errors"),
        "verdict": rec.get("verdict", "") or "",
        "fingerprint": rec.get("fingerprint", "") or "",
        "cached": 1 if rec.get("cached") else 0,
    }


def _insert_record(con: sqlite3.Connection, rec: Dict[str, Any],
                   raw: str) -> None:
    cols = record_columns(rec)
    cur = con.execute(
        "INSERT INTO records(run_id, name, scope, family, params, "
        "sysinfo, tag, ts, mean_s, stddev_s, n, errors, verdict, "
        "fingerprint, cached, raw) "
        "VALUES(:run_id, :name, :scope, :family, :params, :sysinfo, "
        ":tag, :ts, :mean_s, :stddev_s, :n, :errors, :verdict, "
        ":fingerprint, :cached, :raw)",
        dict(cols, raw=raw))
    rid = cur.lastrowid
    counters = rec.get("counters")
    if isinstance(counters, dict):
        rows = [(rid, k, float(v)) for k, v in counters.items()
                if isinstance(v, (int, float))
                and not isinstance(v, bool)]
        if rows:
            con.executemany(
                "INSERT INTO counters(record_id, key, value) "
                "VALUES(?, ?, ?)", rows)
    con.execute(
        "INSERT INTO runs(run_id, sysinfo, tag, first_ts, records) "
        "VALUES(:run_id, :sysinfo, :tag, :ts, 1) "
        "ON CONFLICT(run_id, sysinfo) DO UPDATE SET "
        "records = records + 1", cols)


def _parse_line(raw: bytes, path: str, offset: int
                ) -> Tuple[Optional[Dict[str, Any]], Optional[str]]:
    """(record, decoded line) — (None, None) when the line is garbage
    (same skip conditions as :func:`repro_torch.core.history.scan_history`)."""
    try:
        text = raw.decode("utf-8")
    except UnicodeDecodeError:
        log.warning("%s: skipping undecodable history line at byte %d",
                    path, offset)
        return None, None
    stripped = text.strip()
    if not stripped:
        return None, text
    try:
        rec = json.loads(stripped)
    except json.JSONDecodeError:
        log.warning("%s: skipping unparseable history line at byte %d",
                    path, offset)
        return None, None
    if not isinstance(rec, dict) or "name" not in rec:
        return None, None
    return rec, stripped


def refresh(history_file: str, db_file: Optional[str] = None,
            force_rebuild: bool = False) -> RefreshStats:
    """Bring the index up to date with its JSONL, incrementally.

    Reads only the bytes past the stored watermark; rebuilds from byte
    zero when forced, when the schema changed, or when the file shrank
    or was replaced.  Raises ``OSError`` when the JSONL is missing —
    the index never outlives its source of truth.
    """
    history_file = os.path.abspath(history_file)
    db_file = db_file or db_path(history_file)
    size = os.path.getsize(history_file)

    con = connect(db_file)
    try:
        stats = RefreshStats(db_file=db_file, size=size)
        if force_rebuild or _needs_rebuild(con, history_file, size):
            con.executescript(
                "DELETE FROM counters; DELETE FROM records; "
                "DELETE FROM runs; DELETE FROM meta;")
            stats.rebuilt = True
        meta = _meta(con)
        watermark = int(meta.get("watermark", "0") or 0)

        with open(history_file, "rb") as f:
            f.seek(watermark)
            data = f.read(size - watermark)
        offset = watermark
        usable_tail = True
        for raw in data.splitlines(keepends=True):
            if not raw.endswith(b"\n"):
                # torn trailing write: leave it for the next refresh.
                # If it already parses as a record, the JSONL holds data
                # the index doesn't — consumers must scan directly.
                rec, _ = _parse_line(raw, history_file, offset)
                if rec is not None:
                    usable_tail = False
                break
            rec, _ = _parse_line(raw, history_file, offset)
            if rec is None:
                stats.skipped += 1
            else:
                _insert_record(con, rec, raw.decode("utf-8").strip())
                stats.indexed += 1
            offset += len(raw)

        head_len = min(size, _HEAD_SPAN)
        with open(history_file, "rb") as f:
            head = f.read(head_len)
        _set_meta(con, schema_version=SCHEMA_VERSION,
                  source=history_file, watermark=offset,
                  head_len=head_len, head=_head_fingerprint(head))
        con.commit()
        stats.watermark = offset
        stats.usable = usable_tail
        stats.total = con.execute(
            "SELECT COUNT(*) FROM records").fetchone()[0]
        if stats.indexed or stats.rebuilt:
            log.info("store: %s %s (+%d record(s), %d total, "
                     "watermark %d/%d bytes)",
                     "rebuilt" if stats.rebuilt else "refreshed",
                     db_file, stats.indexed, stats.total, offset, size)
        return stats
    finally:
        con.close()


def rebuild(history_file: str, db_file: Optional[str] = None
            ) -> RefreshStats:
    """Drop everything and re-index the whole JSONL from byte zero."""
    return refresh(history_file, db_file, force_rebuild=True)


def is_fresh(history_file: str, db_file: Optional[str] = None) -> bool:
    """True when the index exists and its watermark covers the JSONL."""
    history_file = os.path.abspath(history_file)
    db_file = db_file or db_path(history_file)
    if not os.path.exists(db_file) or not os.path.exists(history_file):
        return False
    con = sqlite3.connect(db_file)
    try:
        try:
            meta = dict(con.execute("SELECT key, value FROM meta"))
        except sqlite3.Error:
            return False
    finally:
        con.close()
    if meta.get("schema_version") != str(SCHEMA_VERSION):
        return False
    try:
        return int(meta.get("watermark", "-1")) \
            == os.path.getsize(history_file)
    except ValueError:
        return False


def load_records(history_file: str, db_file: Optional[str] = None
                 ) -> List[Dict[str, Any]]:
    """Every history record, in append order, via the index.

    Refreshes the index first (cheap: watermark), so the result always
    equals :func:`repro_torch.core.history.scan_history` over the same file;
    raises :class:`StoreStale` when it provably couldn't (consumers
    fall back to the direct scan).
    """
    stats = refresh(history_file, db_file)
    if not stats.usable:
        raise StoreStale(f"{history_file} has an unindexed parseable "
                         f"tail ({stats.pending} byte(s))")
    con = sqlite3.connect(stats.db_file)
    try:
        rows = con.execute("SELECT raw FROM records ORDER BY id")
        return [json.loads(raw) for (raw,) in rows]
    finally:
        con.close()


def store_status(history_file: str, db_file: Optional[str] = None
                 ) -> Dict[str, Any]:
    """Index freshness + table counts (``repro_torch store status``)."""
    history_file = os.path.abspath(history_file)
    db_file = db_file or db_path(history_file)
    out: Dict[str, Any] = {
        "history": history_file,
        "history_bytes": (os.path.getsize(history_file)
                          if os.path.exists(history_file) else None),
        "db": db_file,
        "exists": os.path.exists(db_file),
        "fresh": is_fresh(history_file, db_file),
    }
    if out["exists"]:
        con = sqlite3.connect(db_file)
        try:
            meta = dict(con.execute("SELECT key, value FROM meta"))
            out["watermark"] = int(meta.get("watermark", "0") or 0)
            out["schema_version"] = meta.get("schema_version")
            for table in ("records", "runs", "counters"):
                out[table] = con.execute(
                    f"SELECT COUNT(*) FROM {table}").fetchone()[0]
            out["machines"] = con.execute(
                "SELECT COUNT(DISTINCT sysinfo) FROM runs").fetchone()[0]
            out["fingerprints"] = con.execute(
                "SELECT COUNT(DISTINCT fingerprint) FROM records "
                "WHERE fingerprint != ''").fetchone()[0]
        except sqlite3.Error:
            out["fresh"] = False
        finally:
            con.close()
    return out
