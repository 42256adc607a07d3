"""Object model for Google-Benchmark JSON files (paper §V-A.6).

A copy of ``repro.scopeplot.model`` over the port's harness
(``repro_torch.core``): documents of either package load alike.

ScopePlot "has an object model for JSON files and various methods for
filtering them and converting them to pandas DataFrames".  We mirror that:
:class:`BenchmarkFile` wraps a document, records are :class:`BenchmarkRecord`
views, and conversions target :class:`repro_torch.scopeplot.frame.Frame` (a small
columnar table; pandas is not available offline).
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, Iterator, List, Optional, Union

from .frame import Frame

_STANDARD_FIELDS = {
    "name", "run_name", "run_type", "repetitions", "repetition_index",
    "threads", "iterations", "real_time", "cpu_time", "time_unit",
    "aggregate_name", "bytes_per_second", "items_per_second", "label",
    "error_occurred", "error_message", "skipped", "skip_message",
    "compile_time_s",
}


@dataclass
class BenchmarkRecord:
    """One entry of the ``benchmarks`` array."""
    raw: Dict[str, Any]

    @property
    def name(self) -> str:
        return self.raw.get("name", "")

    @property
    def scope(self) -> str:
        """Owning scope, from the ``<scope>/<family>`` name prefix."""
        return self.name.split("/", 1)[0] if "/" in self.name else ""

    @property
    def real_time(self) -> Optional[float]:
        return self.raw.get("real_time")

    @property
    def time_unit(self) -> str:
        return self.raw.get("time_unit", "ns")

    def real_time_seconds(self) -> Optional[float]:
        scale = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0}
        t = self.real_time
        return None if t is None else t * scale.get(self.time_unit, 1.0)

    @property
    def counters(self) -> Dict[str, Any]:
        return {k: v for k, v in self.raw.items()
                if k not in _STANDARD_FIELDS}

    def get(self, key: str, default: Any = None) -> Any:
        return self.raw.get(key, default)

    def args(self) -> List[str]:
        """Arg components parsed back out of the GB name.

        Components that are ``name:value`` or pure numbers; leading
        scope/family path components are skipped.
        """
        out = []
        for part in self.name.split("/")[1:]:
            if ":" in part or part.replace(".", "", 1).isdigit():
                out.append(part)
        return out

    @property
    def params(self) -> Dict[str, str]:
        """Typed parameters parsed back out of the instance name: every
        ``axis:value`` component as a string-valued mapping.

        Parsed from ``run_name`` (falling back to ``name``) so aggregate
        records — whose display name carries a ``_mean``/``_stddev``
        suffix — resolve to their instance's parameters, not to a
        corrupted trailing axis value.
        """
        from repro_torch.core.benchmark import name_params
        return name_params(self.raw.get("run_name") or self.name)

    def arg(self, key_or_index: Union[str, int]) -> Optional[str]:
        parts = self.args()
        if isinstance(key_or_index, int):
            return parts[key_or_index] if key_or_index < len(parts) else None
        for p in parts:
            if p.startswith(key_or_index + ":"):
                return p.split(":", 1)[1]
        return None


@dataclass
class BenchmarkFile:
    """A whole GB-JSON document: ``context`` + ``benchmarks``."""
    context: Dict[str, Any] = field(default_factory=dict)
    records: List[BenchmarkRecord] = field(default_factory=list)

    # -- I/O ------------------------------------------------------------
    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "BenchmarkFile":
        return cls(context=doc.get("context", {}),
                   records=[BenchmarkRecord(b)
                            for b in doc.get("benchmarks", [])])

    def to_dict(self) -> Dict[str, Any]:
        return {"context": self.context,
                "benchmarks": [r.raw for r in self.records]}

    def save(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    # -- merged-shard documents (repro_torch.core.orchestrate) ----------------
    def shards(self) -> List[Dict[str, Any]]:
        """Per-scope shard metadata of an orchestrator-merged document
        (``[]`` for plain single-run documents)."""
        return list(self.context.get("shards", []))

    def scope_names(self) -> List[str]:
        out: List[str] = []
        for r in self.records:
            s = r.scope
            if s and s not in out:
                out.append(s)
        return out

    def for_scope(self, scope: str) -> "BenchmarkFile":
        """Slice a merged document back into one scope's records."""
        return BenchmarkFile(
            context=self.context,
            records=[r for r in self.records if r.scope == scope],
        )

    # -- manipulation ------------------------------------------------
    def filter_name(self, pattern: str) -> "BenchmarkFile":
        """Paper §V-A.5: keep only records whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return BenchmarkFile(
            context=self.context,
            records=[r for r in self.records if rx.search(r.name)],
        )

    def filter_params(self, params: Dict[str, Any]) -> "BenchmarkFile":
        """Keep records whose name carries every ``axis:value`` pair
        (values compared as strings; a list of values ORs together) —
        the ``--param`` selection applied to a loaded document."""
        def keep(r: BenchmarkRecord) -> bool:
            have = r.params
            for k, want in params.items():
                accepted = [str(v) for v in (
                    want if isinstance(want, (list, tuple)) else [want])]
                if have.get(k) not in accepted:
                    return False
            return True
        return BenchmarkFile(context=self.context,
                             records=[r for r in self.records if keep(r)])

    def param_values(self, key: str) -> List[str]:
        """Distinct values of one parameter axis, in first-seen order —
        what a ``group_by`` spec series expands over."""
        out: List[str] = []
        for r in self.records:
            v = r.params.get(key)
            if v is not None and v not in out:
                out.append(v)
        return out

    def without_aggregates(self) -> "BenchmarkFile":
        return BenchmarkFile(
            context=self.context,
            records=[r for r in self.records
                     if r.get("run_type") != "aggregate"],
        )

    def without_errors(self) -> "BenchmarkFile":
        return BenchmarkFile(
            context=self.context,
            records=[r for r in self.records
                     if not r.get("error_occurred")
                     and not r.get("skipped")],
        )

    def transform(self, field: str, fn) -> "BenchmarkFile":
        """Per-series data transformation (spec files use eval exprs)."""
        out = []
        for r in self.records:
            raw = dict(r.raw)
            if field in raw:
                raw[field] = fn(raw[field])
            out.append(BenchmarkRecord(raw))
        return BenchmarkFile(context=self.context, records=out)

    # -- conversion ------------------------------------------------------
    def to_frame(self, fields: Optional[List[str]] = None) -> Frame:
        """Paper: "converting them to pandas DataFrames"."""
        if not self.records:
            return Frame({})
        if fields is None:
            keys: List[str] = []
            for r in self.records:
                for k in r.raw:
                    if k not in keys:
                        keys.append(k)
            fields = keys
        cols = {k: [r.raw.get(k) for r in self.records] for k in fields}
        return Frame(cols)

    def xy(self, x: str, y: str = "real_time"):
        """Extract (x, y) series; x may be a name-arg (``n``), a record
        field, or the computed field ``real_time_s`` (real_time
        normalized to seconds across time units)."""
        def value(r: BenchmarkRecord, key: str):
            if key == "real_time_s":
                return r.real_time_seconds()
            v = r.get(key)
            return v if v is not None else r.arg(key)

        xs, ys = [], []
        for r in self.records:
            if r.get("run_type") == "aggregate":
                continue
            xv = value(r, x)
            yv = value(r, y)
            if xv is None or yv is None:
                continue
            try:
                xv = float(xv)
            except (TypeError, ValueError):
                pass
            xs.append(xv)
            ys.append(float(yv))
        return xs, ys

    def __iter__(self) -> Iterator[BenchmarkRecord]:
        return iter(self.records)

    def __len__(self) -> int:
        return len(self.records)


def load(path) -> BenchmarkFile:
    """Load a GB-JSON document, or an orchestrator run directory
    (``results/<run-id>/``): its ``merged.json`` when present, else the
    structure-preserving :func:`cat` of every shard in it.  Both
    scope-grained (``<scope>.json``) and benchmark-grained
    (``shards/<instance>.json``, ordered by ``manifest.json``) run
    directories load the same way."""
    import os
    if os.path.isdir(path):
        merged = os.path.join(path, "merged.json")
        if os.path.exists(merged):
            path = merged
        else:
            from repro_torch.core.baseline import run_dir_shard_files
            shards = run_dir_shard_files(path)
            if not shards:
                raise FileNotFoundError(f"no result JSON in {path}")
            return cat([load(p) for p in shards])
    with open(path) as f:
        return BenchmarkFile.from_dict(json.load(f))


def loads(text: str) -> BenchmarkFile:
    return BenchmarkFile.from_dict(json.loads(text))


def cat(files: Iterable[BenchmarkFile]) -> BenchmarkFile:
    """Paper §V-A.4: structure-preserving concatenation.

    Unix ``cat`` would append JSON bodies and yield a malformed result;
    this concatenates the ``benchmarks`` arrays under the first context.
    """
    files = list(files)
    if not files:
        return BenchmarkFile()
    out = BenchmarkFile(context=dict(files[0].context))
    for f in files:
        out.records.extend(f.records)
    return out


def filter_name(f: BenchmarkFile, pattern: str) -> BenchmarkFile:
    return f.filter_name(pattern)
