"""A minimal columnar table — the pandas-DataFrame stand-in (a copy of
``repro.scopeplot.frame``).

pandas is not installable offline; ScopePlot's library API promises
dataframe conversion, so Frame implements the slice of the DataFrame
surface the plotting and analysis code needs: column access, row filtering,
group-by aggregation, sorting, and CSV export.
"""
from __future__ import annotations

import csv
import io
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np


class Frame:
    def __init__(self, columns: Dict[str, List[Any]]):
        lengths = {len(v) for v in columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: { {k: len(v) for k, v in columns.items()} }")
        self._cols: Dict[str, List[Any]] = {k: list(v)
                                            for k, v in columns.items()}
        self._n = next(iter(lengths)) if lengths else 0

    # -- basic access ---------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, key: str) -> List[Any]:
        return self._cols[key]

    def column(self, key: str, dtype=None) -> np.ndarray:
        vals = self._cols[key]
        return np.asarray(vals if dtype is None else vals, dtype=dtype)

    def row(self, i: int) -> Dict[str, Any]:
        return {k: v[i] for k, v in self._cols.items()}

    def rows(self) -> List[Dict[str, Any]]:
        return [self.row(i) for i in range(self._n)]

    # -- manipulation ------------------------------------------------
    def where(self, pred: Callable[[Dict[str, Any]], bool]) -> "Frame":
        idx = [i for i in range(self._n) if pred(self.row(i))]
        return self.take(idx)

    def take(self, idx: Sequence[int]) -> "Frame":
        return Frame({k: [v[i] for i in idx] for k, v in self._cols.items()})

    def sort_by(self, key: str, reverse: bool = False) -> "Frame":
        order = sorted(range(self._n), key=lambda i: self._cols[key][i],
                       reverse=reverse)
        return self.take(order)

    def with_column(self, name: str, values: List[Any]) -> "Frame":
        cols = dict(self._cols)
        cols[name] = list(values)
        return Frame(cols)

    def groupby(self, key: str, agg: Dict[str, Callable[[List[Any]], Any]]
                ) -> "Frame":
        groups: Dict[Any, List[int]] = {}
        for i, v in enumerate(self._cols[key]):
            groups.setdefault(v, []).append(i)
        out: Dict[str, List[Any]] = {key: []}
        for col in agg:
            out[col] = []
        for gval, idx in groups.items():
            out[key].append(gval)
            for col, fn in agg.items():
                out[col].append(fn([self._cols[col][i] for i in idx]))
        return Frame(out)

    # -- export ---------------------------------------------------------
    def to_csv(self, path: Optional[str] = None) -> str:
        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(self.columns)
        for i in range(self._n):
            w.writerow([self._cols[k][i] for k in self.columns])
        text = buf.getvalue()
        if path:
            with open(path, "w") as f:
                f.write(text)
        return text

    def __repr__(self) -> str:
        head = ", ".join(self.columns[:6])
        return f"Frame({self._n} rows: {head})"
