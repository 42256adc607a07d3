"""Percentile statistics for per-sample meters (torch/numpy-free).

A copy of ``repro.core.quantile``.  Means are the wrong statistic for
millions-of-users traffic; the latency meter
(:mod:`repro_torch.core.measure`) reports tails instead.  Two
estimators live here:

  * :func:`percentile` — the exact linear-interpolation quantile
    (numpy's default method, reimplemented so workers never import an
    array library for a handful of floats).  Exact answers are what
    land on records: per-batch sample counts are small enough that
    exactness is free;
  * :class:`StreamingQuantile` — the P² algorithm (Jain & Chlamtac
    1985): a single quantile tracked in O(1) memory with five markers,
    exact below five samples.  This is the estimator a fleet-scale
    sample channel would switch to when per-request sample lists stop
    fitting in memory; tests pin its agreement with the exact path.

Merging: per-shard sample lists combine with :func:`combine` (a sort —
order- and grouping-invariant by construction), so percentiles computed
from ``combine(a, b)`` and ``combine(b, a)`` are byte-identical however
the orchestrator sharded the work.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Sequence

#: The tail grid the latency meter reports, as (suffix, quantile).
TAIL_QUANTILES = (("p50", 0.50), ("p90", 0.90), ("p99", 0.99),
                  ("p999", 0.999))


def percentile(samples: Sequence[float], q: float) -> float:
    """Exact quantile ``q`` in [0, 1] with linear interpolation.

    Matches ``numpy.percentile(..., method="linear")``.  Raises
    ``ValueError`` on an empty sample set — callers decide what an
    absent measurement means; this function never invents a number.
    """
    if not 0.0 <= q <= 1.0:
        raise ValueError(f"quantile must be in [0, 1] (got {q!r})")
    if not samples:
        raise ValueError("percentile of an empty sample set")
    xs = sorted(float(v) for v in samples)
    if len(xs) == 1:
        return xs[0]
    h = (len(xs) - 1) * q
    lo = int(h)
    hi = min(lo + 1, len(xs) - 1)
    frac = h - lo
    return xs[lo] + (xs[hi] - xs[lo]) * frac


def tail_percentiles(samples: Sequence[float],
                     prefix: str = "") -> Dict[str, float]:
    """The standard tail grid (p50/p90/p99/p999) as counter-ready keys:
    ``{prefix}p50_s`` ... — empty dict on no samples."""
    if not samples:
        return {}
    xs = sorted(float(v) for v in samples)
    return {f"{prefix}{suffix}_s": percentile(xs, q)
            for suffix, q in TAIL_QUANTILES}


def combine(*sample_lists: Iterable[float]) -> List[float]:
    """Merge per-shard sample lists into one canonical (sorted) list.

    Sorting makes the merge order- and grouping-invariant: percentiles
    over ``combine(a, b, c)`` equal those over ``combine(c, combine(b,
    a))`` byte-for-byte, which is what keeps latency counters identical
    across ``--jobs``/``--shard-grain`` choices.
    """
    out: List[float] = []
    for xs in sample_lists:
        out.extend(float(v) for v in xs)
    out.sort()
    return out


class StreamingQuantile:
    """P² single-quantile estimator (Jain & Chlamtac 1985), O(1) memory.

    Five markers track (min, q/2, q, (1+q)/2, max); each observation
    adjusts marker heights with a piecewise-parabolic fit.  Below five
    observations the estimate is exact (sorted buffer).  Duplicates and
    constant streams are handled by the linear fallback the paper
    specifies (the parabolic step is skipped when it would leave the
    bracket).
    """

    def __init__(self, q: float):
        if not 0.0 < q < 1.0:
            raise ValueError(f"streaming quantile needs 0 < q < 1 "
                             f"(got {q!r})")
        self.q = q
        self._n = 0
        self._heights: List[float] = []          # marker heights
        self._pos: List[float] = []              # actual positions
        self._want: List[float] = []             # desired positions
        self._inc = (0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0)

    @property
    def count(self) -> int:
        return self._n

    def observe(self, x: float) -> None:
        x = float(x)
        self._n += 1
        if self._n <= 5:
            self._heights.append(x)
            self._heights.sort()
            if self._n == 5:
                self._pos = [1.0, 2.0, 3.0, 4.0, 5.0]
                self._want = [1.0, 1.0 + 2.0 * self.q, 1.0 + 4.0 * self.q,
                              3.0 + 2.0 * self.q, 5.0]
            return
        h = self._heights
        # locate the cell and bump marker positions above it
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = next(i for i in range(4) if h[i] <= x < h[i + 1])
        for i in range(k + 1, 5):
            self._pos[i] += 1.0
        for i in range(5):
            self._want[i] += self._inc[i]
        # adjust the three interior markers toward their desired spots
        for i in (1, 2, 3):
            d = self._want[i] - self._pos[i]
            if (d >= 1.0 and self._pos[i + 1] - self._pos[i] > 1.0) or \
                    (d <= -1.0 and self._pos[i - 1] - self._pos[i] < -1.0):
                step = 1.0 if d >= 1.0 else -1.0
                cand = self._parabolic(i, step)
                if not h[i - 1] < cand < h[i + 1]:
                    cand = self._linear(i, step)
                h[i] = cand
                self._pos[i] += step

    def _parabolic(self, i: int, d: float) -> float:
        h, p = self._heights, self._pos
        return h[i] + d / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + d) * (h[i + 1] - h[i])
            / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - d) * (h[i] - h[i - 1])
            / (p[i] - p[i - 1]))

    def _linear(self, i: int, d: float) -> float:
        h, p = self._heights, self._pos
        j = i + int(d)
        return h[i] + d * (h[j] - h[i]) / (p[j] - p[i])

    def value(self) -> float:
        """Current estimate; exact (interpolated) below five samples."""
        if self._n == 0:
            raise ValueError("streaming quantile has no observations")
        if self._n < 5:
            return percentile(self._heights, self.q)
        return self._heights[2]
