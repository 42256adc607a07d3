"""What the metric readers under ``bench/metrics/`` share.

A reader takes the run's record (what the run logged on the host's
clock, the program's stamps and, in a traced run, the trace's numbers
from :mod:`bench.lib.trace`) and returns a number, or None where the
record holds nothing for it; a share is in percent.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

from .trace import gemm_least_seconds

Record = Dict[str, Any]


def percentile(samples: Sequence[float], q: float) -> float:
    """Quantile ``q`` in [0, 1] with linear interpolation (numpy's
    default; the benchmark's copy of ``repro_torch.core.quantile``)."""
    xs = sorted(float(v) for v in samples)
    if not xs:
        raise ValueError("percentile of an empty sample set")
    h = (len(xs) - 1) * q
    lo = int(h)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (h - lo)


def mean(xs: Sequence[float]) -> Optional[float]:
    return sum(xs) / len(xs) if xs else None


def unprofiled(rec: Record) -> List[Dict[str, Any]]:
    """The window's steps that ran without the profiler."""
    return [s for s in rec["steps"] if not s.get("profiled")]


def decode_steps(rec: Record) -> List[Dict[str, Any]]:
    """Unprofiled serve steps that admitted nothing."""
    return [s for s in unprofiled(rec) if s["admitted"] == 0]


def idle_share(rec: Record) -> Optional[float]:
    """1 - the device's busy time over the traced steps' wall, in %."""
    t = rec.get("trace") or {}
    if t.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def gemm_roofline(rec: Record) -> Optional[float]:
    """The traced GEMM calls' least time on the card over their device
    time, in %."""
    t = rec.get("trace") or {}
    if "gemms" not in t:
        return None
    least = dev = 0.0
    for call in t["gemms"]:
        s = gemm_least_seconds(call, rec["peaks"], rec["tf32"])
        if s is not None and call["device_s"] > 0:
            least += s
            dev += call["device_s"]
    return 100.0 * least / dev if dev > 0 else None


def decode_step_ms(rec: Record) -> Optional[float]:
    ms = [1e3 * (s["end"] - s["start"]) for s in decode_steps(rec)]
    return mean(ms)


def first_token_wait(r: Dict[str, Any], window: float) -> float:
    """Seconds from when the request was due to its first token, or to
    the window's close if it had none by then."""
    if r["first"] is not None and r["first"] <= window:
        return r["first"] - r["due"]
    return window - r["due"]


def delivered(r: Dict[str, Any], window: float) -> List[float]:
    """Times of the request's tokens delivered inside the window."""
    if r["first"] is None or r["first"] > window:
        return []
    return [r["first"]] + [s for s in r["stamps"] if s <= window]
