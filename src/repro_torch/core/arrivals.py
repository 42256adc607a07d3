"""Open-loop arrival processes for serving benchmarks.

A copy of the reference's jax-free ``repro.core.arrivals``: the same
generators drawing the same ``random.Random(seed)`` streams, so a
(kind, rate, n, seed) tuple gives byte-identical offsets in both
packages.

Closed-loop load generators (send the next request when the previous
one returns) hide queueing: the generator slows down exactly when the
system does, so tail latency under overload is never exercised.  The
serve scope drives :class:`repro_torch.serve.ServeEngine` with **open-loop**
traffic instead — requests arrive on a schedule that does not care how
the server is doing — which is the only way p99/p999 and goodput under
an SLO mean anything (the continuous-benchmarking frameworks in
PAPERS.md all gate on tail behaviour, not means).

Three generators, each returning a sorted list of arrival *offsets* in
seconds from the start of the window:

  * :func:`poisson` — homogeneous Poisson process (i.i.d. exponential
    inter-arrivals at ``rate`` req/s), the classic memoryless baseline;
  * :func:`bursty` — Markov-modulated on/off process: an "on" state
    arriving at ``burst_factor × rate`` alternates with a quiet "off"
    state at ``idle_factor × rate``, with exponentially-distributed
    sojourn times.  Mean rate ≈ the requested ``rate``; the variance is
    what stresses admission and queue depth;
  * :func:`diurnal` — inhomogeneous Poisson via thinning: the rate
    ramps sinusoidally between ``floor × rate`` and ``rate`` over one
    ``period`` (a compressed day), modelling the ramp-up/ramp-down
    shape production traffic actually has.

Determinism contract: every generator draws only from
``random.Random(seed)`` — the Mersenne-Twister stream is specified by
CPython, so a (kind, rate, n, seed) tuple replays **byte-identical**
traces across processes, machines and shard workers.  Nothing here
imports torch or numpy: the module must stay importable (and cheap) in
any worker, and traces must never depend on array-library versions.
"""
from __future__ import annotations

import math
import random
from typing import List

#: Generator names accepted by :func:`generate` (a serve-scope axis).
ARRIVAL_KINDS = ("poisson", "bursty", "diurnal")


def _check(rate: float, n: int) -> None:
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0 req/s (got {rate!r})")
    if n < 0:
        raise ValueError(f"arrival count must be >= 0 (got {n!r})")


def poisson(rate: float, n: int, seed: int = 0) -> List[float]:
    """``n`` arrival offsets of a Poisson process at ``rate`` req/s."""
    _check(rate, n)
    rng = random.Random(seed)
    t = 0.0
    out: List[float] = []
    for _ in range(n):
        t += rng.expovariate(rate)
        out.append(t)
    return out


def bursty(rate: float, n: int, seed: int = 0, *,
           burst_factor: float = 4.0, idle_factor: float = 0.25,
           mean_sojourn: float = 0.25) -> List[float]:
    """Markov-modulated on/off arrivals averaging ``rate`` req/s.

    Two states alternate with exponential sojourn times of mean
    ``mean_sojourn`` seconds: "on" arrives at ``burst_factor * rate``,
    "off" at ``idle_factor * rate``.  Inter-arrival draws use the
    current state's rate; a draw that overshoots the state's remaining
    sojourn rolls into the next state (re-drawn at the new rate from
    the leftover time's survival — memorylessness makes the simple
    re-draw exact).
    """
    _check(rate, n)
    if burst_factor <= 0 or idle_factor <= 0:
        raise ValueError("burst_factor and idle_factor must be > 0")
    rng = random.Random(seed)
    t = 0.0
    state_on = True
    state_end = rng.expovariate(1.0 / mean_sojourn)
    out: List[float] = []
    while len(out) < n:
        lam = rate * (burst_factor if state_on else idle_factor)
        gap = rng.expovariate(lam)
        if t + gap < state_end:
            t += gap
            out.append(t)
        else:
            # no arrival before the state flips: jump to the boundary
            # and restart the (memoryless) draw in the next state
            t = state_end
            state_on = not state_on
            state_end = t + rng.expovariate(1.0 / mean_sojourn)
    return out


def diurnal(rate: float, n: int, seed: int = 0, *,
            period: float = 2.0, floor: float = 0.2) -> List[float]:
    """Inhomogeneous Poisson arrivals with a sinusoidal daily ramp.

    The instantaneous rate is ``rate * (floor + (1-floor) *
    sin²(π t / period))`` — quiet at the window edges, peaking at
    ``rate`` mid-period — sampled exactly by Lewis-Shedler thinning
    against the ``rate`` envelope.
    """
    _check(rate, n)
    if not 0.0 < floor <= 1.0:
        raise ValueError(f"floor must be in (0, 1] (got {floor!r})")
    rng = random.Random(seed)
    t = 0.0
    out: List[float] = []
    while len(out) < n:
        t += rng.expovariate(rate)
        lam = floor + (1.0 - floor) * math.sin(math.pi * t / period) ** 2
        if rng.random() <= lam:
            out.append(t)
    return out


def generate(kind: str, rate: float, n: int, seed: int = 0) -> List[float]:
    """Dispatch on a generator name (the serve scope's ``arrival`` axis).

    Raises ``ValueError`` (with the available set) on an unknown kind —
    the same contract as ``validate_meter_name``.
    """
    if kind == "poisson":
        return poisson(rate, n, seed)
    if kind == "bursty":
        return bursty(rate, n, seed)
    if kind == "diurnal":
        return diurnal(rate, n, seed)
    raise ValueError(f"unknown arrival process {kind!r} "
                     f"(available: {', '.join(ARRIVAL_KINDS)})")
