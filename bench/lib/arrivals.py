"""Open-loop arrival processes: the benchmark's copy of the port's
``repro_torch.core.arrivals`` (itself a copy of the JAX package's), so
that the yardstick does not move when the program does.

Each generator returns ``n`` sorted arrival offsets in seconds and draws
only from ``random.Random(seed)``, so a (kind, rate, n, seed) tuple
gives the same offsets on every machine.
"""
from __future__ import annotations

import math
import random
from typing import List

#: Generator names accepted by :func:`generate`.
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
    """Dispatch on a generator name.

    Raises ``ValueError`` (with the available set) on an unknown kind.
    """
    if kind == "poisson":
        return poisson(rate, n, seed)
    if kind == "bursty":
        return bursty(rate, n, seed)
    if kind == "diurnal":
        return diurnal(rate, n, seed)
    raise ValueError(f"unknown arrival process {kind!r} "
                     f"(available: {', '.join(ARRIVAL_KINDS)})")
