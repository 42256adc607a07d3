"""Straggler detection & mitigation hooks.

A copy of the JAX package's ``distributed/straggler.py`` (numpy only),
kept in the port so that it imports nothing of that package.

At thousand-node scale, step time is gated by the slowest host.  This
watchdog implements the standard two-stage response:

  1. detect — per-step wall times per host, flag hosts whose EMA exceeds
     ``threshold`` × the cohort median for ``patience`` consecutive steps;
  2. mitigate — report → (operator/orchestrator) either reshards data away
     from the host (``DataReassigner``: shrink its slice of the global
     batch by re-slicing, a pure re-indexing of the deterministic
     pipeline) or evicts it and triggers the elastic-restart path
     (checkpoint → new mesh → restore_resharded).

On one host, host_count=1; the logic is exercised in tests by feeding
synthetic timing traces (the detection code path is the real one).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from repro_torch.core.logging import get_logger

log = get_logger("straggler")


@dataclass
class StragglerConfig:
    threshold: float = 1.5        # × median EMA
    patience: int = 5
    ema: float = 0.9


class StragglerWatchdog:
    def __init__(self, num_hosts: int, cfg: Optional[StragglerConfig] = None):
        self.cfg = cfg or StragglerConfig()
        self.num_hosts = num_hosts
        self._ema = np.zeros(num_hosts)
        self._strikes = np.zeros(num_hosts, np.int32)
        self._flagged: List[int] = []

    def record_step(self, host_times: np.ndarray) -> List[int]:
        """Feed per-host step seconds; returns hosts newly flagged."""
        a = self.cfg.ema
        first = self._ema.sum() == 0
        self._ema = host_times if first else a * self._ema + (1 - a) * host_times
        med = np.median(self._ema)
        slow = self._ema > self.cfg.threshold * med
        self._strikes = np.where(slow, self._strikes + 1, 0)
        newly = [int(h) for h in np.nonzero(
            self._strikes == self.cfg.patience)[0]
            if h not in self._flagged]
        for h in newly:
            self._flagged.append(h)
            log.warning("host %d flagged as straggler "
                        "(ema %.3fs vs median %.3fs)", h, self._ema[h], med)
        return newly

    @property
    def flagged(self) -> List[int]:
        return list(self._flagged)

    def clear(self, host: int) -> None:
        if host in self._flagged:
            self._flagged.remove(host)
            self._strikes[host] = 0


class DataReassigner:
    """Shrink flagged hosts' share of the global batch (work stealing).

    The deterministic pipeline makes this a pure re-indexing: host h's
    slice of batch i is (offset[h], offset[h+1]); reassignment just edits
    the offsets — no data movement, no state.
    """

    def __init__(self, global_batch: int, num_hosts: int):
        self.global_batch = global_batch
        self.num_hosts = num_hosts
        self.weights = np.ones(num_hosts)

    def derate(self, host: int, factor: float = 0.5) -> None:
        self.weights[host] *= factor

    def offsets(self) -> np.ndarray:
        w = self.weights / self.weights.sum()
        raw = np.floor(np.cumsum(np.concatenate([[0.0], w]))
                       * self.global_batch).astype(int)
        raw[-1] = self.global_batch
        return raw

    def slice_for(self, host: int) -> slice:
        off = self.offsets()
        return slice(int(off[host]), int(off[host + 1]))
