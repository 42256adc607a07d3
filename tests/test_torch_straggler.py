"""The port's straggler watchdog and data reassignment
(``repro_torch.distributed.straggler``, a copy): tests/test_straggler.py's
checks, and the port's flags and offsets equal to the reference's on
the same traces."""
import numpy as np
import pytest

from repro.distributed.straggler import DataReassigner as RefReassigner
from repro.distributed.straggler import StragglerConfig as RefConfig
from repro.distributed.straggler import StragglerWatchdog as RefWatchdog
from repro_torch.distributed import (DataReassigner, StragglerConfig,
                                     StragglerWatchdog)


def test_detects_persistent_straggler():
    wd = StragglerWatchdog(4, StragglerConfig(threshold=1.5, patience=3))
    flagged = []
    for _ in range(10):
        flagged += wd.record_step(np.asarray([1.0, 1.0, 1.0, 3.0]))
    assert flagged == [3]
    assert wd.flagged == [3]
    wd.clear(3)
    assert wd.flagged == []


def test_transient_spike_not_flagged():
    wd = StragglerWatchdog(4, StragglerConfig(threshold=1.5, patience=3))
    for i in range(10):
        times = np.asarray([1.0, 1.0, 1.0, 4.0 if i == 5 else 1.0])
        assert wd.record_step(times) == []


def test_reassigner_offsets_complete_and_monotonic():
    ra = DataReassigner(global_batch=64, num_hosts=4)
    ra.derate(2, 0.5)
    off = ra.offsets()
    assert off[0] == 0 and off[-1] == 64
    assert all(off[i] <= off[i + 1] for i in range(len(off) - 1))
    sizes = np.diff(off)
    assert sizes[2] < sizes[0]
    covered = sum((ra.slice_for(h).stop - ra.slice_for(h).start)
                  for h in range(4))
    assert covered == 64


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_watchdog_and_reassigner_match_reference(seed):
    rng = np.random.default_rng(seed)
    cfg = dict(threshold=1.3, patience=2, ema=0.8)
    port, ref = (StragglerWatchdog(6, StragglerConfig(**cfg)),
                 RefWatchdog(6, RefConfig(**cfg)))
    for _ in range(30):
        times = rng.gamma(4.0, 0.25, 6) * np.where(rng.random(6) < 0.2,
                                                   2.5, 1.0)
        assert port.record_step(times) == ref.record_step(times)
    assert port.flagged == ref.flagged
    ra, rra = DataReassigner(96, 6), RefReassigner(96, 6)
    for h in port.flagged:
        ra.derate(h, 0.5)
        rra.derate(h, 0.5)
    np.testing.assert_array_equal(ra.offsets(), rra.offsets())
