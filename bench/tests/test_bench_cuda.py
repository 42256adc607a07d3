"""The harness on the card at a test's size (skips without a card)."""
import time

import pytest

from conftest import tiny_cell
from bench.lib import harness, spec


@pytest.mark.cuda
@pytest.mark.parametrize("ref,kind", [("dense", "train"), ("mamba2", "train"),
                                      ("dense", "serve")])
def test_tiny_cells_run_on_the_card(cuda_device, ref, kind):
    import torch
    peaks = spec.peaks(torch.cuda.get_device_name(cuda_device))
    for trace in (False, True):
        out = harness.run_cell(tiny_cell(ref, kind), 2 ** 31 + 3, 2.0, trace,
                               cuda_device, time.perf_counter(), peaks)
        assert out["correct"], out["checks"]
        assert out["device"]["platform"] == "gpu"
        if trace:
            assert out["device"]["busy_s"] > 0
