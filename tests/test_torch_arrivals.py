"""The port's open-loop arrival generators against the JAX package's.

``repro_torch.core.arrivals`` is a copy of the reference's jax-free
module: the same generators draw the same ``random.Random(seed)``
streams, so every (kind, rate, n, seed) must give the reference's
offsets exactly (float equality, not a tolerance), in this process and
in a fresh one.
"""
import os
import subprocess
import sys

import pytest

from repro.core import arrivals as ref
from repro_torch.core import arrivals

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_kinds_match_reference():
    assert arrivals.ARRIVAL_KINDS == ref.ARRIVAL_KINDS


@pytest.mark.parametrize("seed", [0, 5, 123])
@pytest.mark.parametrize("kind", ref.ARRIVAL_KINDS)
def test_offsets_equal_reference(kind, seed):
    got = arrivals.generate(kind, 4.0, 64, seed)
    assert got == ref.generate(kind, 4.0, 64, seed)
    assert len(got) == 64 and all(a <= b for a, b in zip(got, got[1:]))


@pytest.mark.parametrize("kwargs", [
    {"burst_factor": 8.0, "idle_factor": 0.1, "mean_sojourn": 0.05},
    {"burst_factor": 1.0, "idle_factor": 1.0},
])
def test_bursty_knobs_equal_reference(kwargs):
    assert arrivals.bursty(20.0, 100, 3, **kwargs) == \
        ref.bursty(20.0, 100, 3, **kwargs)


@pytest.mark.parametrize("kwargs", [{"period": 0.5, "floor": 0.05},
                                    {"period": 10.0, "floor": 1.0}])
def test_diurnal_knobs_equal_reference(kwargs):
    assert arrivals.diurnal(50.0, 100, 4, **kwargs) == \
        ref.diurnal(50.0, 100, 4, **kwargs)


@pytest.mark.parametrize("call", [
    lambda m: m.poisson(rate=0.0, n=5),
    lambda m: m.poisson(rate=1.0, n=-1),
    lambda m: m.bursty(rate=1.0, n=5, burst_factor=0.0),
    lambda m: m.bursty(rate=1.0, n=5, idle_factor=-1.0),
    lambda m: m.diurnal(rate=1.0, n=5, floor=0.0),
    lambda m: m.diurnal(rate=1.0, n=5, floor=1.5),
    lambda m: m.generate("uniform", rate=1.0, n=5),
])
def test_validation_errors_equal_reference(call):
    with pytest.raises(ValueError) as want:
        call(ref)
    with pytest.raises(ValueError) as got:
        call(arrivals)
    assert str(got.value) == str(want.value)


def test_zero_requests_is_empty():
    for kind in arrivals.ARRIVAL_KINDS:
        assert arrivals.generate(kind, 5.0, 0) == []


def test_replay_in_a_fresh_process_equals_reference():
    """A fresh interpreter that imports only the port's module (neither
    jax nor ``repro`` gets loaded) reproduces the reference's floats."""
    code = ("import sys;"
            "from repro_torch.core.arrivals import ARRIVAL_KINDS, generate;"
            "print(repr([generate(k, 16.0, 10, seed=5)"
            " for k in ARRIVAL_KINDS]));"
            "print(sorted(m for m in ('jax', 'repro')"
            " if m in sys.modules))")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(ROOT, "src")] + ([env["PYTHONPATH"]]
                                       if env.get("PYTHONPATH") else []))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, check=True,
                         timeout=120)
    offsets, loaded = out.stdout.strip().splitlines()
    assert offsets == repr([ref.generate(k, 16.0, 10, seed=5)
                            for k in ref.ARRIVAL_KINDS])
    assert loaded == "[]"
