"""A whole run of a cell at a CPU test's size, past the look for a card,
with the timed path broken underneath: ``correct`` comes out false for
each fault the cell can have, and true for the sound program."""
import time

import pytest
import torch

from conftest import tiny_cell
from bench.lib import harness, spec

PEAKS = spec.peaks("NVIDIA H100 80GB HBM3")
CPU = torch.device("cpu")


def _run(cell, seed=2 ** 31 + 99, seconds=1.0):
    out = harness.run_cell(cell, seed, seconds, False, CPU,
                           time.perf_counter(), PEAKS)
    return out["correct"], out["checks"]


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_sound_training_is_correct(ref):
    ok, checks = _run(tiny_cell(ref, "train"))
    assert ok, checks


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(ref, monkeypatch):
    import repro_torch.train.step as step

    def unchanged(cfg, grads, opt_state, params, schedule=None):
        return params, dict(opt_state, count=opt_state["count"] + 1), \
            torch.zeros(())
    monkeypatch.setattr(step, "adamw_update", unchanged)
    ok, checks = _run(tiny_cell(ref, "train"))
    assert not ok, checks
    assert checks["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_half_the_batch_left_out_is_caught(ref, monkeypatch):
    from repro_torch.models import ssm, transformer
    mod = transformer if ref == "dense" else ssm
    loss = mod.loss

    def half(cfg, params, batch):
        return loss(cfg, params, {k: v[: v.shape[0] // 2]
                                  for k, v in batch.items()})
    monkeypatch.setattr(mod, "loss", half)
    ok, checks = _run(tiny_cell(ref, "train"))
    assert not ok, checks


def test_sound_serving_is_correct():
    ok, checks = _run(tiny_cell("dense", "serve"), seconds=3.0)
    assert ok, checks


def test_a_token_altered_where_it_is_produced_is_caught(monkeypatch):
    from repro_torch.models import transformer
    decode = transformer.decode_step_ragged

    def altered(cfg, params, tokens, cache):
        logits, cache = decode(cfg, params, tokens, cache)
        return -logits, cache              # every row emits its worst token
    monkeypatch.setattr(transformer, "decode_step_ragged", altered)
    ok, checks = _run(tiny_cell("dense", "serve"), seconds=3.0)
    assert not ok, checks
