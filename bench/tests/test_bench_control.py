"""The control, at a size a test run can hold: the reference computed
with its products' operands in float8 (e4m3), put in the program's
place, comes out not correct; the program does not."""
import numpy as np
import pytest
import torch

from conftest import TINY_LIMITS, tiny_cell
from bench.kinds import serve, train

CPU = torch.device("cpu")


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_the_float8_control_fails_a_training_number(ref):
    cell = tiny_cell(ref, "train")
    seed = 2 ** 31 + 7
    ref32 = train.reference_steps(cell, seed, CPU)
    ctl = train.compare(
        train.reference_steps(cell, seed, CPU, numerics="float8_e4m3"), ref32)
    state, _step, _feed, prog = train.program_steps(cell, seed, CPU)
    sound = train.compare(prog, ref32)
    lim = TINY_LIMITS["train"]
    assert any(ctl[k] > lim[k] for k in lim), ctl
    assert all(sound[k] <= lim[k] for k in lim), sound


def test_the_float8_control_fails_the_served_gap():
    cell = tiny_cell("dense", "serve")
    seed = 2 ** 31 + 8
    rng = np.random.default_rng(0)
    seqs = [{"prompt": rng.integers(1, 256, size=n),
             "output": rng.integers(1, 256, size=12)} for n in (20, 40)]
    # the served tokens the reference itself puts first read a gap of 0
    from bench.lib.spec import reference
    from bench.reference.common import Numerics
    mod = reference(cell.config)
    m = cell.config["model"]
    params = mod.make_params(m, seed, CPU)
    for s in seqs:
        toks = torch.as_tensor(s["prompt"])
        out = []
        for _ in range(12):
            lg = mod.logits(m, params, toks, Numerics(),
                            torch.tensor([len(toks) - 1]))
            out.append(int(lg[0].argmax()))
            toks = torch.cat([toks, torch.tensor(out[-1:])])
        s["output"] = np.asarray(out)
    gaps = serve.token_gaps(cell, seed, CPU, seqs, numerics="float8_e4m3")
    assert gaps["served_gap"] == pytest.approx(0.0, abs=1e-5)
    assert gaps["control_gap"] > TINY_LIMITS["serve"]["served_gap"], gaps
