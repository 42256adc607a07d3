"""End-to-end training through the port's trainer
(``repro_torch.launch.train.train``, on the CPU): tests/test_train_loop.py's
three tests with the reference's arguments and bounds, and checkpoints
crossing between the packages: a state the reference saves (after
steps of its unsharded ``jax.jit(make_train_step(...))``) is resumed by
the port's trainer, whose next losses match the reference's own next
steps, and a checkpoint the port's trainer writes loads in the
reference's ``load_checkpoint`` with the reference's tree.

The reference's own ``train`` needs a mesh and fails on jax 0.9, so the
reference's side here is its unsharded step driven over its own data
pipeline.  Both sides compute in float32 (the override), where the
losses agree within 1e-4 (the train-step tests' bound).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro.data import DataConfig as RefDataConfig
from repro.data import make_pipeline as ref_make_pipeline
from repro.models import build as ref_build
from repro.models import get_config as ref_get_config
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train.step import make_init_fn as ref_make_init_fn
from repro_torch.checkpoint import load_checkpoint
from repro_torch.launch.train import main, train
from repro_torch.models import tree


def test_loss_decreases():
    out = train("llama3.2-1b", steps=25, global_batch=4, seq_len=64,
                lr=1e-3, log_every=100, device="cpu")
    assert out["steps"] == 25
    assert out["last_loss"] < out["first_loss"] - 0.05
    assert [h["step"] for h in out["history"]] == list(range(25))


def test_checkpoint_resume_exact(tmp_path):
    """Interrupted+resumed run ends at the same loss as uninterrupted —
    data pipeline resumability + checkpoint fidelity together."""
    full = train("llama3.2-1b", steps=14, global_batch=2, seq_len=32,
                 lr=1e-3, ckpt_dir=None, log_every=100, seed=5,
                 device="cpu")
    d2 = str(tmp_path / "b")
    half = train("llama3.2-1b", steps=14, global_batch=2, seq_len=32,
                 lr=1e-3, ckpt_dir=d2, ckpt_every=7, log_every=100, seed=5,
                 halt_at=7, device="cpu")
    assert half["steps"] == 7
    resumed = train("llama3.2-1b", steps=14, global_batch=2, seq_len=32,
                    lr=1e-3, ckpt_dir=d2, ckpt_every=7, log_every=100,
                    seed=5, device="cpu")
    assert resumed["history"][0]["step"] == 7
    assert abs(resumed["last_loss"] - full["last_loss"]) < 2e-3


def test_microbatched_matches_unbatched():
    a = train("llama3.2-1b", steps=6, global_batch=4, seq_len=32,
              lr=1e-3, microbatches=1, log_every=100, seed=9, device="cpu")
    b = train("llama3.2-1b", steps=6, global_batch=4, seq_len=32,
              lr=1e-3, microbatches=2, log_every=100, seed=9, device="cpu")
    assert abs(a["last_loss"] - b["last_loss"]) < 5e-3


ARCH, STEPS, GB, SEQ, LR, SEED = "llama3.2-1b", 6, 2, 32, 1e-3, 3
F32 = {"dtype": "float32"}


def reference_run(save_at=None, path=None):
    """The reference's unsharded step over its pipeline, as the port's
    ``train`` sets it up (schedule, data, seed).  Saves the state after
    ``save_at`` steps to ``path``; returns the losses."""
    cfg = ref_get_config(ARCH).reduced().override(**F32)
    api = ref_build(cfg)
    opt = RefAdamWConfig(lr=LR, total_steps=STEPS,
                         warmup_steps=max(STEPS // 20, 5))
    state = ref_make_init_fn(api, opt)(jax.random.PRNGKey(SEED))
    step_fn = jax.jit(ref_make_train_step(api, opt))
    pipe = ref_make_pipeline(RefDataConfig(
        vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=GB,
        seed=SEED), prefetch=False)
    losses = []
    for step, batch in pipe:
        if step >= STEPS:
            break
        if step == save_at:
            ref_save(path, jax.tree_util.tree_map(np.asarray, state), step)
        state, metrics = step_fn(state, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    return losses


def test_port_trainer_resumes_a_reference_checkpoint(tmp_path):
    ckpt = tmp_path / "ck"
    ckpt.mkdir()
    ref_losses = reference_run(save_at=3, path=str(ckpt / "step_3"))
    out = train(ARCH, steps=STEPS, global_batch=GB, seq_len=SEQ, lr=LR,
                ckpt_dir=str(ckpt), ckpt_every=100, seed=SEED,
                overrides=F32, device="cpu")
    got = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == [3, 4, 5]
    np.testing.assert_allclose(got, ref_losses[3:], atol=1e-4, rtol=0)


def test_port_checkpoint_loads_in_reference(tmp_path):
    ckpt = str(tmp_path / "ck")
    train(ARCH, steps=3, global_batch=GB, seq_len=SEQ, lr=LR,
          ckpt_dir=ckpt, ckpt_every=3, seed=SEED, overrides=F32,
          device="cpu")
    path = os.path.join(ckpt, "step_3")
    cfg = ref_get_config(ARCH).reduced().override(**F32)
    opt = RefAdamWConfig(lr=LR, total_steps=3, warmup_steps=5)
    like = jax.eval_shape(ref_make_init_fn(ref_build(cfg), opt),
                          jax.random.PRNGKey(0))
    ref_state, step = ref_load(path, like)
    assert step == 3 and int(ref_state["step"]) == 3
    assert int(ref_state["opt"]["count"]) == 3
    port_state, _ = load_checkpoint(path, ref_state)
    want = dict(tree.leaves(jax.tree_util.tree_map(np.asarray, ref_state)))
    structs = dict(tree.leaves(jax.tree_util.tree_map(
        lambda s: (tuple(s.shape), str(s.dtype)), like,
        is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))))
    got = dict(tree.leaves(port_state))
    assert got.keys() == want.keys() == structs.keys()
    for key, t in got.items():
        assert (tuple(t.shape), str(want[key].dtype)) == structs[key]
        np.testing.assert_array_equal(t.numpy(), want[key])


def test_model_parallel_is_not_ported():
    with pytest.raises(ValueError, match="not yet ported"):
        train(ARCH, steps=1, model_parallel=2, device="cpu")
    assert main(["--arch", ARCH, "--model-parallel", "2",
                 "--device", "cpu"]) == 2


def test_main_trains_on_the_cpu_and_needs_a_card_by_default(monkeypatch):
    assert main(["--arch", ARCH, "--steps", "2", "--global-batch", "2",
                 "--seq-len", "16", "--device", "cpu"]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--arch", ARCH, "--steps", "2"]) == 2
