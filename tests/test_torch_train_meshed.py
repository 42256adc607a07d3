"""The meshed trainer (``repro_torch.launch.train`` under a launcher's
group) against the one-process trainer, on gloo ranks.

Each test spawns its ranks (``torch_ranks.run_ranks``, under a
deadline); rank 0 first runs the one-process ``train()`` (no group:
plain tensors on the CPU), then every rank joins one gloo group and
runs ``train()`` again, now on the ``(data, model)`` host mesh with the
state as DTensors.  Both save their last state (a sharded checkpoint
from the meshed run), and the test holds the meshed run to the
one-process run within ``PERF.md``'s training limits: each step's loss
within 1e-4, grad_norm within 1e-4 relative, lr within 1e-7; every
parameter within 6·lr, 99.9 % of them within 1e-5.  Reduced
llama3.2-1b with 2 layers and reduced deepseek-moe-16b (the
expert-parallel ``moe_shard_map``, forward and backward), float32.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch_ranks import run_ranks

from repro_torch.checkpoint import CheckpointManager, load_checkpoint
from repro_torch.checkpoint.store import load_manifest
from repro_torch.launch import train as train_mod
from repro_torch.models import get_config, tree

LOSS_TOL, NORM_RTOL, LR_TOL = 1e-4, 1e-4, 1e-7
PARAM_TOL, PARAM_SHARE = 1e-5, 0.999
LR = 1e-3
LLAMA = ("llama3.2-1b", {"num_layers": 2, "dtype": "float32"})
MOE = ("deepseek-moe-16b", {"num_layers": 2, "dtype": "float32"})


def _kw(arch, overrides, steps, ckpt_dir, **extra):
    return dict(arch=arch, steps=steps, global_batch=4, seq_len=32, lr=LR,
                ckpt_dir=ckpt_dir, ckpt_every=steps, log_every=100, seed=3,
                overrides=overrides, device="cpu", **extra)


def _ranks(rank, world, store, out, ref_kw, kw, model_parallel):
    """Rank 0's one-process run (``ref_kw``), then every rank's meshed
    run (``kw``); each run's history written under ``out``."""
    from repro_torch.launch.train import train
    if rank == 0 and ref_kw is not None:
        res = train(**ref_kw)
        with open(os.path.join(out, "ref.json"), "w") as f:
            json.dump(res["history"], f)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    res = train(model_parallel=model_parallel, **kw)
    if rank == 0:
        with open(os.path.join(out, f"mesh{world}.json"), "w") as f:
            json.dump(res["history"], f)


def _spawn(tmp_path, world, ref_kw, kw, model_parallel):
    run_ranks(_ranks, world, tmp_path, world, str(tmp_path / f"s{world}"),
              str(tmp_path), ref_kw, kw, model_parallel, join_group=False)


def _history(tmp_path, name):
    return json.loads((tmp_path / f"{name}.json").read_text())


def _params(arch, overrides, ckpt_dir):
    cfg = get_config(arch).reduced().override(**overrides)
    mgr = CheckpointManager(ckpt_dir)
    state, _ = load_checkpoint(mgr.path_for(mgr.latest_step()),
                               train_mod._state_like(cfg))
    return state["params"]


def _hold(got_hist, want_hist, got_params, want_params):
    assert [h["step"] for h in got_hist] == [h["step"] for h in want_hist]
    for g, w in zip(got_hist, want_hist):
        assert abs(g["loss"] - w["loss"]) <= LOSS_TOL, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) \
            <= NORM_RTOL * w["grad_norm"], (g, w)
        assert abs(g["lr"] - w["lr"]) <= LR_TOL, (g, w)
    diff = np.concatenate([(a - b).abs().reshape(-1).numpy() for a, b in
                           zip(tree.flatten(got_params),
                               tree.flatten(want_params))])
    assert diff.max() <= 6 * LR, diff.max()
    assert (diff <= PARAM_TOL).mean() >= PARAM_SHARE, (diff > PARAM_TOL).mean()


@pytest.mark.parametrize("mesh_shape,microbatches", [
    ((2, 2), 1), ((1, 4), 1), ((2, 2), 2)])
def test_meshed_train_matches_one_process(tmp_path, mesh_shape,
                                          microbatches):
    arch, ovr = LLAMA
    ref = _kw(arch, ovr, 3, str(tmp_path / "ref"), microbatches=microbatches)
    mesh = _kw(arch, ovr, 3, str(tmp_path / "mesh"),
               microbatches=microbatches)
    _spawn(tmp_path, 4, ref, mesh, mesh_shape[1])
    _hold(_history(tmp_path, "mesh4"), _history(tmp_path, "ref"),
          _params(arch, ovr, mesh["ckpt_dir"]),
          _params(arch, ovr, ref["ckpt_dir"]))
    manifest = load_manifest(os.path.join(mesh["ckpt_dir"], "step_3"))
    assert manifest["process_count"] == 4
    # a leaf split over both mesh axes has a shard from every rank
    shards = {len(e["shards"]) for e in manifest["leaves"].values()}
    assert max(shards) == 4 and min(shards) == 1


def test_halted_on_four_ranks_resumes_on_two(tmp_path):
    """The elastic restart: halted at step 2 of 4 on (2, 2) with a
    sharded checkpoint, resumed on a (1, 2) mesh of two ranks."""
    arch, ovr = LLAMA
    ckpt = str(tmp_path / "mesh")
    ref = _kw(arch, ovr, 4, str(tmp_path / "ref"))
    halted = _kw(arch, ovr, 4, ckpt, halt_at=2)
    halted["ckpt_every"] = 2
    _spawn(tmp_path, 4, ref, halted, 2)
    assert load_manifest(os.path.join(ckpt, "step_2"))["process_count"] == 4
    _spawn(tmp_path, 2, None, _kw(arch, ovr, 4, ckpt), 2)
    first, rest = _history(tmp_path, "mesh4"), _history(tmp_path, "mesh2")
    assert [h["step"] for h in first] == [0, 1]
    assert [h["step"] for h in rest] == [2, 3]
    _hold(first + rest, _history(tmp_path, "ref"),
          _params(arch, ovr, ckpt), _params(arch, ovr, ref["ckpt_dir"]))


def test_moe_step_on_an_expert_parallel_mesh(tmp_path):
    """deepseek-moe-16b reduced on (2, 2): its 4 experts split over
    'model', so the step runs ``moe_shard_map`` forward and backward."""
    arch, ovr = MOE
    cfg = get_config(arch).reduced()
    assert cfg.moe_num_experts % 2 == 0 and cfg.moe_dispatch == "scatter"
    ref = _kw(arch, ovr, 1, str(tmp_path / "ref"))
    mesh = _kw(arch, ovr, 1, str(tmp_path / "mesh"))
    _spawn(tmp_path, 4, ref, mesh, 2)
    _hold(_history(tmp_path, "mesh4"), _history(tmp_path, "ref"),
          _params(arch, ovr, mesh["ckpt_dir"]),
          _params(arch, ovr, ref["ckpt_dir"]))


def test_model_parallel_without_a_launcher_exits_2(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert train_mod.main(["--arch", "llama3.2-1b", "--model-parallel", "2",
                           "--steps", "1", "--device", "cpu"]) == 2
    with pytest.raises(ValueError, match="do not split into model=2"):
        train_mod.check_split(1, 2)
    assert not torch.distributed.is_initialized() or \
        torch.distributed.get_world_size() == 1
