"""The torch port's checkpoint store (``repro_torch.checkpoint``) against
the JAX package's: a checkpoint written by either package loads in the
other with equal bits (bfloat16 compared as its uint16 payload), the
manifests agree key for key, and a flipped byte raises the checksum
error.  Then the manager: tests/test_checkpoint.py's manager tests
through the port, the snapshot an async save takes before the next
in-place step, and the preemption handler."""
import os
import signal
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    load_manifest, save_checkpoint)
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.checkpoint.store import _flatten


def _values():
    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 4)).astype(np.float32)
    bf16 = rng.standard_normal((5,)).astype(np.float32)
    return f32, bf16


def port_tree():
    f32, bf16 = _values()
    return {"b": {"w": torch.from_numpy(f32),
                  "h": torch.from_numpy(bf16).to(torch.bfloat16)},
            "a": [torch.arange(6, dtype=torch.int32).reshape(2, 3),
                  (torch.tensor(3, dtype=torch.int32), 2.5)],
            "step": 7, "none": None}


def ref_tree():
    f32, bf16 = _values()
    return {"b": {"w": jnp.asarray(f32),
                  "h": jnp.asarray(bf16, jnp.bfloat16)},
            "a": [jnp.arange(6, dtype=jnp.int32).reshape(2, 3),
                  (jnp.asarray(3, jnp.int32), 2.5)],
            "step": 7, "none": None}


def _bits(x):
    """A leaf's bytes as numpy: bfloat16 as its uint16 payload."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16)
    return arr


def _leaves_equal(port, ref):
    p, r = _flatten(port), _flatten(ref)
    assert [n for n, _ in p] == [n for n, _ in r]
    for (name, a), (_, b) in zip(p, r):
        a, b = _bits(a), _bits(b)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_leaf_names_follow_tree_flatten_with_path():
    assert [n for n, _ in _flatten(port_tree())] == \
        ["a/0", "a/1/0", "a/1/1", "b/h", "b/w", "step"]


def test_port_checkpoint_loads_in_reference(tmp_path):
    path = save_checkpoint(str(tmp_path / "ck"), port_tree(), step=11,
                           extra={"note": "port"})
    out, step = ref_load(path, ref_tree())
    assert step == 11
    _leaves_equal(port_tree(), out)
    assert load_manifest(path)["extra"] == {"note": "port"}


def test_reference_checkpoint_loads_in_port(tmp_path):
    path = ref_save(str(tmp_path / "ck"), ref_tree(), step=5)
    out, step = load_checkpoint(path, port_tree())
    assert step == 5
    _leaves_equal(out, ref_tree())
    assert out["b"]["h"].dtype == torch.bfloat16
    assert out["a"][1][1].dtype == torch.float64     # a Python float leaf
    assert isinstance(out["a"][1], tuple) and out["none"] is None
    # the port's own round trip keeps the structure and the bits
    again, _ = load_checkpoint(save_checkpoint(str(tmp_path / "p"), out,
                                               step=5), port_tree())
    _leaves_equal(again, ref_tree())


def test_manifests_agree_key_for_key(tmp_path):
    port = save_checkpoint(str(tmp_path / "port"), port_tree(), step=3)
    ref = ref_save(str(tmp_path / "ref"), ref_tree(), step=3)
    assert load_manifest(port) == load_manifest(ref)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in os.listdir(port):
        if name.endswith(".npy"):
            np.testing.assert_array_equal(np.load(os.path.join(port, name)),
                                          np.load(os.path.join(ref, name)))
    assert load_manifest(port)["leaves"]["b/h"]["dtype"] == "bfloat16"


def test_write_is_atomic(tmp_path):
    path = save_checkpoint(str(tmp_path / "ck"), port_tree())
    assert os.path.exists(path) and not os.path.exists(path + ".tmp")
    save_checkpoint(path, port_tree(), step=1)          # overwrite in place
    assert load_manifest(path)["step"] == 1


def test_flipped_byte_raises_checksum_error(tmp_path):
    path = save_checkpoint(str(tmp_path / "ck"), port_tree())
    shard = os.path.join(path, "b__h.shard0.npy")
    with open(shard, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        byte = f.read(1)
        f.seek(-1, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0x01]))
    with pytest.raises(IOError, match="checksum"):
        load_checkpoint(path, port_tree())
    out, _ = load_checkpoint(path, port_tree(), verify=False)
    assert out["b"]["h"].dtype == torch.bfloat16


def test_restore_into_different_structure_fails(tmp_path):
    path = save_checkpoint(str(tmp_path / "ck"), port_tree())
    with pytest.raises(KeyError):
        load_checkpoint(path, {"other": torch.zeros(3)})


# -- the manager (tests/test_checkpoint.py's manager tests) -------------

def manager_tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((5,), dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32)}}


def _corrupt_one_shard(path):
    shard = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    np.save(os.path.join(path, shard),
            np.load(os.path.join(path, shard)) + 1)


def test_manager_keep_k_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, save_interval=10,
                            async_save=False)
    t = manager_tree()
    assert not mgr.maybe_save(5, t)
    for step in (10, 20, 30):
        assert mgr.maybe_save(step, t)
    assert mgr.steps() == [20, 30]
    restored, step = mgr.restore_or_init(t, lambda: None)
    assert step == 30
    _leaves_equal(restored, t)


def test_manager_falls_through_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, save_interval=1,
                            async_save=False)
    t = manager_tree()
    mgr.maybe_save(1, t)
    mgr.maybe_save(2, t)
    _corrupt_one_shard(mgr.path_for(2))
    restored, step = mgr.restore_or_init(t, lambda: None)
    assert step == 1                      # older but valid
    _corrupt_one_shard(mgr.path_for(1))
    assert mgr.restore_or_init(t, lambda: "fresh") == ("fresh", 0)


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=1, async_save=True)
    mgr.maybe_save(1, manager_tree())
    mgr.wait()
    assert mgr.latest_step() == 1
    assert load_manifest(mgr.path_for(1))["step"] == 1


def test_async_save_keeps_values_from_before_an_in_place_step(
        tmp_path, monkeypatch):
    """The snapshot is taken when ``maybe_save`` returns: a step that
    writes the tensors in place right after it does not reach the
    files, even when the writer thread runs only after that step."""
    release = threading.Event()
    real_save = manager_mod.save_checkpoint

    def held_save(*args, **kwargs):
        assert release.wait(timeout=30)
        return real_save(*args, **kwargs)
    monkeypatch.setattr(manager_mod, "save_checkpoint", held_save)
    mgr = CheckpointManager(str(tmp_path), save_interval=1, async_save=True)
    t = manager_tree()
    want = _snapshot_values(t)
    assert mgr.maybe_save(1, t)
    with torch.no_grad():                 # the next step, in place
        t["a"].add_(100.0)
        t["b"]["c"].mul_(3)
        t["b"]["d"].add_(1)
    release.set()
    mgr.wait()
    out, step = load_checkpoint(mgr.path_for(1), t)
    assert step == 1
    _leaves_equal(out, want)


def _snapshot_values(t):
    return {"a": t["a"].clone(), "b": {"c": t["b"]["c"].clone(),
                                       "d": t["b"]["d"].clone()}}


def test_async_save_error_surfaces_in_wait(tmp_path, monkeypatch):
    def failing(*args, **kwargs):
        raise OSError("disk full")
    monkeypatch.setattr(manager_mod, "save_checkpoint", failing)
    mgr = CheckpointManager(str(tmp_path), save_interval=1, async_save=True)
    mgr.maybe_save(1, manager_tree())
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    assert mgr.latest_step() is None


def test_signal_handler_saves_then_exits(tmp_path):
    mgr = CheckpointManager(str(tmp_path), save_interval=100)
    t = manager_tree()
    before = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                               signal.SIGINT)}
    try:
        mgr.install_signal_handler(lambda: (7, t))
        with pytest.raises(SystemExit):
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
    finally:
        for s, h in before.items():
            signal.signal(s, h)
    assert mgr.steps() == [7]
    out, _ = load_checkpoint(mgr.path_for(7), t)
    _leaves_equal(out, t)


def test_manager_checkpoint_loads_in_reference(tmp_path):
    """What the manager writes is the store's format: the reference's
    loader reads it."""
    mgr = CheckpointManager(str(tmp_path), save_interval=1, async_save=False)
    mgr.maybe_save(3, manager_tree())
    like = {"a": jnp.zeros((3, 4), jnp.float32),
            "b": {"c": jnp.zeros((5,), jnp.bfloat16),
                  "d": jnp.zeros((), jnp.int32)}}
    out, step = ref_load(mgr.path_for(3), like)
    assert step == 3
    _leaves_equal(manager_tree(), out)


def test_snapshot_copies_every_tensor_leaf():
    from collections import namedtuple
    Pair = namedtuple("Pair", "a b")
    t = {"d": torch.ones(2), "l": [torch.ones(3)],
         "t": (torch.ones(1), 2.5), "n": Pair(torch.ones(4), None)}
    snap = manager_mod._snapshot(t)
    with torch.no_grad():
        for x in (t["d"], t["l"][0], t["t"][0], t["n"].a):
            x.add_(1)
    assert isinstance(snap["n"], Pair) and isinstance(snap["l"], list)
    assert snap["t"][1] == 2.5 and snap["n"].b is None
    for x in (snap["d"], snap["l"][0], snap["t"][0], snap["n"].a):
        assert torch.equal(x, torch.ones_like(x))
