"""The torch port's checkpoint store (``repro_torch.checkpoint``) against
the JAX package's: a checkpoint written by either package loads in the
other with equal bits (bfloat16 compared as its uint16 payload), the
manifests agree key for key, and a flipped byte raises the checksum
error."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as ref_load
from repro.checkpoint import save_checkpoint as ref_save
from repro_torch.checkpoint import (load_checkpoint, load_manifest,
                                    save_checkpoint)
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
