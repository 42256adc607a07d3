"""Sharded checkpoints (``repro_torch.checkpoint.store``): each rank
writes its own shards, and ``restore_resharded`` places a checkpoint on
a mesh of another shape.

Four gloo ranks save a tree laid out on a (2, 2) ``(data, model)``
mesh: float32, bfloat16 and int32 leaves split over one or both axes,
a replicated leaf (written once, by rank 0) and a ragged shape whose
shards differ in size; once through ``save_checkpoint`` and once
through the manager (``_snapshot``'s per-rank host shards).  Two ranks
restore it onto a ``(model,)`` mesh and one process onto a 1×1 mesh
and the host: every leaf bit-equal.  The manifest has the reference's
keys and file names; the reference's ``load_checkpoint`` reads the
port's checkpoint; the port restores a checkpoint that the reference's
``save_checkpoint`` wrote from 8 jax host devices (the arrays of
``tests/test_multidevice.py::test_elastic_restore_reshard``); a torn
shard (bad checksum) raises.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_ranks import run_ranks

from repro.checkpoint.store import _shard_key as ref_shard_key
from repro.checkpoint.store import load_checkpoint as ref_load
from repro_torch.checkpoint import (CheckpointManager, load_checkpoint,
                                    restore_resharded)
from repro_torch.checkpoint.store import load_manifest
from repro_torch.launch.mesh import make_host_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: leaf → its spec on the (2, 2) mesh that saves it (as the manifest
#: writes it: trailing unsharded dims left out), and on the two-rank
#: (model,) mesh that restores it
SPECS = {"w": (("data", "model"), ("model", None)),
         "half": (("model",), (None, "model")),
         "ids": (("data",), ("model",)),
         "norm": ((), ()),
         "ragged": (("data", "model"), ("model", None)),
         "step": ((), ())}


def _tree():
    rng = np.random.default_rng(11)
    return {"w": torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32)),
            "half": torch.from_numpy(rng.normal(size=(4, 10)).astype(
                np.float32)).to(torch.bfloat16),
            "ids": torch.from_numpy(rng.integers(-9, 9, 12, dtype=np.int32)),
            "norm": torch.from_numpy(rng.normal(size=16).astype(np.float32)),
            "ragged": torch.from_numpy(rng.normal(size=(5, 3)).astype(
                np.float32)),
            "step": torch.tensor(5, dtype=torch.int32)}


#: each checkpoint's directory under the fixture's, and its step
SAVED = {"direct": ("direct", 5), "managed": ("managed/step_7", 7)}


def _specs(which):
    return {k: v[which] for k, v in SPECS.items()}


def _bit_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    a, b = got.contiguous(), want.contiguous()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    assert torch.equal(a, b)


def _save(rank, out):
    from repro_torch.checkpoint.store import save_checkpoint
    from repro_torch.distributed.partition import distribute_tree
    with make_host_mesh(2) as mesh:
        placed = distribute_tree(_tree(), _specs(0), mesh)
        save_checkpoint(os.path.join(out, "direct"), placed, step=5)
        mgr = CheckpointManager(os.path.join(out, "managed"))
        assert mgr.maybe_save(7, placed, force=True)
        mgr.wait()


def _restore(rank, out):
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("model",))
    want = _tree()
    for path, step in SAVED.values():
        got, s = restore_resharded(os.path.join(out, path), want, mesh,
                                   _specs(1))
        assert s == step
        for k, t in got.items():
            assert t.to_local().numel() <= want[k].numel()
            _bit_equal(t.full_tensor(), want[k])
    # the reference's 8-device checkpoint, on two ranks
    got, s = restore_resharded(os.path.join(out, "jax8"),
                               {"w": torch.zeros(8, 8)}, mesh,
                               {"w": ("model", None)})
    assert s == 3 and got["w"].to_local().shape == (4, 8)
    _bit_equal(got["w"].full_tensor(),
               torch.arange(64, dtype=torch.float32).reshape(8, 8))


_REFERENCE_SAVE = """
import sys
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import save_checkpoint
mesh8 = jax.make_mesh((2, 4), ("data", "model"))
tree = {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8)}
placed = jax.device_put(tree, {"w": NamedSharding(mesh8, P("data", "model"))})
save_checkpoint(sys.argv[1], placed, step=3)
"""


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """The port's checkpoints from four ranks, the reference's from 8
    jax devices, and the port's restored onto two ranks."""
    out = tmp_path_factory.mktemp("sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE_SAVE,
                          str(out / "jax8")], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    run_ranks(_save, 4, out, str(out))
    run_ranks(_restore, 2, out, str(out))
    return out


@pytest.mark.parametrize("name", ["direct", "managed"])
def test_four_ranks_restore_in_one_process(saved, name):
    want = _tree()
    path, want_step = SAVED[name]
    host, step = load_checkpoint(str(saved / path), want)
    assert step == want_step
    for k in want:
        _bit_equal(host[k], want[k])
    with make_host_mesh() as mesh:
        placed, _ = restore_resharded(
            str(saved / path), want, mesh,
            {k: tuple(a if a != "data" else None for a in s)
             for k, s in _specs(0).items()})
        for k in want:
            _bit_equal(placed[k].full_tensor(), want[k])


def test_manifest_has_the_reference_keys_and_files(saved):
    m = load_manifest(str(saved / "direct"))
    ref = load_manifest(str(saved / "jax8"))
    assert set(m) == set(ref) == {"step", "leaves", "extra", "process_count"}
    assert m["process_count"] == 4 and ref["process_count"] == 1
    for name, entry in m["leaves"].items():
        assert set(entry) == set(ref["leaves"]["w"])
        assert entry["partition_spec"] == list(SPECS[name][0])
        total = 0
        for sh in entry["shards"]:
            assert set(sh) == {"file", "index", "crc32"}
            start = tuple(a for a, _ in sh["index"])
            key = ref_shard_key(tuple(slice(a, b) for a, b in sh["index"]),
                                tuple(entry["shape"]))
            assert sh["file"] == f"{name}.shard{key}.npy", (sh, start)
            total += int(np.prod([b - a for a, b in sh["index"]]))
        assert total == int(np.prod(entry["shape"]))   # each shard once
    # replicated leaves once; "w" in four shards, "ragged" 3 + 2 rows
    assert [len(m["leaves"][k]["shards"]) for k in SPECS] == [4, 2, 2, 1, 4, 1]
    assert sorted(tuple(sh["index"][0]) for sh in
                  m["leaves"]["ragged"]["shards"]) == [(0, 3), (0, 3),
                                                       (3, 5), (3, 5)]
    assert json.loads(json.dumps(m)) == m


def test_reference_loads_the_port_checkpoint(saved):
    want = _tree()
    like = {k: np.zeros(tuple(v.shape)) for k, v in want.items()}
    got, step = ref_load(str(saved / "direct"), like)
    assert step == 5
    for k, t in want.items():
        g = np.asarray(got[k])
        if t.dtype == torch.bfloat16:
            assert g.dtype.name == "bfloat16"
            np.testing.assert_array_equal(g.view(np.int16),
                                          t.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(g, t.numpy())


def test_port_restores_the_reference_8_device_checkpoint(saved):
    m = load_manifest(str(saved / "jax8"))
    assert len(m["leaves"]["w"]["shards"]) == 8
    with make_host_mesh() as mesh:
        got, step = restore_resharded(str(saved / "jax8"),
                                      {"w": torch.zeros(8, 8)}, mesh,
                                      {"w": ("data", "model")})
        assert step == 3
        _bit_equal(got["w"].full_tensor(),
                   torch.arange(64, dtype=torch.float32).reshape(8, 8))


def test_a_torn_shard_raises(saved, tmp_path):
    import shutil
    path = tmp_path / "torn"
    shutil.copytree(saved / "direct", path)
    entry = load_manifest(str(path))["leaves"]["w"]["shards"][1]
    raw = np.load(path / entry["file"])
    raw[0] ^= 0xFF
    np.save(path / entry["file"], raw)
    with pytest.raises(IOError, match="checksum mismatch"):
        load_checkpoint(str(path), _tree())
    mgr = CheckpointManager(str(tmp_path))
    os.rename(path, tmp_path / "step_5")
    state, step = mgr.restore_or_init(_tree(), lambda: "fresh")
    assert (state, step) == ("fresh", 0)
