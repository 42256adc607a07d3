"""Sharded checkpoint format on torch tensors: per-leaf .npy files and a
JSON manifest.

The port of the JAX package's ``checkpoint/store.py``
(``save_checkpoint``, ``load_checkpoint``, ``load_manifest``), writing
its on-disk format, so a checkpoint written by either package loads in
the other:

  * ``manifest.json`` holds ``step``, ``leaves``, ``extra`` and
    ``process_count``; each leaf its logical ``shape``, ``dtype`` (numpy's
    name: ``"float32"``, ``"bfloat16"``, ...) and ``shards``, each shard
    its ``file``, ``index`` (``[start, stop]`` per dimension) and
    ``crc32``.  A tensor leaf also carries ``partition_spec`` (null: a
    tensor here is not sharded, as a one-device jax array is not);
  * a shard's payload is its bytes as a flat uint8 ``.npy``; bfloat16,
    which numpy has no type for, goes through a uint16 view and
    ``Tensor.view(torch.bfloat16)``, never through ``np.dtype
    ("bfloat16")``;
  * leaves are named as ``jax.tree_util.tree_flatten_with_path`` names
    them: dict keys sorted, list and tuple items by index, joined with
    ``/``; ``None`` holds no leaf;
  * a write goes to ``<path>.tmp`` and is renamed into place, so a
    checkpoint exists completely or not at all, and the checksums guard
    a restore against torn or corrupt files.

A CUDA tensor is copied to the host to be written, as the reference's
``np.asarray(shard.data)`` is, and :func:`load_checkpoint` returns host
tensors.  The reference's ``CheckpointManager`` and
``restore_resharded`` are not ported yet.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

MANIFEST = "manifest.json"

#: numpy's name for each torch dtype a checkpoint may hold.
DTYPE_NAMES: Dict[torch.dtype, str] = {
    torch.float64: "float64", torch.float32: "float32",
    torch.float16: "float16", torch.bfloat16: "bfloat16",
    torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
    torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
    torch.complex64: "complex64", torch.complex128: "complex128",
}
_BF16 = "bfloat16"


def _save_raw(path: str, data: np.ndarray) -> None:
    """Byte-exact storage for any dtype: the payload is a uint8 view;
    dtype and shape live in the manifest."""
    np.save(path, np.ascontiguousarray(data).view(np.uint8).reshape(-1))


def _storage_dtype(dtype: str) -> np.dtype:
    """The numpy type a shard's bytes are read as (bfloat16 as uint16)."""
    return np.dtype(np.uint16) if dtype == _BF16 else np.dtype(dtype)


def _load_raw(path: str, dtype: str, shape) -> np.ndarray:
    raw = np.load(path)
    return raw.view(_storage_dtype(dtype)).reshape(shape)


def _host_array(leaf: Any) -> Tuple[np.ndarray, str]:
    """A leaf's values on the host and numpy's name for their type."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype not in DTYPE_NAMES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), _BF16
        return t.numpy(), DTYPE_NAMES[t.dtype]
    data = np.asarray(leaf)
    return data, str(data.dtype)


def _to_tensor(data: np.ndarray, dtype: str) -> torch.Tensor:
    data = data if data.flags.c_contiguous else data.copy()
    if dtype == _BF16:
        return torch.from_numpy(data.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(data)


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` pairs in ``tree_flatten_with_path`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], prefix + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, node in enumerate(tree)
                for pair in _flatten(node, prefix + (str(i),))]
    return [("/".join(prefix), tree)]


def _rebuild(tree, leaves: Dict[str, Any], prefix: Tuple[str, ...] = ()):
    """``tree``'s structure with each leaf replaced by ``leaves[name]``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, prefix + (str(k),))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        nodes = [_rebuild(node, leaves, prefix + (str(i),))
                 for i, node in enumerate(tree)]
        if isinstance(tree, tuple) and hasattr(tree, "_fields"):
            return type(tree)(*nodes)
        return type(tree)(nodes)
    return leaves["/".join(prefix)]


def _leaf_filename(name: str, shard_idx: int) -> str:
    safe = name.replace("/", "__")
    return f"{safe}.shard{shard_idx}.npy"


def _process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _crc(data: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(data).tobytes()) & 0xFFFFFFFF


def save_checkpoint(path: str, tree, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` under ``path`` (atomic).  Returns the final path."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest: Dict[str, Any] = {"step": int(step), "leaves": {},
                                "extra": extra or {},
                                "process_count": _process_count()}
    for name, leaf in _flatten(tree):
        data, dtype = _host_array(leaf)
        fname = _leaf_filename(name, 0)
        _save_raw(os.path.join(tmp, fname), data)
        entry: Dict[str, Any] = {
            "shape": list(data.shape),
            "dtype": dtype,
            "shards": [{"file": fname,
                        "index": [[0, dim] for dim in data.shape],
                        "crc32": _crc(data)}],
        }
        if isinstance(leaf, torch.Tensor):
            entry["partition_spec"] = None
        manifest["leaves"][name] = entry
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    return path


def load_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def _assemble(path: str, entry: Dict[str, Any],
              verify: bool = True) -> np.ndarray:
    dtype = entry["dtype"]
    if not entry["shape"]:
        sh = entry["shards"][0]
        data = _load_raw(os.path.join(path, sh["file"]), dtype, ())
        _check(sh, data, verify)
        return data
    full = np.empty(entry["shape"], dtype=_storage_dtype(dtype))
    for sh in entry["shards"]:
        shard_shape = tuple(b - a for a, b in sh["index"])
        data = _load_raw(os.path.join(path, sh["file"]), dtype, shard_shape)
        _check(sh, data, verify)
        full[tuple(slice(a, b) for a, b in sh["index"])] = data
    return full


def _check(shard_entry, data, verify):
    if verify:
        crc = _crc(data)
        if crc != shard_entry["crc32"]:
            raise IOError(f"checksum mismatch in {shard_entry['file']}: "
                          f"{crc:#x} != {shard_entry['crc32']:#x}")


def load_checkpoint(path: str, tree_like, verify: bool = True):
    """Restore into the structure of ``tree_like`` (host tensors).
    Returns ``(tree, step)``."""
    manifest = load_manifest(path)
    names = [n for n, _ in _flatten(tree_like)]
    missing = [n for n in names if n not in manifest["leaves"]]
    if missing:
        raise KeyError(f"checkpoint missing leaves: {missing[:5]}")
    leaves = {n: _to_tensor(_assemble(path, manifest["leaves"][n], verify),
                            manifest["leaves"][n]["dtype"])
              for n in names}
    return _rebuild(tree_like, leaves), manifest["step"]
