"""Sharded checkpoint format on torch tensors: per-shard .npy files and
a JSON manifest.

The port of the JAX package's ``checkpoint/store.py``
(``save_checkpoint``, ``load_checkpoint``, ``load_manifest``,
``restore_resharded``), writing its on-disk format, so a checkpoint
written by either package loads in the other:

  * ``manifest.json`` holds ``step``, ``leaves``, ``extra`` and
    ``process_count`` (the ranks that wrote it); each leaf its logical
    ``shape``, ``dtype`` (numpy's name: ``"float32"``, ``"bfloat16"``,
    ...) and ``shards``, each shard its ``file``, ``index`` (``[start,
    stop]`` per dimension) and ``crc32``.  A tensor leaf also carries
    ``partition_spec``: a ``DTensor``'s placements read as the
    reference's spec (a list of mesh axis names, lists of them or
    nulls, trailing unsharded dims left out), null for a plain tensor,
    as for a one-device jax array;
  * every rank writes only its own shards of a ``DTensor``, each file
    named by ``_shard_key`` of the shard's global index; a shard that
    several ranks hold (replicated over a mesh axis) is written once,
    by the lowest of them, and a plain tensor by rank 0.  All ranks
    write into one ``<path>.tmp``; after a barrier rank 0 gathers the
    shard entries, writes the manifest and renames the directory into
    place, and a second barrier makes the checkpoint exist on every
    rank's return, so it exists completely or not at all;
  * a shard's payload is its bytes as a flat uint8 ``.npy``; bfloat16,
    which numpy has no type for, goes through a uint16 view and
    ``Tensor.view(torch.bfloat16)``, never through ``np.dtype
    ("bfloat16")``;
  * leaves are named as ``jax.tree_util.tree_flatten_with_path`` names
    them: dict keys sorted, list and tuple items by index, joined with
    ``/``; ``None`` holds no leaf;
  * the checksums guard a restore against torn or corrupt files.

A CUDA tensor is copied to the host to be written, as the reference's
``np.asarray(shard.data)`` is.  :func:`load_checkpoint` assembles each
leaf whole on the host, from however many ranks wrote it;
:func:`restore_resharded` places the leaves on a mesh of any shape (an
elastic restart).  The manager that saves while a trainer runs is in
``manager.py``.
"""
from __future__ import annotations

import json
import os
import shutil
import zlib
from dataclasses import dataclass
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


def process_count() -> int:
    """The ranks of the default group (1 with none up)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _crc(data: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(data).tobytes()) & 0xFFFFFFFF


@dataclass(frozen=True)
class LocalShard:
    """This rank's part of a sharded leaf, as a save writes it (a leaf,
    not a tuple the tree walk would enter)."""
    data: torch.Tensor               # the shard's values
    shape: Tuple[int, ...]           # the leaf's global shape
    offset: Tuple[int, ...]          # the shard's global offset
    spec: List[Any]                  # the leaf's spec, JSON-ready
    owner: bool                      # whether this rank writes it


def local_shard(x, to_host: bool = False) -> LocalShard:
    """The ``LocalShard`` of a ``DTensor`` (its values copied to the
    host with ``to_host``).  The owner of a shard is the rank at
    coordinate 0 on every mesh dim the leaf is replicated over: the
    lowest of the ranks that hold it.  An empty shard has no owner."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, pl = x.device_mesh, list(x.placements)
    if any(p.is_partial() for p in pl):
        raise ValueError("a partial sum cannot be saved: redistribute it "
                         "first")
    shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, pl)
    data = x.to_local()
    if to_host:
        data = data.detach().to("cpu", copy=True)
    owner = all(p.is_shard() or mesh.get_local_rank(i) == 0
                for i, p in enumerate(pl)) and all(n > 0 for n in shape)
    return LocalShard(data, tuple(x.shape), tuple(offset),
                      _placement_spec(pl, mesh, x.ndim), owner)


def _placement_spec(pl, mesh, ndim: int) -> List[Any]:
    """DTensor placements read as the reference's JSON spec: per tensor
    dim the mesh axes that shard it, outer first (a name alone, a list
    of several, or None), trailing unsharded dims left out."""
    names: List[List[str]] = [[] for _ in range(ndim)]
    for axis, p in zip(mesh.mesh_dim_names, pl):
        if p.is_shard():
            names[p.dim % ndim].append(axis)
    spec = [None if not n else n[0] if len(n) == 1 else n for n in names]
    while spec and spec[-1] is None:
        spec.pop()
    return spec


def _shard_key(offset, shape) -> int:
    """The reference's file key of a shard: its offsets in mixed radix."""
    key = 0
    for start, dim in zip(offset, shape):
        key = key * (dim + 1) + start
    return key


def _leaf_entry(name: str, leaf: Any, tmp: str, rank: int
                ) -> Dict[str, Any]:
    """Write this rank's shards of one leaf under ``tmp``; its manifest
    entry, with the shards this rank wrote."""
    from repro_torch.distributed.logical import is_dtensor
    if is_dtensor(leaf):
        leaf = local_shard(leaf)
    if isinstance(leaf, LocalShard):
        data, dtype = _host_array(leaf.data)
        entry: Dict[str, Any] = {"shape": list(leaf.shape), "dtype": dtype,
                                 "shards": [],
                                 "partition_spec": leaf.spec}
        if leaf.owner:
            fname = _leaf_filename(name, _shard_key(leaf.offset, leaf.shape))
            _save_raw(os.path.join(tmp, fname), data)
            entry["shards"].append({
                "file": fname,
                "index": [[o, o + n] for o, n in zip(leaf.offset,
                                                     data.shape)],
                "crc32": _crc(data)})
        return entry
    data, dtype = _host_array(leaf)
    entry = {"shape": list(data.shape), "dtype": dtype, "shards": []}
    if rank == 0:
        fname = _leaf_filename(name, 0)
        _save_raw(os.path.join(tmp, fname), data)
        entry["shards"].append({"file": fname,
                                "index": [[0, dim] for dim in data.shape],
                                "crc32": _crc(data)})
    if isinstance(leaf, torch.Tensor):
        entry["partition_spec"] = None
    return entry


def save_checkpoint(path: str, tree, step: int = 0,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Write ``tree`` under ``path`` (atomic).  Returns the final path.

    With several ranks in the default group every rank calls it with
    its part of the same tree (``DTensor`` or ``LocalShard`` leaves,
    and plain leaves that rank 0 writes)."""
    world = process_count()
    rank = dist.get_rank() if world > 1 else 0
    tmp = path + ".tmp"
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp, exist_ok=True)
    if world > 1:
        dist.barrier()
    leaves = {name: _leaf_entry(name, leaf, tmp, rank)
              for name, leaf in _flatten(tree)}
    if world > 1:
        dist.barrier()
        parts: Optional[List[Any]] = [None] * world if rank == 0 else None
        dist.gather_object(leaves, parts, dst=0)
        if rank == 0:
            for other in parts[1:]:
                for name, entry in other.items():
                    leaves[name]["shards"] += entry["shards"]
            for entry in leaves.values():
                entry["shards"].sort(key=lambda sh: sh["index"])
    if rank == 0:
        manifest = {"step": int(step), "leaves": leaves,
                    "extra": extra or {}, "process_count": world}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    if world > 1:
        dist.barrier()
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


def restore_resharded(path: str, tree_like, mesh, spec_tree,
                      verify: bool = True):
    """Elastic restart: place a checkpoint onto a (possibly different)
    mesh.  Returns ``(tree, step)``.

    The manifest's logical shapes do not depend on the mesh that wrote
    it: each leaf is assembled on the host and every rank keeps its own
    shard of it on ``mesh``'s device, placed by the matching spec of
    ``spec_tree`` (``distributed.partition``'s tuples).  Restoring a
    checkpoint written on four ranks onto two, or onto one, is the same
    code path."""
    from repro_torch.distributed.partition import distribute_tree
    host_tree, step = load_checkpoint(path, tree_like, verify)
    return distribute_tree(host_tree, spec_tree, mesh), step
