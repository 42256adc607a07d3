"""Partition rules: map every parameter/activation/cache leaf to a spec
on the (pod, data, model) production mesh.

The torch port of ``repro.distributed.partition``.  A *spec* is the
reference's ``PartitionSpec`` as a plain tuple: one entry per leading
tensor dim (missing trailing entries are unsharded), each ``None``, a
mesh axis name, or a tuple of names; ``()`` replicates.
:func:`shardings_of` turns specs into DTensor placements on a
``DeviceMesh``.  The rules read only the mesh's axis sizes (a
``DeviceMesh``, or any object whose ``shape`` maps axis names to
sizes), so they can be held to the reference's on stand-in meshes.

Strategy (Megatron-style TP × DP, EP for MoE, sequence-sharding for caches):

  * batch dims           → ('pod','data') (DP; pod composes hierarchically)
  * attention q/o        → heads on 'model' when H % model == 0, else
                           replicated (whisper/qwen2-vl have 12 heads on a
                           16-way axis; attention then parallelizes over
                           batch only)
  * attention k/v        → 'model' when K % model == 0, else replicated
                           (GQA kv-head replication)
  * MLP ff dim           → 'model'
  * MoE expert dim       → 'model' (EP: 64/16 = 4 experts per device)
  * Mamba d_inner/heads  → 'model'
  * embeddings           → vocab on 'model' when divisible, else replicated
  * KV cache             → kv-heads on 'model' when divisible, else
                           *sequence* on 'model' (flash-decode style); batch
                           on ('pod','data')
  * SSM state            → heads on 'model', batch on DP
  * optimizer state      → param spec + 'data' on the largest free dim
                           (ZeRO-1 style; see zero_shard_specs)

All rules check divisibility against the mesh shape and fall back to
replication: a config can never fail to shard, only shard worse.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

Spec = Tuple[Any, ...]


# ---------------------------------------------------------------------------
# mesh helpers
# ---------------------------------------------------------------------------

def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name → size, of a ``DeviceMesh`` or of a stand-in whose
    ``shape`` is already that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh_shape(mesh) else ("data",)


def dp_size(mesh) -> int:
    shape = mesh_shape(mesh)
    return int(math.prod(shape[a] for a in batch_axes(mesh)))


def _entry(axes: Tuple[str, ...]):
    """A spec entry of mesh axes: one name alone, as ``PartitionSpec``
    normalizes ``('data',)`` to ``'data'``."""
    return axes[0] if len(axes) == 1 else axes


def batch_spec(mesh, ndim: int, batch_dim: int = 0) -> Spec:
    spec: List[Any] = [None] * ndim
    spec[batch_dim] = _entry(batch_axes(mesh))
    return tuple(spec)


def _path_str(path: Tuple[Any, ...]) -> str:
    """The '/'-joined key path of a leaf (dict keys, tuple indices), as
    the reference joins ``jax.tree_util`` paths."""
    return "/".join(str(k) for k in path)


def map_with_path(fn: Callable[[Tuple[Any, ...], Any], Any], tree: Any,
                  path: Tuple[Any, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts and tuples, keeping its
    structure (``jax.tree_util.tree_map_with_path``)."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, tuple) and not _is_spec(tree):
        return tuple(map_with_path(fn, v, path + (i,))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def _is_spec(x: Any) -> bool:
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, (str, tuple)) for e in x) and not any(
        isinstance(e, tuple) and not all(isinstance(a, str) for a in e)
        for e in x)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------

def _spec_with(ndim: int, dim: int, axis: str) -> Spec:
    spec: List[Any] = [None] * ndim
    spec[dim % ndim] = axis
    return tuple(spec)


def param_rule(cfg, name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """One leaf → spec.  ``name`` is the '/'-joined tree path."""
    m = axis_size(mesh, "model")
    nd = len(shape)
    leaf = name.rsplit("/", 1)[-1]
    H, K = cfg.num_heads, cfg.num_kv_heads
    heads_ok = H % m == 0
    kv_ok = K % m == 0
    div = lambda dim: shape[dim % nd] % m == 0  # noqa: E731

    if "embed" in name and leaf == "table":
        if div(-2):                      # vocab
            return _spec_with(nd, -2, "model")
        return ()                        # non-divisible vocab: replicate
    if leaf == "pos_embed" or "pos_embed" in name:
        return ()

    # attention
    if leaf == "wq":
        return _spec_with(nd, -1, "model") if heads_ok and div(-1) else ()
    if leaf in ("wk", "wv"):
        return _spec_with(nd, -1, "model") if kv_ok and div(-1) else ()
    if leaf == "wo":
        return _spec_with(nd, -2, "model") if heads_ok and div(-2) else ()

    # MoE: expert dim is always third-from-last ([.., E, d, f] / [.., E, f, d])
    if ("/moe" in name or name.startswith("moe")) and "shared" not in name:
        if leaf == "router":
            return ()
        if leaf in ("w_up", "w_gate", "w_down") and nd >= 3:
            E = shape[-3]
            if E % m == 0:
                return _spec_with(nd, -3, "model")
            return _spec_with(nd, -1, "model") if div(-1) else ()
        # shared-expert MLP falls through to the dense rules below

    # dense MLP
    if leaf in ("w_up", "w_gate"):
        return _spec_with(nd, -1, "model") if div(-1) else ()
    if leaf == "w_down":
        return _spec_with(nd, -2, "model") if div(-2) else ()

    # mamba2
    if leaf in ("w_z", "w_x"):
        return _spec_with(nd, -1, "model") if div(-1) else ()
    if leaf in ("w_B", "w_C", "conv_B", "conv_C"):
        return ()
    if leaf == "w_dt":
        return _spec_with(nd, -1, "model") if div(-1) else ()
    if leaf == "conv_x":
        return _spec_with(nd, -1, "model") if div(-1) else ()
    if leaf in ("A_log", "D", "dt_bias"):
        return _spec_with(nd, -1, "model") if div(-1) else ()
    if leaf == "out_proj":
        return _spec_with(nd, -2, "model") if div(-2) else ()
    if "mamba" in name and leaf == "scale":     # gated-norm over d_inner
        return _spec_with(nd, -1, "model") if div(-1) else ()

    # norms / scalars / anything small
    return ()


def param_specs(cfg, params_tree, mesh):
    """Tree of specs matching a params (or ``meta``) tree."""
    return map_with_path(
        lambda path, leaf: param_rule(cfg, _path_str(path),
                                      tuple(leaf.shape), mesh), params_tree)


# ---------------------------------------------------------------------------
# optimizer-state rules (ZeRO-1 style)
# ---------------------------------------------------------------------------

def zero_shard_specs(cfg, params_tree, mesh, axis: str = "data"):
    """Param spec + ``axis`` on the largest still-unsharded divisible dim
    (AdamW m/v, and the gradient accumulator of ``grad_specs``): the
    ZeRO-1 trick, expressed purely as shardings."""
    d = axis_size(mesh, axis)

    def rule(path, leaf):
        spec = list(param_rule(cfg, _path_str(path), tuple(leaf.shape),
                               mesh))
        spec += [None] * (len(leaf.shape) - len(spec))
        best, best_size = None, 0
        for i, s in enumerate(spec):
            if s is None and leaf.shape[i] % d == 0 \
                    and leaf.shape[i] > best_size:
                best, best_size = i, leaf.shape[i]
        if best is not None and best_size > 1:
            spec[best] = axis
        return tuple(spec)

    return map_with_path(rule, params_tree)


# ---------------------------------------------------------------------------
# activation / input / cache rules
# ---------------------------------------------------------------------------

def input_specs_tree(cfg, batch_tree, mesh):
    """Specs for a training/prefill input batch (by leaf name)."""
    b = _entry(batch_axes(mesh))
    dp = dp_size(mesh)

    def rule(path, leaf):
        name = _path_str(path)
        nd = len(leaf.shape)
        if name == "positions" and nd == 3:      # M-RoPE [3,B,S]
            return (None, b, None) if leaf.shape[1] % dp == 0 else ()
        if nd == 0 or leaf.shape[0] % dp != 0:   # e.g. batch=1 long-context
            return (None,) * nd
        return (b,) + (None,) * (nd - 1)

    return map_with_path(rule, batch_tree)


def cache_specs(cfg, cache_tree, mesh):
    """Specs for a KV/SSM cache tree (see module docstring)."""
    m = axis_size(mesh, "model")
    dp = dp_size(mesh)
    b = _entry(batch_axes(mesh))
    kv_ok = cfg.num_kv_heads % m == 0

    def rule(path, leaf):
        name = _path_str(path)
        nd = len(leaf.shape)
        if nd == 0:                                        # pos scalar
            return ()
        if name.rsplit("/", 1)[-1] in ("k", "v", "xk", "xv"):
            # [L, B, S, K, hd] (dense/encdec) or [nb, B, S, K, hd] (hybrid)
            bax = b if leaf.shape[1] % dp == 0 else None
            if kv_ok:
                return (None, bax, None, "model", None)
            if leaf.shape[2] % m == 0:
                return (None, bax, "model", None, None)    # sequence shard
            return (None, bax, None, None, None)
        if "state" in name:
            # [L, B, H, P, N] or [nb, n_ssm, B, H, P, N]
            hdim = nd - 3
            spec: List[Any] = [None] * nd
            if leaf.shape[hdim - 1] % dp == 0:
                spec[hdim - 1] = b
            if leaf.shape[hdim] % m == 0:
                spec[hdim] = "model"
            return tuple(spec)
        if "conv" in name:
            # [L, B, k-1, C] or [nb, n_ssm, B, k-1, C]
            spec = [None] * nd
            if leaf.shape[nd - 3] % dp == 0:
                spec[nd - 3] = b
            if leaf.shape[-1] % m == 0 and leaf.shape[-1] >= m:
                spec[-1] = "model"
            return tuple(spec)
        return ()

    return map_with_path(rule, cache_tree)


# ---------------------------------------------------------------------------
# specs → DTensor placements
# ---------------------------------------------------------------------------

def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh dim,
    ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``.  A dim over ``("pod", "data")`` is sharded on both
    mesh dims, outer first, as ``PartitionSpec`` orders it.  A mesh dim
    of one rank splits nothing, so it replicates (DTensor cannot view a
    size-1 dim sharded over it: a batch of 1 on a 1×1 mesh)."""
    from torch.distributed.tensor import Replicate, Shard
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        for name in ((entry,) if isinstance(entry, str) else entry or ()):
            if name in where:
                raise ValueError(f"spec {spec} uses mesh axis {name!r} "
                                 f"twice")
            where[name] = d
    names = mesh.mesh_dim_names
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} that "
                         f"mesh {names} lacks")
    sizes = mesh_shape(mesh)
    return [Shard(where[n]) if n in where and sizes[n] > 1 else Replicate()
            for n in names]


def shardings_of(specs_tree, mesh):
    """A tree of specs → a tree of placement lists on ``mesh``."""
    return map_with_path(lambda _path, s: placements(s, mesh), specs_tree)


def distribute(t, mesh, spec):
    """A ``DTensor`` on ``mesh`` laid out by ``spec`` from a tensor that
    every rank holds whole (the same values on each): each rank keeps
    its own shard on the mesh's device, and nothing moves between ranks
    (``distribute_tensor`` would scatter rank 0's).  A part of ``t`` is
    copied, so the rest of ``t`` can be freed; a shard that is all of a
    contiguous ``t`` on that device is ``t`` itself."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    pl = placements(spec, mesh)
    shape, offset = compute_local_shape_and_global_offset(t.shape, mesh, pl)
    local = t[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    if local.numel() != t.numel():
        local = local.clone()
    if local.device.type != mesh.device_type:
        local = local.to(mesh.device_type)
    local = local.contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=contiguous_stride(t.shape))


def contiguous_stride(shape) -> Tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def distribute_tree(tensors, specs, mesh):
    """:func:`distribute` over a tree of tensors (dicts, lists and
    tuples) and the matching tree of specs."""
    if isinstance(tensors, dict):
        return {k: distribute_tree(v, specs[k], mesh)
                for k, v in tensors.items()}
    if isinstance(tensors, (list, tuple)):
        return type(tensors)(distribute_tree(v, s, mesh)
                             for v, s in zip(tensors, specs))
    return distribute(tensors, mesh, specs)
