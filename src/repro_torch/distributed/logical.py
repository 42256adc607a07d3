"""Logical-axis sharding constraints (MaxText-style) for layer internals.

The torch port of ``repro.distributed.logical``.  Model code annotates
activations with *logical* axes ("batch", "heads", "ff", ...); the
launch layer binds logical→mesh rules for the (config, mesh) pair
before tracing.  With no rules bound (unit tests, one-card runs), or on
a tensor that is not a ``DTensor``, every constraint is a no-op, so
model code stays mesh-agnostic and its numerics do not change.

Under rules, :func:`constrain` redistributes a ``DTensor`` to the bound
placements (``with_sharding_constraint``), which resolves propagation
ambiguities such as the GQA reshapes explicitly.  :func:`local` is the
torch form of ``shard_map``: it runs a function on each rank's shards
of its arguments, laid out by logical axes, and wraps the results back
into DTensors, for the regions whose bodies (the chunked
attention's buffers, the cache writes, the SSD scan) sharding
propagation cannot carry.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[None, str, Tuple[str, ...]]
Axes = Tuple[Optional[str], ...]

#: The bound rules.  Process-wide, not per thread: the autograd engine
#: runs a CUDA tensor's backward (a remat's recompute among it) on a
#: worker thread of its own, which must see the rules of the forward.
_bound: Dict[str, Any] = {"rules": None}


def _rules() -> Optional[Dict[str, Any]]:
    return _bound["rules"]


def default_rules(cfg, mesh) -> Dict[str, Any]:
    """Bind logical axes to mesh axes with divisibility guards."""
    from .partition import mesh_shape
    shape = mesh_shape(mesh)
    m = shape.get("model", 1)
    batch = ("pod", "data") if "pod" in shape else ("data",)
    heads_ok = cfg.num_heads % m == 0
    kv_ok = cfg.num_kv_heads % m == 0
    return {
        "mesh": mesh,                  # consumed by the local regions
        "batch": batch,
        "seq": None,
        "heads": "model" if heads_ok else None,
        "kv_heads": "model" if kv_ok else None,
        "head_dim": None,
        "ff": "model" if (cfg.d_ff == 0 or cfg.d_ff % m == 0) else None,
        "moe_ff": "model" if (cfg.moe_d_ff or cfg.d_ff) % max(m, 1) == 0
        else None,
        "experts": "model" if (cfg.moe_num_experts % m == 0
                               if cfg.moe_num_experts else False) else None,
        "inner": "model" if (cfg.ssm_d_inner % m == 0
                             if cfg.ssm_state else False) else None,
        "ssm_heads": "model" if (cfg.ssm_heads % m == 0
                                 if cfg.ssm_state else False) else None,
        "embed": None,       # d_model of activations stays unsharded
        "vocab": "model" if cfg.vocab_size % m == 0 else None,
    }


@contextlib.contextmanager
def logical_rules(rules: Dict[str, Any]):
    """Bind ``rules`` for the ``with`` body.  Inside it a plain tensor
    that meets a DTensor (a constant the model makes: rotary
    frequencies, masks) is taken as replicated
    (``implicit_replication``)."""
    from torch.distributed.tensor.experimental import implicit_replication
    prev = _rules()
    _bound["rules"] = rules
    try:
        with implicit_replication():
            yield
    finally:
        _bound["rules"] = prev


def active_rules() -> Optional[Dict[str, Any]]:
    """The currently-bound rules (None outside a logical_rules context)."""
    return _rules()


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def sharded(x: Any) -> bool:
    """Whether ``x`` is a DTensor under bound rules: the case in which
    the layers' sharded forms apply."""
    return _rules() is not None and is_dtensor(x)


def spec_of(axes: Sequence[Optional[str]], rules: Dict[str, Any],
            shape: Optional[Sequence[int]] = None) -> Tuple[Axis, ...]:
    """Logical axes → a partition spec under ``rules``.  Given the
    tensor's ``shape``, a dim the bound mesh axes do not divide stays
    unsharded (the rules' divisibility guard)."""
    from .partition import mesh_shape
    sizes = mesh_shape(rules["mesh"])
    spec = []
    for d, a in enumerate(axes):
        entry = rules.get(a) if a else None
        if entry is not None and shape is not None:
            names = (entry,) if isinstance(entry, str) else entry
            n = 1
            for name in names:
                n *= sizes[name]
            if shape[d] % n:
                entry = None
        spec.append(entry)
    return tuple(spec)


def placements_of(axes: Sequence[Optional[str]], rules: Dict[str, Any],
                  shape: Optional[Sequence[int]] = None) -> list:
    from .partition import placements
    return placements(spec_of(axes, rules, shape), rules["mesh"])


def constrain(x, *axes: Optional[str]):
    """Redistribute a ``DTensor`` to the placements the bound rules give
    ``axes`` (one per dim); anything else, or no rules, passes through."""
    rules = _rules()
    if rules is None or not is_dtensor(x):
        return x
    if len(axes) != x.ndim:
        raise ValueError(f"constrain: {len(axes)} axes for a "
                         f"{x.ndim}-d tensor {tuple(x.shape)}")
    want = placements_of(axes, rules, x.shape)
    if list(x.placements) == want:
        return x
    return x.redistribute(rules["mesh"], want)


def local(fn: Callable[..., Any], in_axes: Sequence[Optional[Axes]],
          out_axes: Union[Axes, Sequence[Axes]]) -> Callable[..., Any]:
    """``fn`` on each rank's shards (``shard_map``).

    Outside rules, or when no argument is a ``DTensor``, ``fn`` itself.
    Under rules each argument with axes is redistributed to the bound
    placements of its axes (a plain tensor is taken as replicated), and
    one whose axes are ``None`` keeps its placements (a constant passes
    as it is); ``fn`` gets their local shards.  Each result (one, or a
    tuple when ``out_axes`` is a list of them) is wrapped back as a
    ``DTensor`` placed by its axes: ``fn`` must give each rank's part of
    a result that is sharded, and a replicated result equal on every
    rank (it may reduce across ranks itself, :func:`mesh_reduce`).

    Gradients follow ``shard_map``'s transpose: an argument replicated
    over a mesh dim on which some result is sharded gets each rank's
    part of its gradient, summed over that dim (``Partial``).
    """
    def run(*args):
        rules = _rules()
        if rules is None or not any(is_dtensor(a) for a in args):
            return fn(*args)
        from torch.distributed.tensor import DTensor, Partial
        mesh = rules["mesh"]
        # inputs first: a logical axis the divisibility guard leaves
        # unsharded on an input stays unsharded on the results
        placed, dropped = [], set()
        for a, axes in zip(args, in_axes):
            if isinstance(a, torch.Tensor):
                if not is_dtensor(a):
                    a = DTensor.from_local(a, mesh, _replicated(mesh),
                                           run_check=False)
                if axes is not None:
                    guarded = spec_of(axes, rules, a.shape)
                    dropped |= {ax for ax, e, g in zip(
                        axes, spec_of(axes, rules), guarded) if e != g}
                    a = constrain(a, *axes)
            placed.append(a)
        out_rules = dict(rules, **{ax: None for ax in dropped})
        multi = isinstance(out_axes, list)
        specs = list(out_axes) if multi else [out_axes]
        out_pl = [ax.placements if isinstance(ax, Placed)
                  else placements_of(ax, out_rules) for ax in specs]
        split = {i for pl in out_pl for i, p in enumerate(pl)
                 if not p.is_replicate()}
        local_args = [
            a.to_local(grad_placements=[
                Partial() if (i in split and p.is_replicate()) else p
                for i, p in enumerate(a.placements)])
            if is_dtensor(a) else a for a in placed]
        out = fn(*local_args)
        outs = tuple(out) if multi else (out,)
        wrapped = tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                        for o, pl in zip(outs, out_pl))
        return wrapped if multi else wrapped[0]
    return run


class Placed:
    """An ``out_axes`` entry of :func:`local` that gives a result's
    placements directly (one per mesh dim)."""

    def __init__(self, placements):
        self.placements = list(placements)


def _replicated(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name``, read without slicing the
    mesh (a sub-mesh made inside a trace indexes the mesh's rank tensor,
    which the tracer records)."""
    return mesh.size(mesh.mesh_dim_names.index(name))


def mesh_reduce(x, op: str, axis: Axis):
    """All-reduce a rank's local tensor over the mesh axis ``axis`` (a
    name, a tuple of names, or None: no reduction) inside a
    :func:`local` region, as a functional collective the trace records
    (``op``: ``sum`` or ``max``)."""
    rules = _rules()
    if rules is None or axis is None:
        return x
    import torch.distributed._functional_collectives as funcol
    mesh = rules["mesh"]
    for name in ((axis,) if isinstance(axis, str) else axis):
        if _size(mesh, name) > 1:
            x = funcol.all_reduce(x, op,
                                  (mesh, mesh.mesh_dim_names.index(name)))
    return x


class _MeshSum(torch.autograd.Function):
    """Megatron's ``g``: the forward sums each rank's part over the mesh
    axes; the backward passes the (replicated) gradient to every part."""

    @staticmethod
    def forward(ctx, x, axis):
        return mesh_reduce(x, "sum", axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def mesh_sum(x, axis: Axis):
    """The sum over the mesh axis ``axis`` of each rank's partial
    ``x``, inside a :func:`local` region; differentiable."""
    return _MeshSum.apply(x, axis)


class _MeshCopy(torch.autograd.Function):
    """Megatron's ``f``: the forward passes a (replicated) input to each
    rank's part; the backward sums the parts' gradients over the mesh
    axes."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return mesh_reduce(grad, "sum", ctx.axis), None


def mesh_copy(x, axis: Axis):
    """``x``, replicated over the mesh axis ``axis``, as the input of
    each rank's partial result inside a :func:`local` region: its
    gradient is summed over ``axis`` (the pair of :func:`mesh_sum`)."""
    return _MeshCopy.apply(x, axis)


def mesh_mean(x, axis: Axis):
    """The mean over the mesh axis ``axis`` of a ``DTensor`` that holds
    a different value on each of its ranks (a ``local`` region's
    per-rank result), replicated: differentiable, as a ``Partial``
    sum redistributed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = _rules()["mesh"]
    names = set((axis,) if isinstance(axis, str) else axis)
    n = 1
    for name in names:
        n *= _size(mesh, name)
    pl = [Partial() if name in names else p
          for name, p in zip(mesh.mesh_dim_names, x.placements)]
    part = DTensor.from_local(x.to_local() / n, mesh, pl, run_check=False)
    return part.redistribute(mesh, [Replicate() if p.is_partial() else p
                                    for p in pl])


def mesh_coordinate(axis: Axis) -> int:
    """This rank's index along ``axis`` (a name or a tuple of names,
    outer first; 0 without rules)."""
    rules = _rules()
    if rules is None or axis is None:
        return 0
    mesh = rules["mesh"]
    idx = 0
    for name in ((axis,) if isinstance(axis, str) else axis):
        idx = idx * _size(mesh, name) + mesh.get_local_rank(
            mesh.mesh_dim_names.index(name))
    return idx


def mesh_size(axis: Axis) -> int:
    """The size of a bound mesh axis (1 without rules or for None)."""
    rules = _rules()
    if rules is None or axis is None:
        return 1
    mesh = rules["mesh"]
    n = 1
    for name in ((axis,) if isinstance(axis, str) else axis):
        n *= _size(mesh, name)
    return n
