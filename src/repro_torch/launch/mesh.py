"""Production mesh construction.

The torch port of ``repro.launch.mesh``.  A mesh is a ``DeviceMesh``
over the default process group.  The production meshes stand for 256
or 512 ranks on one host: their group is a *fake* one
(``torch.testing._internal.distributed.fake_pg``), whose collectives
complete at once without moving data, so a step can be traced for one
rank of the mesh with no second card.  Functions, not module
constants: importing this module opens no group.

Mesh shapes (the reference's, TPU v5e pods):
  * single-pod: (16, 16)    axes (data, model)   — 256 ranks
  * multi-pod:  (2, 16, 16) axes (pod, data, model) — 512 ranks

Axis order is outermost-first, so data-parallel gradient reductions
decompose hierarchically (within a pod over 'data', then across 'pod').

Each mesh function is a context manager.  One that opens a group
tears it down when its caller leaves the ``with``; a default group that
is already up is used as it is if its size matches the mesh, and
refused with an error if it does not.

:func:`launcher_group` joins the group a launcher (``torchrun``) set up
for this process: the torch form of a jax process that sees several
devices.  The trainer and the comm scope join through it.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: The process-group backend for each device: a run sent to the card
#: joins an NCCL group, never a gloo one.
BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def launcher_group(device: str) -> Optional[int]:
    """The world size of the default group this process belongs to, or
    None when there is none to join.

    A default group that is already up is the one (its backend must be
    ``device``'s).  Otherwise, when ``WORLD_SIZE`` is in the
    environment (``torchrun`` sets it, with ``RANK``, ``LOCAL_RANK``,
    ``MASTER_ADDR`` and ``MASTER_PORT``), the process joins that group
    by ``env://``: NCCL on the card ``LOCAL_RANK`` for ``cuda``, gloo
    for ``cpu``.  A group joined here stays up until its caller
    destroys it."""
    backend = BACKENDS[device]
    if dist.is_initialized():
        have = dist.get_backend()
        if have != backend:
            raise RuntimeError(f"this process already has a {have} process "
                               f"group; --device {device} needs {backend}")
        return dist.get_world_size()
    if "WORLD_SIZE" not in os.environ:
        return None
    if device == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend, init_method="env://")
    return dist.get_world_size()


@contextlib.contextmanager
def _default_group(world: int, fake: bool) -> Iterator[None]:
    """A default group of ``world`` ranks for the ``with`` body: the one
    that is up (its size must be ``world``), else a new one — fake, or
    a real one-rank group — destroyed on exit."""
    if dist.is_initialized():
        have = dist.get_world_size()
        if have != world:
            raise RuntimeError(
                f"a default process group of {have} ranks is up; this mesh "
                f"needs {world}: run it in a process of its own")
        yield
        return
    if fake:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    else:
        if world != 1:
            raise RuntimeError(f"no process group is up to hold {world} "
                               f"ranks")
        # gloo for either device: a one-rank mesh's steps run no
        # collective, and tracing one runs none at all
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
          device_type: str) -> DeviceMesh:
    ranks = torch.arange(math.prod(shape)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu") -> Iterator[DeviceMesh]:
    """The (16, 16) ``(data, model)`` mesh, or (2, 16, 16) ``(pod, data,
    model)`` with ``multi_pod``, over a fake group of 256 or 512
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    with make_mesh(shape, axes, device_type=device_type) as mesh:
        yield mesh


@contextlib.contextmanager
def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...],
              device_type: str = "cpu") -> Iterator[DeviceMesh]:
    """Any mesh over a fake group of ``prod(shape)`` ranks (e.g. (2, 4)
    on 8 in the tests)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    with _default_group(math.prod(shape), True):
        yield _mesh(tuple(shape), tuple(axes), device_type)


@contextlib.contextmanager
def make_host_mesh(model: Optional[int] = None,
                   device_type: str = "cpu") -> Iterator[DeviceMesh]:
    """(n // model, model) ``(data, model)`` over the group that is
    really up: its ranks, or one rank (a one-rank gloo group) opened for
    the ``with`` body."""
    model = model or 1
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % model:
        raise ValueError(f"{n} ranks do not split into model={model}")
    with _default_group(n, False):
        yield _mesh((n // model, model), ("data", "model"), device_type)
