"""Comm|Scope — collectives, measured on the run's device and modeled.

The port of the JAX package's comm scope.  Two measurement modes, the
same axis at two abstraction levels:

  * measured — ``all_reduce_measured`` runs ``torch.distributed.
    all_reduce`` over the process's group: NCCL for ``--device cuda``,
    gloo for ``--device cpu``, chosen by the flag and never as a
    fallback.  Under a launcher (``torchrun``) that is the launcher's
    group of all its ranks (``launch.mesh.launcher_group``), each rank
    reducing one row of ``bytes``, as each device of the reference's
    mesh does; with no launcher it is a group of this process alone,
    the copy baseline, as the reference's one-device ``psum`` is.  The
    ranks of a collective must run alike, so over several ranks the
    family runs ``RANKS_ITERATIONS`` iterations a batch where one rank
    calibrates its own count from its own clock.  A
    one-rank group's rendezvous is an in-process ``HashStore`` (no TCP
    port: every worker of ``--jobs N`` builds its own), and a group
    that already exists in the process is reused, since
    ``init_process_group`` may run once a process;
  * modeled — ``collective_modeled_v5e`` is the reference's analytic
    ring-collective model on one ICI axis of its TPU v5e mesh (ring
    all-reduce 2(n-1)/n, all-gather (n-1)/n, all-to-all (n-1)/n²),
    ported verbatim with the reference's link bandwidth as its model
    input, so its records equal the reference's.  It touches no device
    and says nothing about this machine's links.
"""
import atexit
import os

import torch
import torch.distributed as dist

from repro_torch.core import FLAGS, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.launch.mesh import BACKENDS, launcher_group

NAME = "comm"

#: The modeled family's link bandwidth, B/s per ICI link: the input of
#: the reference's analytic v5e model (its sysinfo table), kept here so
#: that the modeled records equal the reference's.
V5E_ICI_LINK_BANDWIDTH = 50e9

#: Iterations a batch of ``all_reduce_measured`` over several ranks:
#: every rank must run as many all-reduces as the others.
RANKS_ITERATIONS = 100


def modeled_collective_seconds(kind: str, nbytes: int, axis_size: int,
                               link_bw: float = None) -> float:
    """Analytic ring-collective time on one ICI axis (v5e)."""
    bw = link_bw or V5E_ICI_LINK_BANDWIDTH
    n = axis_size
    if n <= 1:
        return 0.0
    factor = {"all_reduce": 2.0 * (n - 1) / n,
              "all_gather": (n - 1) / n,
              "reduce_scatter": (n - 1) / n,
              "all_to_all": (n - 1) / (n * n),
              "ppermute": 1.0}[kind]
    # bidirectional ring: 2 links usable per axis
    return factor * nbytes / (2 * bw)


def process_group(device: str) -> str:
    """The default process group for ``device``'s backend: the one that
    is up or the launcher's (``launcher_group``), else one made for this
    process alone (one rank, an in-process store); returns its backend.
    A group of the other backend raises: a run sent to the card never
    all-reduces on gloo."""
    opened = not dist.is_initialized()
    if launcher_group(device) is None:
        dist.init_process_group(BACKENDS[device], store=dist.HashStore(),
                                rank=0, world_size=1)
    if opened:
        atexit.register(_destroy)
    return dist.get_backend()


def _ranks() -> int:
    """The ranks of the group this process is in, or will join under a
    launcher (``WORLD_SIZE``)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", "1"))


def _destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _all_reduce(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    dist.all_reduce(out)
    return out


def _register(registry: BenchmarkRegistry) -> None:
    def all_reduce_setup(params):
        device = FLAGS.get("device")
        process_group(device)
        # this rank's row of the (ranks, bytes / 4) operand
        x = torch.ones((1, params.bytes // 4), dtype=torch.float32,
                       device=torch.device(device))
        return _all_reduce, x

    @benchmark(scope=NAME, registry=registry)
    def all_reduce_measured(state: State):
        """all_reduce over the process's group, ``bytes`` a rank (1 rank
        → copy baseline); the group lives in the fixture, the reduced
        tensor is the sync deliverable."""
        f, x = state.fixture
        while state.keep_running():
            state.deliver(f(x))
        state.set_bytes_processed(state.params.bytes)
        state.counters["devices"] = dist.get_world_size()
    all_reduce_measured.range_multiplier_args(1 << 16, 1 << 22, mult=8)
    all_reduce_measured.set_arg_names(["bytes"])
    all_reduce_measured.set_fixture(all_reduce_setup)
    if _ranks() > 1:
        all_reduce_measured.set_iterations(RANKS_ITERATIONS)

    @benchmark(scope=NAME, registry=registry)
    def collective_modeled_v5e(state: State):
        """Analytic v5e ICI collective over one mesh axis — the ``kind``
        axis covers every collective."""
        p = state.params
        t = modeled_collective_seconds(p.kind, p.bytes, p.axis)
        state.set_iteration_time(t)
        while state.keep_running():
            state.set_iteration_time(t)
        state.counters["modeled_s"] = t
        state.counters["axis_size"] = p.axis
        state.set_bytes_processed(p.bytes)

    collective_modeled_v5e.param_space(
        kind=["all_reduce", "all_gather", "reduce_scatter", "all_to_all"],
        bytes=[1 << 20, 1 << 24, 1 << 28],
        axis=[16, 256])
    collective_modeled_v5e.manual_time().set_iterations(1)


SCOPE = Scope(name=NAME, version="2.0.0",
              description="Interconnect collectives: measured + v5e model",
              register=_register)
