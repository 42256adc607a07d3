"""Spawned gloo ranks for the port's multi-rank tests, each run under a
deadline.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes
(``spawn``), each joining one gloo group through a ``FileStore`` under
``tmp_path`` and calling ``fn(rank, *args)``; a rank's exception fails
the test with its traceback, and ranks still running at the deadline
are killed and fail it too, so a test never hangs.
"""
import os
import time

import pytest
import torch.multiprocessing as mp

#: Seconds a spawn may take, its processes' start included.
DEADLINE_S = 240


def _rank(rank, fn, store_path, world, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    os.environ["GLOO_SOCKET_IFNAME"] = "lo"
    if world:
        dist.init_process_group("gloo",
                                store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, world, tmp_path, *args, deadline_s=DEADLINE_S,
              join_group=True):
    """``fn(rank, *args)`` on ``world`` spawned ranks in one gloo group
    (with ``join_group=False`` the ranks join nothing and ``fn`` may
    join one itself).  ``fn`` must be importable (a module-level
    function)."""
    store = str(tmp_path / f"store-{time.monotonic_ns()}")
    ctx = mp.start_processes(
        _rank, args=(fn, store, world if join_group else 0, args),
        nprocs=world, join=False, start_method="spawn")
    end = time.monotonic() + deadline_s
    try:
        while not ctx.join(timeout=max(end - time.monotonic(), 0.0)):
            if time.monotonic() >= end:
                pytest.fail(f"{world} ranks still running after "
                            f"{deadline_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
