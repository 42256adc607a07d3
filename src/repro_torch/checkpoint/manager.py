"""CheckpointManager: async save, keep-k GC, preemption-safe restart.

The port of the JAX package's ``checkpoint/manager.py``, writing through
the port's :mod:`~repro_torch.checkpoint.store` in the reference's
on-disk format.  The contract is the reference's:

  * ``maybe_save`` snapshots the state to the host (synchronously: one
    ``t.detach().to("cpu", copy=True)`` a tensor leaf, or of this
    rank's shard of a ``DTensor``, taken before the caller's next step
    can write the tensors in place, as the reference's
    ``jax.device_get`` is taken before the buffers are donated) and
    writes the files on a background thread.  With several ranks the
    write is made before ``maybe_save`` returns: its barriers and
    gather are collectives of the default group, which a writer thread
    would issue out of order with the step's;
  * a save is atomic (tmp + rename, see ``store.py``) and counts in
    ``latest_step`` only once it is on disk;
  * keep-k garbage collection never deletes the newest complete
    checkpoint;
  * ``install_signal_handler`` turns SIGTERM/SIGINT (preemption) into a
    final synchronous save and a clean exit, so a restart resumes
    exactly;
  * ``restore_or_init`` falls back through the checkpoints newest first,
    skipping any that fail checksum verification (torn writes); given a
    mesh and specs it places the state on that mesh
    (``restore_resharded``), whatever mesh wrote it.
"""
from __future__ import annotations

import os
import re
import shutil
import signal
import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from repro_torch.core.logging import get_logger
from .store import (load_checkpoint, local_shard, process_count,
                    restore_resharded, save_checkpoint)

log = get_logger("ckpt")

_STEP_RE = re.compile(r"step_(\d+)$")


def _snapshot(tree: Any) -> Any:
    """A host copy of every tensor leaf (never a view of a CPU tensor
    the caller may write next), of this rank's shard of a ``DTensor``
    (a ``store.LocalShard``); other leaves as they are."""
    from repro_torch.distributed.logical import is_dtensor
    if is_dtensor(tree):
        return local_shard(tree, to_host=True)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [_snapshot(v) for v in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else type(tree)(items)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 save_interval: int = 100, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.save_interval = save_interval
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # -- discovery ------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            m = _STEP_RE.search(name)
            if m and not name.endswith(".tmp"):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def path_for(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    # -- saving ---------------------------------------------------------
    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.save_interval == 0

    def maybe_save(self, step: int, tree, extra: Optional[Dict] = None,
                   force: bool = False) -> bool:
        if not (force or self.should_save(step)):
            return False
        self.wait()                       # one outstanding save at a time
        # snapshot to the host NOW: the next step writes the tensors in
        # place
        host_tree = _snapshot(tree)

        def work():
            try:
                save_checkpoint(self.path_for(step), host_tree, step, extra)
                self._gc()
                log.info("saved checkpoint step %d", step)
            except BaseException as e:  # noqa: BLE001 - raised in check()
                self._error = e

        if self.async_save and process_count() == 1:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            self.check()
        return True

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self) -> None:
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self.path_for(s), ignore_errors=True)
            log.info("gc checkpoint step %d", s)

    # -- restoring ------------------------------------------------------
    def restore_or_init(self, tree_like, init_fn: Callable[[], Any],
                        mesh=None, spec_tree=None) -> Tuple[Any, int]:
        """Newest valid checkpoint, else ``init_fn()`` at step 0: host
        tensors, or with ``mesh`` and ``spec_tree`` ``DTensor``s placed
        on ``mesh`` by the specs."""
        for step in reversed(self.steps()):
            try:
                if mesh is None:
                    tree, s = load_checkpoint(self.path_for(step), tree_like)
                else:
                    tree, s = restore_resharded(self.path_for(step),
                                                tree_like, mesh, spec_tree)
                log.info("restored checkpoint step %d", s)
                return tree, s
            except Exception as e:  # noqa: BLE001 - fall through older ckpts
                log.warning("checkpoint step %d unusable (%s); trying older",
                            step, e)
        return init_fn(), 0

    # -- preemption -----------------------------------------------------
    def install_signal_handler(self, get_state: Callable[[], Tuple[int, Any]]
                               ) -> None:
        def handler(signum, frame):
            step, tree = get_state()
            log.warning("signal %d: saving step %d before exit", signum, step)
            self.wait()
            self.maybe_save(step, tree, force=True)
            self.wait()
            sys.exit(0)

        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
