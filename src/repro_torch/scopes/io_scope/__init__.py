"""I/O|Scope — disk I/O operations (paper Table IV): checkpoint and
data-pipeline throughput.

The port of the JAX package's io scope.  One typed ``checkpoint``
family with an ``op`` axis saves or restores a float32 tree made on the
run's device (a CUDA tree is copied to the host to be written, as the
reference's is); ``data_pipeline`` draws synthetic-LM batches.  Both
complete their work on the host inside the timed loop, so they declare
a no-op sync fence (``set_sync``) instead of deliverables.
"""
import os
import tempfile

import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry

NAME = "io"


def _register(registry: BenchmarkRegistry) -> None:
    @benchmark(scope=NAME, registry=registry)
    def checkpoint(state: State):
        """Checkpoint save/restore throughput (repro_torch.checkpoint);
        the ``op`` axis selects the direction."""
        from repro_torch.checkpoint import load_checkpoint, save_checkpoint
        mb = state.params.MiB
        tree = {"w": torch.ones((mb * 1024 * 256,), dtype=torch.float32,
                                device=torch.device(FLAGS.get("device")))}
        with tempfile.TemporaryDirectory() as d:
            if state.params.op == "save":
                i = 0
                while state.keep_running():
                    save_checkpoint(os.path.join(d, f"ck{i}"), tree, step=i)
                    i += 1
            else:
                path = save_checkpoint(os.path.join(d, "ck"), tree, step=0)
                while state.keep_running():
                    load_checkpoint(path, tree)
        state.set_bytes_processed(mb * 1024 * 1024)
    checkpoint.param_space(
        ParamSpace.product(op=["save", "restore"], MiB=[4, 32]))
    checkpoint.set_sync(lambda ctx: None)      # host-synchronous

    @benchmark(scope=NAME, registry=registry)
    def data_pipeline(state: State):
        """Synthetic-LM pipeline batches/s (repro_torch.data, no
        prefetch)."""
        from repro_torch.data import DataConfig, SyntheticLM
        seq = state.range(0)
        src = SyntheticLM(DataConfig(vocab_size=32000, seq_len=seq,
                                     global_batch=8))
        i = 0
        while state.keep_running():
            src.batch(i)
            i += 1
        state.set_items_processed(8 * seq)
    data_pipeline.args([512]).args([2048]).set_arg_names(["seq"])
    data_pipeline.set_sync(lambda ctx: None)   # host-synchronous


SCOPE = Scope(name=NAME, version="2.0.0",
              description="checkpoint + data-pipeline I/O",
              register=_register)
