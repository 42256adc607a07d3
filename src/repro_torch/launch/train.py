"""The trainer.

``python -m repro_torch.launch.train --arch llama3.2-1b --steps 200 ...``
on one card, or ``torchrun --nproc-per-node N -m
repro_torch.launch.train --model-parallel M ...`` on N.

The port of the JAX package's ``launch/train.py``, step for step: the
deterministic resumable data pipeline from the start step → restore or
init → the train step (microbatched, under the config's remat) →
checkpoints with keep-k GC → preemption-safe SIGTERM/SIGINT handling →
the straggler watchdog.

Under a launcher (``launch.mesh.launcher_group``: NCCL on the card,
gloo on the CPU; one rank counts) it follows the reference's one code
path: the ``(data, model)`` host mesh of ``model_parallel`` columns,
the logical rules of ``default_rules``, the state as ``DTensor``s
(parameters by ``param_specs``, AdamW's moments by ``zero_shard_specs``,
``count`` and ``step`` replicated), the gradients placed by the
moments' specs, and each rank's part of the same global batch.  Every
rank draws the full weights from the seed and keeps its shards, so a
meshed run starts from the one-card run's weights; checkpoints are
sharded, and a restore places them on this run's mesh, whatever mesh
wrote them.  With no launcher the state is plain tensors on one device
(``cuda`` by default): a 1×1 mesh places nothing.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import signal
import sys
import time
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.logging import get_logger
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.distributed import partition as part
from repro_torch.distributed.logical import (default_rules, is_dtensor,
                                             logical_rules)
from repro_torch.distributed.straggler import StragglerWatchdog
from repro_torch.launch.mesh import launcher_group, make_host_mesh
from repro_torch.models import build, family_module, get_config, tree
from repro_torch.models.config import ModelConfig
from repro_torch.train import (AdamWConfig, adamw_init, make_init_fn,
                               make_train_step)

log = get_logger("train")


def _state_like(cfg: ModelConfig) -> Dict[str, Any]:
    """The train state's structure on ``meta`` (what ``jax.eval_shape``
    gives the reference): the tree a checkpoint is restored into."""
    params = family_module(cfg).init(cfg, torch.Generator(), device="meta")
    opt = adamw_init(params)
    return {"params": params, "opt": opt,
            "step": torch.zeros((), dtype=torch.int32, device="meta")}


def check_split(world: int, model_parallel: int) -> None:
    """Refuse a ``model_parallel`` that does not divide the ranks (the
    reference's ``assert n % model == 0``)."""
    if model_parallel < 1 or world % model_parallel:
        raise ValueError(f"{world} ranks do not split into "
                         f"model={model_parallel}")


def _state_specs(cfg: ModelConfig, like, mesh) -> Dict[str, Any]:
    """The specs of the train state on ``mesh``: the reference's."""
    zero = part.zero_shard_specs(cfg, like["params"], mesh)
    return {"params": part.param_specs(cfg, like["params"], mesh),
            "opt": {"m": zero, "v": zero, "count": ()}, "step": ()}


def _value(t) -> float:
    return float(t.full_tensor() if is_dtensor(t) else t)


def train(arch: str, steps: int = 100, global_batch: int = 8,
          seq_len: int = 256, lr: float = 3e-4, microbatches: int = 1,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 50,
          model_parallel: int = 1, reduced: bool = True,
          log_every: int = 10, seed: int = 0,
          halt_at: Optional[int] = None,
          overrides: Optional[Dict[str, Any]] = None,
          device: str = "cuda") -> Dict[str, Any]:
    """Train ``arch`` for ``steps`` steps on ``device``.  ``halt_at``:
    stop early (simulated preemption) while keeping the ``steps``-horizon
    LR schedule — resume must continue it exactly.  Returns the
    reference's dict (``first_loss``, ``last_loss``, ``steps``,
    ``seconds``, ``tokens_per_s``) and ``history``: each step's
    ``loss``, ``grad_norm``, ``lr`` and fenced ``seconds``.

    ``model_parallel``: the host mesh's 'model' columns; it must divide
    the launcher's ranks (one rank with no launcher)."""
    kw = dict(steps=steps, global_batch=global_batch, seq_len=seq_len,
              lr=lr, microbatches=microbatches, ckpt_dir=ckpt_dir,
              ckpt_every=ckpt_every, reduced=reduced, log_every=log_every,
              seed=seed, halt_at=halt_at, overrides=overrides, device=device)
    opened = not dist.is_initialized()
    world = launcher_group(device)
    try:
        check_split(world or 1, model_parallel)
        if world is None:
            return _train(arch, None, **kw)
        with make_host_mesh(model_parallel, device_type=device) as mesh:
            return _train(arch, mesh, **kw)
    finally:
        if opened and dist.is_initialized():
            dist.destroy_process_group()


def _train(arch: str, mesh, *, steps: int, global_batch: int, seq_len: int,
           lr: float, microbatches: int, ckpt_dir: Optional[str],
           ckpt_every: int, reduced: bool, log_every: int, seed: int,
           halt_at: Optional[int], overrides: Optional[Dict[str, Any]],
           device: str) -> Dict[str, Any]:
    """:func:`train` on ``mesh`` (None: one device, plain tensors)."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    cfg = cfg.override(**(overrides or {}))
    api = build(cfg)
    opt_cfg = AdamWConfig(lr=lr, total_steps=steps,
                          warmup_steps=max(steps // 20, 5))
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                          global_batch=global_batch, seed=seed)
    dev = torch.device(device)
    init_fn = make_init_fn(api, opt_cfg)
    like = _state_like(cfg)
    if mesh is None:
        rules = contextlib.nullcontext()
        specs = grad_specs = None

        def place(tree_, _specs):
            return tree.map(lambda t: t.to(dev), tree_)
    else:
        rules = logical_rules(default_rules(cfg, mesh))
        specs = _state_specs(cfg, like, mesh)
        grad_specs = specs["opt"]["m"]

        def place(tree_, specs_):
            return part.distribute_tree(tree_, specs_, mesh)

    def fresh():
        # drawn on the device from the seed; on a mesh every rank draws
        # the full weights and keeps its shards
        state = init_fn(torch.Generator(device=dev).manual_seed(seed))
        return state if mesh is None else place(state, specs)

    ckpt = CheckpointManager(ckpt_dir, save_interval=ckpt_every) \
        if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        state, start = ckpt.restore_or_init(like, fresh, mesh=mesh,
                                            spec_tree=specs)
        if mesh is None:
            state = place(state, None)
        log.info("resumed at step %d", start)
    else:
        state, start = fresh(), 0

    step_fn = make_train_step(api, opt_cfg, num_microbatches=microbatches,
                              grad_specs=grad_specs)

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    if ckpt:
        latest: Dict[str, Any] = {"step": start, "state": state}
        ckpt.install_signal_handler(
            lambda: (latest["step"], latest["state"]))

    watchdog = StragglerWatchdog(
        num_hosts=dist.get_world_size() if mesh is not None else 1)
    pipe = make_pipeline(data_cfg, start_step=start)
    losses, history = [], []
    t_start = time.perf_counter()
    try:
        with rules:
            for step, batch in pipe:
                if step >= steps or (halt_at is not None
                                     and step >= halt_at):
                    break
                t0 = time.perf_counter()
                batch = {k: torch.from_numpy(v) for k, v in batch.items()}
                if cfg.family in ("audio", "encdec"):
                    batch["frames"] = torch.zeros(
                        (batch["tokens"].shape[0], cfg.enc_seq, cfg.d_model),
                        dtype=torch.float32)
                batch = place(batch, None if mesh is None else
                              part.input_specs_tree(cfg, batch, mesh))
                state, metrics = step_fn(state, batch)
                loss = _value(metrics["loss"])
                losses.append(loss)
                dt = time.perf_counter() - t0
                history.append({"step": step, "loss": loss,
                                "grad_norm": _value(metrics["grad_norm"]),
                                "lr": _value(metrics["lr"]), "seconds": dt})
                watchdog.record_step(np.asarray([dt]))
                if step % log_every == 0 or step == steps - 1:
                    log.info("step %d loss %.4f (%.0f tok/s)", step, loss,
                             global_batch * seq_len / dt)
                if ckpt:
                    latest = {"step": step + 1, "state": state}
                    ckpt.maybe_save(step + 1, state)
        if ckpt:
            ckpt.wait()
    finally:
        pipe.close()
        if ckpt:
            for s, h in handlers.items():
                signal.signal(s, h)

    total = time.perf_counter() - t_start
    return {"first_loss": losses[0] if losses else None,
            "last_loss": losses[-1] if losses else None,
            "steps": len(losses), "seconds": total,
            "tokens_per_s": len(losses) * global_batch * seq_len / total,
            "history": history}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config (default: reduced)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to train (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is available: the trainer runs on the "
                  "card; pass --device cpu to train on the CPU")
        return 2
    world = int(os.environ.get("WORLD_SIZE", "0")) or (
        dist.get_world_size() if dist.is_initialized() else 1)
    try:
        check_split(world, args.model_parallel)
    except ValueError as e:
        log.error("--model-parallel %d: %s (launch %d ranks or more with "
                  "torchrun)", args.model_parallel, e, args.model_parallel)
        return 2
    out = train(args.arch, steps=args.steps, global_batch=args.global_batch,
                seq_len=args.seq_len, lr=args.lr,
                microbatches=args.microbatches, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                model_parallel=args.model_parallel,
                reduced=not args.full_size, device=args.device)
    out.pop("history")
    log.info("done: %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
