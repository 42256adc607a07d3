"""The one-card trainer.

``python -m repro_torch.launch.train --arch llama3.2-1b --steps 200 ...``

The port of the JAX package's ``launch/train.py``, step for step but
for the mesh: the deterministic resumable data pipeline from the start
step → restore or init → the train step (microbatched, under the
config's remat) → async checkpoints with keep-k GC → preemption-safe
SIGTERM/SIGINT handling → the straggler watchdog.  It runs on one
device (``cuda`` by default); a model-parallel mesh is not ported yet.
"""
from __future__ import annotations

import argparse
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
from repro_torch.distributed.straggler import StragglerWatchdog
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


def _process_count() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


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
    ``loss``, ``grad_norm``, ``lr`` and fenced ``seconds``."""
    if model_parallel != 1:
        raise ValueError(f"model_parallel={model_parallel}: a model-"
                         f"sharded mesh is not yet ported (#7)")
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

    def fresh():
        return init_fn(torch.Generator(device=dev).manual_seed(seed))

    ckpt = CheckpointManager(ckpt_dir, save_interval=ckpt_every) \
        if ckpt_dir else None
    if ckpt and ckpt.latest_step() is not None:
        host_state, start = ckpt.restore_or_init(_state_like(cfg), fresh)
        state = tree.map(lambda t: t.to(dev), host_state)
        log.info("resumed at step %d", start)
    else:
        state, start = fresh(), 0

    step_fn = make_train_step(api, opt_cfg, num_microbatches=microbatches)

    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    if ckpt:
        latest: Dict[str, Any] = {"step": start, "state": state}
        ckpt.install_signal_handler(
            lambda: (latest["step"], latest["state"]))

    watchdog = StragglerWatchdog(num_hosts=_process_count())
    pipe = make_pipeline(data_cfg, start_step=start)
    losses, history = [], []
    t_start = time.perf_counter()
    try:
        for step, batch in pipe:
            if step >= steps or (halt_at is not None and step >= halt_at):
                break
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            if cfg.family in ("audio", "encdec"):
                batch["frames"] = torch.zeros(
                    (batch["tokens"].shape[0], cfg.enc_seq, cfg.d_model),
                    dtype=torch.float32, device=dev)
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            losses.append(loss)
            dt = time.perf_counter() - t0
            history.append({"step": step, "loss": loss,
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]), "seconds": dt})
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
    if args.model_parallel != 1:
        log.error("--model-parallel %d: a model-sharded mesh is not yet "
                  "ported (#7)", args.model_parallel)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is available: the trainer runs on the "
                  "card; pass --device cpu to train on the CPU")
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
