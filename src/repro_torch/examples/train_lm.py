"""End-to-end driver: train a ~100M-param LM for a few hundred steps.

Uses the production path on one device: deterministic pipeline, the
microbatched train step, async checkpointing with resume.  ~100M params
= llama3.2-1b reduced to d_model=512/8L with the full 128k vocab.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
      [--device cpu]
"""
import argparse
import os
import tempfile

from repro_torch.examples import parse_args
from repro_torch.launch.train import train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_lm"))
    args = parse_args(ap, argv)
    out = train(
        "llama3.2-1b",
        steps=args.steps,
        global_batch=8,
        seq_len=256,
        lr=1e-3,
        microbatches=2,
        ckpt_dir=args.ckpt,
        ckpt_every=100,
        overrides=dict(num_layers=8, d_model=512, num_heads=8,
                       num_kv_heads=4, head_dim=64, d_ff=2048),
        reduced=False,
        log_every=25,
        device=args.device,
    )
    print(f"\ntrained {out['steps']} steps: "
          f"loss {out['first_loss']:.3f} -> {out['last_loss']:.3f} "
          f"({out['tokens_per_s']:.0f} tok/s)")
    assert out["last_loss"] < out["first_loss"], "loss should decrease"


if __name__ == "__main__":
    main()
