"""Serving driver: batched requests through the continuous-batching engine.

``python -m repro_torch.launch.serve --arch llama3.2-1b --requests 16``

The port of the JAX package's ``launch/serve.py`` over
:class:`repro_torch.serve.ServeEngine`, on one device (``--device``,
``cuda`` by default; with no card it exits 2 unless given ``--device
cpu``).  ``serve_demo`` uses the reduced config by default;
``reduced=False`` serves the published width and depth.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.core.logging import get_logger
from repro_torch.models import build, get_config
from repro_torch.serve import ServeConfig, ServeEngine

log = get_logger("serve-main")


def serve_demo(arch: str, n_requests: int = 16, max_tokens: int = 16,
               max_batch: int = 4, reduced: bool = True, seed: int = 0,
               device: str = "cuda"):
    """Serve ``n_requests`` random prompts of 4–23 tokens, ``max_tokens``
    each, from ``max_batch`` slots of 256 positions; returns the
    engine's summary stats."""
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    api = build(cfg)
    params = api.init(torch.Generator(device=device).manual_seed(seed))
    engine = ServeEngine(api, params, ServeConfig(
        max_batch=max_batch, max_len=256, prompt_buckets=(16, 32, 64)))
    rng = np.random.default_rng(seed)
    for _ in range(n_requests):
        plen = int(rng.integers(4, 24))
        prompt = rng.integers(1, cfg.vocab_size, size=plen)
        engine.submit(prompt, max_tokens=max_tokens)
    done = engine.run()
    stats = ServeEngine.summarize(done)
    log.info("served %s", stats)
    return stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="serve")
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="device the engine serves on (default: cuda)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is available; pass --device cpu to "
                  "serve on the CPU")
        return 2
    serve_demo(args.arch, args.requests, args.max_tokens, args.max_batch,
               device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
