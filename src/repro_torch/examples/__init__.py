"""Runnable examples of the torch port, each ``python -m
repro_torch.examples.<name> [--device cuda|cpu]`` (the ports of the
repository's ``examples/*.py``): ``quickstart``, ``characterize``,
``serve_lm`` and ``train_lm``."""
import argparse
import sys
from typing import List, Optional

import torch


def parse_args(ap: argparse.ArgumentParser,
               argv: Optional[List[str]] = None) -> argparse.Namespace:
    """``ap``'s arguments plus ``--device`` (default ``cuda``); exits 2
    when the card is asked for and there is none, as ``python -m
    repro_torch run`` does."""
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the example runs (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available; pass --device cpu to run on "
              "the CPU", file=sys.stderr)
        sys.exit(2)
    return args
