"""Run one cell of the benchmark once and print its result line.

    python bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell (``BENCHMARK.json``'s
``workloads``) names a configuration and a traffic mix; set-up makes the
inputs and weights from ``--seed``, warms every shape the cell uses and
drives the port (``src/repro_torch``), then the window measures for
``--seconds``, and the plain reference checks what the window produced.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and ``checks``, each number compared beside its limit);
the checks are also the last lines of standard error.  Exits non-zero,
printing no result, without enough CUDA cards, on a card whose peaks
the benchmark does not list, or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "bench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch
    from bench.lib import harness, spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    peaks = spec.peaks(torch.cuda.get_device_name(device))
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device, T_START, peaks)
    print(f"bench: card {card_line()}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", file=sys.stderr)
    rec = result.pop("_record")
    print(f"bench: {harness.summary_line(rec)}", file=sys.stderr)
    bad = harness.forbidden_modules()
    if bad:
        print(f"bench: the process loaded {bad}", file=sys.stderr)
        return 4
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
