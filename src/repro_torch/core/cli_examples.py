"""Copy-pasteable ``--help`` examples for every ``python -m repro_torch``
command (a copy of ``repro.core.cli_examples``, for the commands the
port has).

Kept as data (not inline strings) so the tests can assert two things
that otherwise rot silently: every example appears verbatim in its
subcommand's ``--help`` epilog, and every example still *parses*
against the current argument surface.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

# command → [(what it does, exact command line), ...]
EXAMPLES: Dict[str, List[Tuple[str, str]]] = {
    "run": [
        ("run every scope on the card in 4 isolated workers; shards, "
         "merged.json and history land under results/<run-id>/",
         "python -m repro_torch run --jobs 4 --results-dir results"),
        ("finish an interrupted run: completed instances are skipped",
         "python -m repro_torch run --jobs 4 --results-dir results "
         "--resume 20260731T120000-42"),
        ("one scope, one benchmark family, plain GB-JSON to a file",
         "python -m repro_torch run --enable-scope example "
         "--benchmark_filter example/saxpy --benchmark_out saxpy.json"),
        ("the same on the CPU, with nothing persisted",
         "python -m repro_torch run --device cpu --enable-scope example "
         "--results-dir ''"),
        ("run only the bf16 points of every typed parameter space",
         "python -m repro_torch run --param dtype=bf16 --jobs 2"),
        ("device-fenced wall time, real CPU time, and flops/"
         "bytes_accessed counters on every record",
         "python -m repro_torch run --meters wall,cpu,costmodel --jobs 2"),
        ("repetition statistics only, with throughput and meter "
         "counters carried onto the aggregate records",
         "python -m repro_torch run --benchmark_repetitions 5 "
         "--aggregates-only"),
        ("gate against the windowed run history (exit 1 on regression)",
         "python -m repro_torch run --jobs 2 "
         "--baseline results/history.jsonl"),
        ("store this run as the baseline for later gating",
         "python -m repro_torch run --save-baseline results/baseline.json"),
    ],
    "plan": [
        ("print every benchmark instance with its predicted cost and "
         "LPT worker-bin assignment",
         "python -m repro_torch plan --jobs 4"),
        ("use a prior run's measured durations as cost hints",
         "python -m repro_torch plan --jobs 4 "
         "--costs results/20260731T120000-42"),
        ("plan only one backend's instances of the typed spaces",
         "python -m repro_torch plan --param backend=cuda"),
    ],
    "tune": [
        ("screen + hill-climb the matmul tile space under a 16-trial "
         "budget; the winner becomes the kernel's tuned.json default "
         "for the variant and card it ran",
         "python -m repro_torch tune mxu/matmul --budget 16 --seed 0"),
        ("the same for the 1024-point bf16 instance only, with the "
         "artifact kept out of the source tree",
         "python -m repro_torch tune mxu/matmul --param n=1024 "
         "--output build/tuned/matmul.json"),
        ("spend the budget on configs a prior tune run measured cheapest",
         "python -m repro_torch tune mxu/matmul --budget 8 "
         "--costs results/20260731T120000-42"),
        ("maximize the cost-model FLOP rate instead of minimizing wall "
         "time",
         "python -m repro_torch tune mxu/matmul --objective "
         "flops_per_second --budget 12"),
        ("screening only: rank the axes by sensitivity without refining",
         "python -m repro_torch tune nn/rmsnorm --strategy screening"),
        ("list every family that declares a tunable kernel space",
         "python -m repro_torch tune --list"),
    ],
    "compare": [
        ("mean/stddev-aware diff of two runs (exit 1 on regression)",
         "python -m repro_torch compare results/baseline.json "
         "results/20260731T120000-42"),
        ("diff the latest run against the windowed history baseline",
         "python -m repro_torch compare results/history.jsonl "
         "results/20260731T120000-42 --threshold 0.05"),
        ("compare only the bf16 instances of two runs",
         "python -m repro_torch compare results/baseline.json "
         "results/20260731T120000-42 --param dtype=bf16"),
    ],
}


def epilog(command: str) -> str:
    """RawDescriptionHelpFormatter-ready examples block for ``command``."""
    lines = ["examples:"]
    for what, cmd in EXAMPLES.get(command, []):
        lines.append(f"  # {what}")
        lines.append(f"  $ {cmd}")
        lines.append("")
    return "\n".join(lines).rstrip()
