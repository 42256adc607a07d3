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
        ("lint pre-flight: abort before anything is timed if a family "
         "provably mismeasures",
         "python -m repro_torch run --lint --strict --jobs 2"),
        ("delta run: skip instances whose fingerprint (body/fixture/"
         "kernel source, params, tuned artifact, torch/CUDA/nvcc version) "
         "already has a measured record; replay them as cached",
         "python -m repro_torch run --since --results-dir results"),
        ("delta run, but records older than Aug 1 don't count as fresh",
         "python -m repro_torch run --since 2026-08-01 --jobs 2"),
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
        ("delta plan: print only what ci would re-measure now "
         "(fingerprint-fresh instances are pruned)",
         "python -m repro_torch plan --since --results-dir results"),
    ],
    "ci": [
        ("per-commit gate: delta-plan against history, re-measure only "
         "fingerprint-stale instances, judge them against the pooled "
         "window, exit 1 on regression, then re-render the run's report",
         "python -m repro_torch ci --jobs 2 --results-dir results"),
        ("full sweep (no delta pruning) with a stricter gate",
         "python -m repro_torch ci --full --threshold 0.05 --window 10"),
        ("gate one scope's bf16 instances, skipping the report render",
         "python -m repro_torch ci --enable-scope mxu --param dtype=bf16 "
         "--no-report"),
        ("the same gate on the CPU",
         "python -m repro_torch ci --device cpu --enable-scope instr "
         "--results-dir results"),
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
    "lint": [
        ("static-analyze every enabled scope (AST + trace + registry "
         "tiers); exit 1 on error-severity findings",
         "python -m repro_torch lint"),
        ("the same on a host with no card: fixtures build on the CPU",
         "python -m repro_torch lint --device cpu"),
        ("lint one scope, failing on warnings too",
         "python -m repro_torch lint --scope example --strict"),
        ("machine-readable findings for CI",
         "python -m repro_torch lint --format json --strict"),
        ("fast editor loop: AST/registry tiers only, one family",
         "python -m repro_torch lint --no-compile --family example/saxpy"),
        ("run a single rule across every scope",
         "python -m repro_torch lint --rules SCOPE201"),
        ("print the rule catalog",
         "python -m repro_torch lint --list-rules"),
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
    "query": [
        ("every bf16 record in the run history, as a table",
         "python -m repro_torch query --param dtype=bf16"),
        ("per-instance statistics for one family: mean/stddev and "
         "streaming P² percentiles over run means and counters",
         "python -m repro_torch query --family mxu/matmul --aggregate "
         "--percentiles p50,p99,p999 --format json"),
        ("one machine's records in a date range, as verbatim history "
         "lines (byte-equivalent with or without the index)",
         "python -m repro_torch query --sysinfo 3f2a9c1d --since "
         "2026-08-01 --until 2026-08-07 --format jsonl"),
        ("prove the index changes cost, not answers",
         "python -m repro_torch query --family mxu/matmul --no-store "
         "--format jsonl"),
    ],
    "store": [
        ("build/refresh the SQLite index (incremental: only bytes past "
         "the watermark are read)",
         "python -m repro_torch store index --results-dir results"),
        ("drop and re-index from scratch (byte-deterministic)",
         "python -m repro_torch store index --rebuild"),
        ("merge two lab machines' history shards into this store, "
         "deduplicating whole runs by (run-id, sysinfo digest)",
         "python -m repro_torch store ingest lab-a.jsonl lab-b.jsonl"),
        ("index freshness, watermark and table counts",
         "python -m repro_torch store status --format json"),
        ("per-scope fingerprint coverage of card runs: instances fresh "
         "vs stale vs never-run on this machine",
         "python -m repro_torch store status --coverage"),
        ("the same for a history of --device cpu runs",
         "python -m repro_torch store status --coverage --device cpu"),
    ],
    "report": [
        ("render report/index.html + report.md (plots as SVG) for one run",
         "python -m repro_torch report 20260731T120000-42"),
        ("cross-run trend report over everything in history.jsonl",
         "python -m repro_torch report history --results-dir results"),
        ("wider drift window, custom output directory",
         "python -m repro_torch report 20260731T120000-42 --output "
         "/tmp/report --window 10"),
        ("live dashboard over the result store: trend sparklines, drift "
         "alerts, and JSON query endpoints next to the static report",
         "python -m repro_torch report history --serve --port 8000"),
        ("the same over a history of --device cpu runs (the coverage "
         "panel counts the instances a CPU run registers)",
         "python -m repro_torch report history --serve --device cpu"),
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
