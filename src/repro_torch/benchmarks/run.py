"""Benchmark harness — one section per paper table/figure, on torch.

``python -m repro_torch.benchmarks.run [--device cuda|cpu]``

The port of the repository's ``benchmarks/run.py``:

  * Table IV (the scopes): every port scope runs through the port's run
    orchestrator (:mod:`repro_torch.core.orchestrate`) —
    failure-isolated, and parallel across benchmark instances when
    ``BENCH_JOBS>1``; each benchmark instance prints
    ``name,us_per_call,derived`` where ``derived`` is the scope's
    natural rate (GB/s, Mitems/s, modeled seconds, ...).  The scope list
    is the ScopeManager's builtin set — new scopes join the harness by
    joining ``BUILTIN_SCOPES``, nothing here to update;
  * Figure 3 (ScopePlot line plot): regenerates the example saxpy plot
    from live results via the port's spec pipeline, as SVG;
  * §Roofline feed: the model scope surfaces the dry-run cells when
    results/dryrun exists.

Times are the fenced wall times of ``--device`` (default ``cuda``; with
no card the harness exits 2 unless given ``--device cpu``).  The comm
scope's ``modeled_us`` column is the reference's analytic model of a
TPU v5e interconnect, computed, not measured on this machine.

Env knobs: ``BENCH_JOBS`` (worker parallelism, default 1 → inline),
``BENCH_SHARD_GRAIN`` (``auto``/``benchmark``/``scope``),
``BENCH_PARAM`` (typed-parameter selection, space-separated
``key=value`` pairs — e.g. ``BENCH_PARAM="dtype=bf16 backend=cuda"``
runs only matching instances of the typed parameter spaces),
``BENCH_RESULTS_DIR`` (persist shards + manifest + merged.json, and
append the run to ``<dir>/history.jsonl``), ``BENCH_BASELINE``
(baseline document/run dir/history.jsonl; adds a per-benchmark
``regression``/``improvement``/``similar`` verdict column),
``BENCH_REPORT`` (with BENCH_RESULTS_DIR: also render the run's
HTML/Markdown report — repro_torch.scopeplot.report).
"""
import argparse
import os
import sys


def _derived(rec) -> str:
    for key, scale, unit in (("bytes_per_second", 1e-9, "GB/s"),
                             ("items_per_second", 1e-6, "Mitems/s"),
                             ("modeled_s", 1e6, "modeled_us"),
                             ("cells", 1, "cells")):
        v = rec.raw.get(key)
        if v:
            return f"{v * scale:.3f}{unit}"
    ct = rec.raw.get("compile_time_s")
    if ct:
        # no natural rate: surface the warm-phase compile measurement
        return f"{ct * 1e3:.3f}compile_ms"
    return ""


def _print_shard(shard, verdicts=None) -> None:
    from repro_torch.scopeplot import BenchmarkFile
    if shard.status not in ("ok", "partial") or shard.doc is None:
        first = shard.error.strip().splitlines()[-1] if shard.error else \
            shard.status
        print(f"{shard.scope}/SCOPE_FAILED,0.00,{first}")
        return
    bf = BenchmarkFile.from_dict(shard.doc)
    for rec in bf:
        if rec.raw.get("run_type") == "aggregate" or rec.raw.get("skipped"):
            continue
        if rec.raw.get("error_occurred"):
            # a failed instance must stay visible in the table — that is
            # the point of per-instance failure isolation
            msg = (rec.raw.get("error_message") or "error").strip()
            lines = msg.splitlines()
            # "[crashed] worker exited N:" leads; tracebacks end with the
            # exception — pick whichever line carries the signal
            derived = (lines[0] if msg.startswith("[crashed]")
                       else lines[-1]).replace(",", ";")
        else:
            derived = _derived(rec)
        us = rec.real_time_seconds()
        us = us * 1e6 if us is not None else float("nan")
        line = f"{rec.name},{us:.2f},{derived}"
        if verdicts is not None:
            run_name = rec.raw.get("run_name") or rec.name
            line += f",{verdicts.get(run_name, '')}"
        print(line)


def _baseline_verdicts(doc):
    """run_name → verdict against ``BENCH_BASELINE``; None when unset.

    A bad baseline path must not discard a finished run — degrade to no
    verdict column with a warning.
    """
    path = os.environ.get("BENCH_BASELINE")
    if not path:
        return None
    import json
    from repro_torch.core.baseline import compare_documents, load_document
    try:
        base = load_document(path)
    except (OSError, json.JSONDecodeError) as e:
        print(f"BENCH_BASELINE {path} unreadable ({e}); "
              f"skipping verdict column", file=sys.stderr)
        return None
    comps = compare_documents(base, doc)
    return {c.name: c.verdict for c in comps}


def run_all(min_time: float = 0.02, device: str = "cuda"):
    """Run every builtin scope through the orchestrator on ``device``.

    Returns (RunResult, unavailable, scope_names) where ``unavailable``
    maps scopes that failed to import/register to their tracebacks — the
    orchestrator never schedules those, but the harness must still report
    them — and ``scope_names`` is the ScopeManager's load order, so the
    harness can't silently miss a scope the binary knows about.
    """
    from repro_torch.core import (FLAGS, REGISTRY, RunOptions,
                                  parse_param_filter)
    from repro_torch.core.orchestrate import OrchestratorOptions, execute
    from repro_torch.core.scope import ScopeManager

    jobs = int(os.environ.get("BENCH_JOBS", "1"))
    try:
        param_filter = parse_param_filter(
            os.environ.get("BENCH_PARAM", "").split())
    except ValueError as e:
        sys.exit(f"BENCH_PARAM: {e}")
    REGISTRY.reset()
    FLAGS.set("device", device)          # the scopes register for it
    mgr = ScopeManager()
    mgr.load(None)                       # BUILTIN_SCOPES — the Table IV set
    mgr.register_all()
    scope_names = [s.scope.name for s in mgr.scopes()]
    opts = OrchestratorOptions(
        jobs=jobs,
        shard_grain=os.environ.get("BENCH_SHARD_GRAIN", "auto"),
        run=RunOptions(min_time=min_time, param_filter=param_filter,
                       device=device),
        flag_values={s.name: FLAGS.get(s.name) for s in FLAGS.declared()},
        results_dir=os.environ.get("BENCH_RESULTS_DIR"),
    )
    result = execute(mgr, REGISTRY, opts,
                     context_extra={"scopes": mgr.status()})
    unavailable = {s.scope.name: s.error for s in mgr.scopes()
                   if not s.available}
    return result, unavailable, scope_names


def figure3_plot(docs) -> None:
    """Regenerate the paper's Fig. 3-style line plot via ScopePlot."""
    import json
    import tempfile
    from repro_torch.scopeplot.plot import render_spec
    ex = docs.get("example")
    if ex is None:
        return
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "example.json")
        with open(src, "w") as f:
            json.dump(ex, f)
        spec = {
            "title": "saxpy throughput (Fig. 3 analogue)",
            "type": "line",
            "output": os.path.join("results", "fig3_saxpy.svg"),
            "x_axis": {"label": "elements", "scale": "log"},
            "y_axis": {"label": "GB/s"},
            "series": [{"label": "saxpy", "input_file": src,
                        "regex": "example/saxpy", "xfield": "n",
                        "yfield": "bytes_per_second", "yscale": 1e-9}],
        }
        os.makedirs("results", exist_ok=True)
        out = render_spec(spec)
        print(f"fig3_plot,0.00,{out}")


def _report(result) -> None:
    """Render the run's report when BENCH_REPORT + BENCH_RESULTS_DIR ask
    for one.  Report failure must not fail the harness run."""
    if not (os.environ.get("BENCH_REPORT") and result.out_dir):
        return
    try:
        from repro_torch.scopeplot.report import generate_run_report
        paths = generate_run_report(result.out_dir)
        print(f"report,0.00,{paths['html']}")
    except Exception as e:  # noqa: BLE001 - artifact, not a gate
        print(f"BENCH_REPORT failed ({e}); skipping report",
              file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the scopes run (default: the card)")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("no CUDA device is available; pass --device cpu to run "
                  "the harness on the CPU", file=sys.stderr)
            return 2
    result, unavailable, scopes = run_all(device=args.device)
    verdicts = _baseline_verdicts(result.doc)
    param_active = bool(os.environ.get("BENCH_PARAM", "").strip())
    docs = {}
    for scope in scopes:
        shard = result.shard(scope)
        if shard is None:
            if scope not in unavailable and param_active:
                # deselected, not broken: no instance matched BENCH_PARAM
                print(f"{scope}/SKIPPED,0.00,no instance matches "
                      f"BENCH_PARAM")
                continue
            err = unavailable.get(scope, "not scheduled")
            last = err.strip().splitlines()[-1] if err else "not scheduled"
            print(f"{scope}/SCOPE_FAILED,0.00,{last}")
            continue
        _print_shard(shard, verdicts)
        if shard.status in ("ok", "partial"):
            docs[scope] = shard.doc
    figure3_plot(docs)
    _report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
