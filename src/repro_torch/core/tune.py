"""``python -m repro_torch tune`` — search-driven kernel autotuning.

The port of ``repro.core.tune``.  A tunable family
(``Benchmark.set_tunable``) names the :mod:`repro_torch.kernels.tuning`
kernel it measures and the knob space to search; this command explores
that space with :mod:`repro_torch.core.search` (factorial screening →
greedy hill-climb under a trial budget), running the family's instance
once per candidate config through ``runner.run_single_instance`` + the
MeterStack, then

  * records every trial in ``<results-dir>/<run-id>/merged.json`` and
    appends them to ``history.jsonl`` tagged ``tune`` (trial names are
    ``tune/<kernel>/<knob:value>/...`` so scope trend plots never
    confuse them with benchmark records), with a ``tune.json`` summary;
  * writes the winner to the kernel's ``tuned.json`` artifact, under
    the card's name and the variant the instance ran, which every
    kernel wrapper then loads as that variant's default tile there.

What the port adds to the reference's flow: a kernel's variants take
different tiles, so before the search the instance runs once with the
builtin tiles (:func:`repro_torch.kernels.tuning.builtins`) and the
wrapper's record of what it resolved (``tuning.last_resolved``) says
which variant, on which device, the trials tune, and what the builtin
tile is there (matmul ``simt``'s bn follows the shape).  That run is
no trial: it also warms the process (allocator, libraries, caches), so
that the builtin baseline, measured next like any trial, is not the
only one to pay a first run.  Trials override that variant only.
``--device`` is ``run``'s (``cuda`` by default; with no CUDA device the
command exits 2 unless given ``--device cpu``).  Unless
``--no-report``, the run's report (speedup bars and the sensitivity
table, :func:`repro_torch.scopeplot.report.generate_tune_report`) is
rendered under ``<run-dir>/report/`` and its path printed; a report
that fails is logged and never loses the tune.

Determinism: with a fixed ``--seed`` the candidate plan is a pure
function of the space and the measured scores; ``--costs`` reorders
candidate evaluation toward configs a prior tune run measured cheapest.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Mapping, Optional

from . import logging as scope_logging
from .benchmark import (Params, TIME_UNITS, format_value, match_params,
                        parse_param_filter)
from .cli_examples import epilog
from .flags import FLAGS
from .history import append_run, doc_counters
from .measure import parse_meters
from .plan import load_cost_hints
from .registry import REGISTRY
from .runner import RunOptions, run_single_instance, write_json
from .search import (STRATEGIES, SearchResult, TrialError, lower_is_better,
                     run_search)

log = scope_logging.get_logger("tune")

#: Tune trials measure cost-model counters by default — the Pareto
#: frontier wants ``flops_per_second`` next to ``real_time_s``.
DEFAULT_TUNE_METERS = ["wall", "cpu", "costmodel"]


def build_tune_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch tune",
                                 add_help=False, epilog=epilog("tune"),
                                 formatter_class=
                                 argparse.RawDescriptionHelpFormatter)
    ap.add_argument("family", nargs="?", default=None,
                    help="a tunable benchmark family (registered name, "
                         "e.g. mxu/matmul); see --list")
    ap.add_argument("--list", action="store_true",
                    help="list every family that declares a tunable "
                         "kernel space, then exit")
    ap.add_argument("--budget", type=int, default=16,
                    help="hard cap on measured configs (default 16); "
                         "cached repeats are free, the builtin-default "
                         "baseline is measured outside the budget when "
                         "it lies outside the space")
    ap.add_argument("--strategy", default="auto",
                    choices=list(STRATEGIES),
                    help="auto = factorial screening, then hill-climb "
                         "from the best screened configs (default)")
    ap.add_argument("--objective", default="real_time_s",
                    metavar="METRIC",
                    help="trial metric to optimize (default real_time_s; "
                         "minimized unless it ends in _per_second — "
                         "e.g. flops_per_second needs the costmodel "
                         "meter)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for the hill-climb's neighbor ordering "
                         "(default 0; same seed ⇒ same trial plan)")
    ap.add_argument("--param", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="override/narrow the instance the trials drive "
                         "(merged over the family's tunable instance "
                         "filter)")
    ap.add_argument("--meters", default=None, metavar="LIST",
                    help="comma-separated meters per trial (default "
                         "wall,cpu,costmodel)")
    ap.add_argument("--costs", default=None, metavar="PATH",
                    help="prior run directory or GB-JSON document; "
                         "matching trial names steer the budget toward "
                         "cheap configs first")
    ap.add_argument("--results-dir", default="results",
                    help="trial records land under <dir>/<run-id>/ and "
                         "append to <dir>/history.jsonl tagged 'tune' "
                         "(default: results)")
    ap.add_argument("--run-id", default=None,
                    help="run directory name (default: timestamp)")
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="where the trials run, as run's --device (default "
                         "cuda; the command exits 2 when no CUDA device "
                         "is present)")
    ap.add_argument("--enable-scope", action="append", default=None,
                    help="enable ONLY these scopes (repeatable)")
    ap.add_argument("--disable-scope", action="append", default=[])
    ap.add_argument("--output", default=None, metavar="PATH",
                    help="write the tuned artifact here instead of "
                         "src/repro_torch/kernels/<kernel>/tuned.json "
                         "(or $REPRO_TUNED_DIR/<kernel>/tuned.json)")
    ap.add_argument("--no-artifact", action="store_true",
                    help="search + record, but do not write tuned.json")
    ap.add_argument("--no-report", action="store_true",
                    help="skip rendering the tune report")
    return ap


def _trial_metrics(doc: Dict[str, Any]) -> Dict[str, float]:
    """Mean metrics of one trial document; raises :class:`TrialError`
    when the instance errored (the trial still consumed budget)."""
    recs = doc.get("benchmarks", [])
    bad = [r for r in recs if r.get("error_occurred") or r.get("skipped")]
    if bad:
        raise TrialError(bad[0].get("error_message", "instance errored"))
    reals: List[float] = []
    cpus: List[float] = []
    for r in recs:
        if r.get("run_type") != "iteration":
            continue
        scale = TIME_UNITS.get(r.get("time_unit", "ns"), 1e9)
        if r.get("real_time") is not None:
            reals.append(r["real_time"] / scale)
        if r.get("cpu_time") is not None:
            cpus.append(r["cpu_time"] / scale)
    if not reals:
        raise TrialError("trial produced no iteration records")
    metrics = {"real_time_s": statistics.fmean(reals)}
    if cpus:
        metrics["cpu_time_s"] = statistics.fmean(cpus)
    for counters in doc_counters(doc).values():
        for k, v in counters.items():
            metrics.setdefault(k, v)
            # derive rates so flops_per_second is an objective/Pareto
            # axis even though meters record raw per-call counters
            if not k.endswith("_per_second") and metrics["real_time_s"] > 0:
                metrics.setdefault(f"{k}_per_second",
                                   v / metrics["real_time_s"])
    return metrics


def _rename_records(doc: Dict[str, Any], new_name: str) -> None:
    """Rebrand a trial doc's records as ``tune/...`` names (aggregate
    suffixes like ``_mean`` are preserved)."""
    for rec in doc.get("benchmarks", []):
        old = rec.get("run_name") or rec.get("name", "")
        name = rec.get("name", old)
        suffix = name[len(old):] if old and name.startswith(old) else ""
        rec["run_name"] = new_name
        rec["name"] = new_name + suffix


def _print_tunables() -> None:
    rows = [(b.name, b.tunable) for b in REGISTRY.all()
            if b.tunable is not None]
    if not rows:
        print("no registered family declares a tunable kernel "
              "(Benchmark.set_tunable)")
        return
    width = max(len(n) for n, _ in rows)
    for name, t in sorted(rows):
        inst = ",".join(f"{k}={v}" for k, v in t.instance) or "-"
        print(f"{name:<{width}}  kernel={t.kernel}  "
              f"space={'x'.join(t.space.axes())} ({len(t.space)} configs)  "
              f"instance={inst}")


def tune_main(argv: List[str],
              scope_modules: Optional[List[str]] = None) -> int:
    ap = build_tune_parser()
    if any(a in ("-h", "--help") for a in argv):
        print(ap.format_help())
        return 0
    ns, rest = ap.parse_known_args(argv)

    try:
        param_filter = parse_param_filter(ns.param)
    except ValueError as e:
        log.error("%s", e)
        return 2
    meters: List[Any] = list(DEFAULT_TUNE_METERS)
    if ns.meters:
        try:
            meters = parse_meters(ns.meters)
        except ValueError as e:
            log.error("%s", e)
            return 2

    # --device is the core flag; parsed here so that its value is never
    # taken for the family
    if ns.device:
        rest = [*rest, f"--device={ns.device}"]
    from .main import _setup_scopes
    mgr, rc = _setup_scopes(scope_modules, ns.enable_scope,
                            ns.disable_scope, rest)
    if mgr is None:
        return rc
    mgr.register_all()

    if ns.list:
        _print_tunables()
        return 0
    if not ns.family:
        log.error("tune needs a family to search (or --list)")
        _print_tunables()
        return 2

    bench = next((b for b in REGISTRY.all() if b.name == ns.family), None)
    if bench is None:
        log.error("no benchmark family named %r", ns.family)
        _print_tunables()
        return 1
    if bench.tunable is None:
        log.error("family %r declares no tunable kernel space "
                  "(Benchmark.set_tunable)", ns.family)
        _print_tunables()
        return 1
    tun = bench.tunable

    from repro_torch.kernels import tuning
    if tun.kernel not in tuning.KERNEL_KNOBS:
        log.error("family %r names unknown kernel %r (known: %s)",
                  ns.family, tun.kernel, ", ".join(tuning.KERNEL_KNOBS))
        return 1
    axes = tun.space.axes()
    bad = [a for a in axes if a not in tuning.KERNEL_KNOBS[tun.kernel]]
    if bad:
        log.error("family %r: axes %s are not %s knobs (knobs: %s)",
                  ns.family, ", ".join(bad), tun.kernel,
                  ", ".join(tuning.KERNEL_KNOBS[tun.kernel]))
        return 1

    device = FLAGS.get("device")
    if device == "cuda":
        import torch
        if not torch.cuda.is_available():
            log.error("no CUDA device is available: the trials run on the "
                      "card; pass --device cpu to tune on the CPU")
            return 2

    # pick the instance the trials drive: the family's declared filter,
    # narrowed by --param
    filt: Dict[str, List[str]] = dict(tun.instance_filter() or {})
    for k, v in (param_filter or {}).items():
        filt[k] = v
    instance_name = None
    for name, params in bench.instances():
        if match_params(params, filt or None):
            instance_name = name
            break
    if instance_name is None:
        log.error("no instance of %r matches %s", ns.family,
                  {k: v[0] if len(v) == 1 else v for k, v in filt.items()})
        return 1

    from .orchestrate import default_run_id
    run_id = ns.run_id or default_run_id()
    opts = RunOptions(min_time=FLAGS.get("benchmark_min_time", 0.05),
                      repetitions=FLAGS.get("benchmark_repetitions", 1),
                      meters=meters, device=device)
    context_extra = {"run_id": run_id,
                     "tune": {"kernel": tun.kernel, "family": bench.name}}

    def trial_name(cfg: Mapping[str, Any]) -> str:
        return f"tune/{tun.kernel}/" + "/".join(
            f"{a}:{format_value(cfg[a])}" for a in axes if a in cfg)

    # the builtin run: which variant and device the instance reaches,
    # and its builtin tile there (not a trial)
    tuning.last_resolved.pop(tun.kernel, None)
    with tuning.builtins():
        probe = run_single_instance([bench], instance_name, opts,
                                    context_extra=context_extra)
    seen = tuning.last_resolved.get(tun.kernel)
    if seen is None:
        errs = [r.get("error_message") for r in probe["benchmarks"]
                if r.get("error_occurred")]
        log.error("instance %s called no %s kernel%s", instance_name,
                  tun.kernel, f" ({errs[0]})" if errs else "")
        return 1
    device_name, variant, resolved = seen
    base_cfg = {a: int(resolved[a]) for a in axes}
    log.info("tuning %s's %s variant on %s (builtin %s)", tun.kernel,
             variant, device_name, base_cfg)

    trial_docs: List[Dict[str, Any]] = []

    def measure(cfg: Mapping[str, Any]) -> Dict[str, float]:
        config = {k: int(v) for k, v in cfg.items()}
        name = trial_name(cfg)
        log.info("trial %s", name)
        with tuning.override(tun.kernel, config, variant=variant):
            doc = run_single_instance([bench], instance_name, opts,
                                      context_extra=context_extra)
        _rename_records(doc, name)
        trial_docs.append(doc)
        return _trial_metrics(doc)

    hint_fn = None
    if ns.costs:
        hints: Dict[str, float] = {}
        try:
            hints = load_cost_hints(ns.costs)
        except (OSError, json.JSONDecodeError) as e:
            log.warning("cost source %s unreadable (%s); searching "
                        "without hints", ns.costs, e)
        if hints:
            hint_fn = lambda p: hints.get(trial_name(p))  # noqa: E731

    # the builtin-default config anchors the before/after speedup.  In
    # space it joins the search (one budgeted, reusable trial); outside
    # it is measured separately, budget-exempt.
    base_in_space = any(p.canonical() == Params(base_cfg).canonical()
                        for p in tun.space.points())
    baseline_info: Optional[Dict[str, Any]] = None
    if not base_in_space:
        try:
            baseline_info = {"params": dict(base_cfg),
                             "metrics": measure(base_cfg)}
        except TrialError as e:
            log.warning("baseline config %s failed: %s", base_cfg, e)
            baseline_info = {"params": dict(base_cfg), "error": str(e)}

    result: SearchResult = run_search(
        tun.space, measure, objective=ns.objective, strategy=ns.strategy,
        budget=ns.budget, seed=ns.seed, cost_hint=hint_fn,
        baseline=Params(base_cfg) if base_in_space else None)
    if result.baseline is not None and result.baseline.ok:
        baseline_info = {"params": dict(result.baseline.params),
                         "metrics": dict(result.baseline.metrics)}

    if result.best is None:
        log.error("no trial produced objective %r — check --objective "
                  "and --meters (trials recorded under %s)",
                  ns.objective, os.path.join(ns.results_dir, run_id))
        best_cfg = None
    else:
        best_cfg = {k: int(v) for k, v in result.best.params.items()}

    speedup = None
    if (result.best is not None and baseline_info
            and "metrics" in baseline_info
            and ns.objective in baseline_info["metrics"]
            and ns.objective in result.best.metrics):
        b = baseline_info["metrics"][ns.objective]
        w = result.best.metrics[ns.objective]
        if b > 0 and w > 0:
            speedup = b / w if lower_is_better(ns.objective) else w / b

    # ---- persist: merged trial doc + history (tagged) + summary ----
    run_dir = os.path.join(ns.results_dir, run_id)
    os.makedirs(run_dir, exist_ok=True)
    merged = {
        "context": trial_docs[0]["context"] if trial_docs else {},
        "benchmarks": [r for d in trial_docs for r in d["benchmarks"]],
    }
    merged_path = os.path.join(run_dir, "merged.json")
    write_json(merged, merged_path)
    appended = append_run(ns.results_dir, merged, run_id=run_id,
                          tag="tune")
    summary = {
        "family": bench.name, "instance": instance_name,
        "kernel": tun.kernel, "axes": axes, "run_id": run_id,
        "objective": ns.objective, "baseline": baseline_info,
        "best": None if result.best is None else {
            "params": best_cfg, "metrics": dict(result.best.metrics)},
        "speedup": speedup,
        "search": result.to_json(),
    }
    with open(os.path.join(run_dir, "tune.json"), "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
        f.write("\n")
    log.info("recorded %d trial(s) under %s (%d history record(s))",
             len(trial_docs), run_dir, len(appended))

    if result.best is None:
        return 1

    artifact_path = None
    if not ns.no_artifact:
        payload = {
            "kernel": tun.kernel, "variant": variant, "device": device_name,
            "config": best_cfg,
            "objective": ns.objective, "strategy": ns.strategy,
            "budget": ns.budget, "seed": ns.seed,
            "source": {"family": bench.name, "instance": instance_name,
                       "run_id": run_id},
        }
        artifact_path = tuning.write_tuned(
            tun.kernel, payload, device=device_name, variant=variant,
            path=ns.output)

    report_path = None
    if not ns.no_report:
        from ..scopeplot.report import generate_tune_report
        try:
            report_path = generate_tune_report(run_dir)["html"]
        except Exception as e:  # noqa: BLE001 - a report must not lose the tune
            log.warning("tune report failed: %s", e)

    # ---- human summary ------------------------------------------------
    def _fmt(v: float) -> str:
        return f"{v:.3e}" if abs(v) < 1e-3 or abs(v) >= 1e4 else f"{v:.4f}"

    cfg_str = ", ".join(f"{k}={v}" for k, v in best_cfg.items())
    print(f"tuned {tun.kernel} ({variant} on {device_name}) via "
          f"{instance_name}: best {ns.objective} "
          f"= {_fmt(result.best.metrics[ns.objective])} at {cfg_str} "
          f"({len(result.trials)}/{ns.budget} trials, "
          f"strategy {ns.strategy}, seed {ns.seed})")
    if speedup is not None:
        base_str = ", ".join(f"{k}={v}" for k, v in
                             baseline_info["params"].items())
        print(f"  speedup vs builtin default ({base_str}): "
              f"{speedup:.2f}x")
    for axis, span in result.sensitivity:
        print(f"  sensitivity {axis}: {span:.3e}")
    if artifact_path:
        print(f"  artifact: {artifact_path}")
    if report_path:
        print(f"  report:   {report_path}")
    return 0


if __name__ == "__main__":
    sys.exit(tune_main(sys.argv[1:]))
