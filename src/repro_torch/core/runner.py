"""Benchmark runner + Google-Benchmark-compatible JSON writer.

The torch port of ``repro.core.runner`` (paper Fig. 2(d)):

  * fixture phase — a family's ``setup(params) -> ctx`` runs once per
    instance, *untimed*, before anything is measured;
  * warm phase — the first call of the body is measured separately and
    emitted as ``compile_time_s`` per instance.  On the card that first
    call is where a hand-written kernel is built (``nvcc``, once per
    source hash) and loaded, and where CUDA and cuBLAS initialise;
  * adaptive iteration counts calibrated on post-warm batches, timed
    repetitions and mean/median/stddev aggregates, all measured through
    a :class:`~repro_torch.core.measure.MeterStack`;
  * results serialized in the Google Benchmark JSON schema with the
    reference's record keys, so ``python -m repro compare`` reads them.

A failing instance becomes an error record and the run goes on (the
reference's crash isolation); a caller that needs every instance to
succeed checks ``error_occurred`` on the records.
"""
from __future__ import annotations

import json
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .benchmark import (Benchmark, Params, State, TIME_UNITS, match_params)
from .logging import get_logger
from .measure import CPU_TIME, MeterStack, WALL_TIME
from .sysinfo import build_context

log = get_logger("runner")

#: Canonical GB record keys — counters may not shadow these (a counter
#: named ``real_time`` would silently overwrite the measurement).
RESERVED_RECORD_KEYS = frozenset({
    "name", "run_name", "run_type", "repetitions", "repetition_index",
    "threads", "iterations", "real_time", "cpu_time", "time_unit",
    "aggregate_name", "bytes_per_second", "items_per_second", "label",
    "error_occurred", "error_message", "skipped", "skip_message",
    "compile_time_s",
})


@dataclass
class RunOptions:
    min_time: float = 0.05          # seconds of measured time per instance
    repetitions: int = 1
    max_iterations: int = 1 << 22   # safety valve
    report_aggregates_only: bool = False
    # --param key=value selection: axis name → accepted string values
    param_filter: Optional[Dict[str, List[str]]] = None
    # --meters selection: measure.METERS names driven around every batch
    # (None → measure.DEFAULT_METERS); a family's set_meters() wins.
    # Plain strings so the options survive the JSON round-trip to
    # subprocess workers at both shard grains.
    meters: Optional[List[str]] = None
    # --slo-ms: latency objective the latency meter judges goodput
    # against (milliseconds; None → every completed request is good)
    slo_ms: Optional[float] = None
    # --device: where the scopes run; the context block describes it
    device: str = "cuda"


@dataclass
class RunRecord:
    """One row of the ``benchmarks`` array in the output JSON."""
    name: str
    run_name: str
    run_type: str                  # "iteration" | "aggregate"
    iterations: int
    real_time: float               # in time_unit
    cpu_time: float
    time_unit: str
    repetitions: int = 1
    repetition_index: int = 0
    threads: int = 1
    aggregate_name: Optional[str] = None
    bytes_per_second: Optional[float] = None
    items_per_second: Optional[float] = None
    label: Optional[str] = None
    error_occurred: bool = False
    error_message: Optional[str] = None
    skipped: bool = False
    skip_message: Optional[str] = None
    compile_time_s: Optional[float] = None   # warm-phase first-call time
    counters: Dict[str, float] = field(default_factory=dict)

    def to_json(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "run_name": self.run_name,
            "run_type": self.run_type,
            "repetitions": self.repetitions,
            "repetition_index": self.repetition_index,
            "threads": self.threads,
            "iterations": self.iterations,
            "real_time": self.real_time,
            "cpu_time": self.cpu_time,
            "time_unit": self.time_unit,
        }
        if self.aggregate_name:
            d["aggregate_name"] = self.aggregate_name
        if self.bytes_per_second is not None:
            d["bytes_per_second"] = self.bytes_per_second
        if self.items_per_second is not None:
            d["items_per_second"] = self.items_per_second
        if self.label:
            d["label"] = self.label
        if self.error_occurred:
            d["error_occurred"] = True
            d["error_message"] = self.error_message
        if self.skipped:
            d["skipped"] = True
            d["skip_message"] = self.skip_message
        if self.compile_time_s is not None:
            d["compile_time_s"] = self.compile_time_s
        # GB inlines counters at top level; a counter shadowing a
        # canonical key is renamed, never allowed to overwrite it
        for key, value in self.counters.items():
            if key in RESERVED_RECORD_KEYS:
                log.warning("benchmark %s: counter %r shadows a canonical "
                            "record key; renamed to %r", self.name, key,
                            f"counter_{key}")
                key = f"counter_{key}"
            d[key] = value
        return d


def _as_params(bench: Benchmark, point) -> Params:
    """Normalize a caller-supplied instance point to Params (accepts a
    legacy int tuple for back-compat)."""
    if isinstance(point, Params):
        return point
    return bench._legacy_params(tuple(point))


def _run_batch(bench: Benchmark, params: Params, n: int,
               fixture: Any, stack: MeterStack
               ) -> Tuple[State, Dict[str, float]]:
    """One measured batch: the meter stack brackets the body."""
    state = State(max_iterations=n, params=params, fixture=fixture)
    stack.begin(state)
    bench.fn(state)
    return state, stack.end(state)


def run_instance(bench: Benchmark, point, opts: RunOptions
                 ) -> List[RunRecord]:
    """Run one (family × params) instance: fixture, warm, calibrate,
    repeat, aggregate.  Every batch is measured through the instance's
    :class:`~repro_torch.core.measure.MeterStack` (family ``set_meters``
    override, else ``opts.meters``, else the default wall+cpu set)."""
    params = _as_params(bench, point)
    name = bench.instance_name(params if bench.space is not None
                               else tuple(params.values()))
    min_time = bench.min_time if bench.min_time is not None else opts.min_time
    reps = bench.repetitions if bench.repetitions is not None else opts.repetitions
    unit_scale = TIME_UNITS[bench.unit]
    stack = MeterStack.build(bench.meters if bench.meters is not None
                             else opts.meters, bench, run_opts=opts)

    # -- fixture: setup(params) -> ctx, untimed --------------------------
    fixture = None
    if bench.fixture is not None:
        try:
            fixture = bench.fixture(params)
        except Exception as e:  # noqa: BLE001 - isolate fixture failures
            st = State(params=params)
            st.skip_with_error(f"fixture failed: {e!r}")
            return [_error_record(bench, name, st, reps)]

    # -- meter prepare: one-time analysis, before anything is timed ----
    stack.prepare(State(params=params, fixture=fixture))

    # -- warm phase: first call measured separately ----------------------
    # The first call builds and loads a hand-written kernel and
    # initialises CUDA/cuBLAS; its wall time is the compile_time_s
    # record.  The warm batch never feeds calibration.  Whole-batch wall
    # (not the meter's loop window) so set-up work outside the timed loop
    # still counts, with the meter's fence guaranteeing the launched work
    # finished before the clock stops.
    t0 = time.perf_counter()
    warm, _ = _run_batch(bench, params, 1, fixture, stack)
    compile_s = time.perf_counter() - t0
    if warm.error_occurred or warm.skipped:
        return [_error_record(bench, name, warm, reps)]

    # -- calibration: grow n until measured time >= min_time -----------
    if bench.iterations is not None:
        n = bench.iterations
    else:
        n = 1
        while True:
            cal, cal_metrics = _run_batch(bench, params, n, fixture, stack)
            if cal.error_occurred or cal.skipped:
                return [_error_record(bench, name, cal, reps)]
            t = cal_metrics.get(WALL_TIME, 0.0)
            if t >= min_time or n >= opts.max_iterations:
                break
            if t <= 0:
                n = min(n * 10, opts.max_iterations)
            else:
                # GB's multiplier: overshoot slightly to converge fast
                mult = min(10.0, max(2.0, 1.4 * min_time / t))
                n = min(int(math.ceil(n * mult)), opts.max_iterations)

    # -- timed repetitions ------------------------------------------------
    records: List[RunRecord] = []
    per_iter_times: List[float] = []
    rep_values: Dict[str, List[float]] = {}   # per-rep series → aggregates

    def _track(key: str, value: Optional[float]) -> None:
        if value is not None:
            rep_values.setdefault(key, []).append(value)

    for rep in range(reps):
        st, metrics = _run_batch(bench, params, n, fixture, stack)
        if st.error_occurred or st.skipped:
            records.append(_error_record(bench, name, st, reps, rep))
            continue
        total = metrics.get(WALL_TIME, 0.0)
        iters = max(st.iterations, 1)
        per_iter = total / iters
        per_iter_times.append(per_iter)
        # cpu_time: a real measurement when the CPU meter ran; bodies
        # without one fall back to wall (the pre-meter behaviour)
        cpu_per_iter = metrics[CPU_TIME] / iters if CPU_TIME in metrics \
            else per_iter
        _track("cpu_time", cpu_per_iter)
        # meter metrics beyond the canonical times land as counters;
        # the body's own counters win on a name collision
        counters = {k: v for k, v in metrics.items()
                    if k not in (WALL_TIME, CPU_TIME)}
        counters.update(st.counters)
        for key, value in counters.items():
            _track(key, value)
        rec = RunRecord(
            name=name, run_name=name, run_type="iteration",
            iterations=st.iterations,
            real_time=per_iter * unit_scale,
            cpu_time=cpu_per_iter * unit_scale,
            time_unit=bench.unit,
            repetitions=reps, repetition_index=rep,
            label=st.label or None,
            compile_time_s=compile_s,
            counters=counters,
        )
        if st.bytes_processed:
            rec.bytes_per_second = st.bytes_processed * st.iterations / total
            _track("bytes_per_second", rec.bytes_per_second)
        if st.items_processed:
            rec.items_per_second = st.items_processed * st.iterations / total
            _track("items_per_second", rec.items_per_second)
        records.append(rec)

    # -- aggregates ---------------------------------------------------
    # Each aggregate applies its statistic uniformly: to the times, to
    # cpu_time, to the throughput rates, and to every counter present
    # in all repetitions — so --report-aggregates-only keeps the full
    # measurement surface, not just the wall clock.
    if reps > 1 and len(per_iter_times) > 1:
        aggs = {
            "mean": statistics.fmean,
            "median": statistics.median,
            "stddev": statistics.stdev,
        }
        full_series = {k: v for k, v in rep_values.items()
                       if len(v) == len(per_iter_times)}
        for agg_name, agg_fn in aggs.items():
            cpu_series = full_series.get("cpu_time")
            rec = RunRecord(
                name=f"{name}_{agg_name}", run_name=name,
                run_type="aggregate", aggregate_name=agg_name,
                iterations=n,
                real_time=agg_fn(per_iter_times) * unit_scale,
                cpu_time=(agg_fn(cpu_series) if cpu_series
                          else agg_fn(per_iter_times)) * unit_scale,
                # the count the statistics are over: errored repetitions
                # contribute no sample, and consumers reconstructing n
                # from an aggregates-only document must not over-trust
                # a stddev backed by fewer samples than requested
                time_unit=bench.unit, repetitions=len(per_iter_times),
                compile_time_s=compile_s if agg_name != "stddev" else None,
                counters={k: agg_fn(v) for k, v in full_series.items()
                          if k not in ("cpu_time", "bytes_per_second",
                                       "items_per_second")},
            )
            bps = full_series.get("bytes_per_second")
            ips = full_series.get("items_per_second")
            if bps:
                rec.bytes_per_second = agg_fn(bps)
            if ips:
                rec.items_per_second = agg_fn(ips)
            records.append(rec)
        if opts.report_aggregates_only:
            records = [r for r in records if r.run_type == "aggregate"]
    return records


def _error_record(bench: Benchmark, name: str, st: State, reps: int,
                  rep: int = 0) -> RunRecord:
    return RunRecord(
        name=name, run_name=name, run_type="iteration",
        iterations=st.iterations, real_time=0.0, cpu_time=0.0,
        time_unit=bench.unit, repetitions=reps, repetition_index=rep,
        error_occurred=st.error_occurred, error_message=st.error_message or None,
        skipped=st.skipped, skip_message=st.skip_message or None,
    )


def run_single_instance(benches: Sequence[Benchmark], instance_name: str,
                        opts: Optional[RunOptions] = None,
                        context_extra: Optional[Dict[str, Any]] = None
                        ) -> Dict[str, Any]:
    """Run exactly one *named* instance; return a full GB-JSON document.

    The benchmark-grained orchestrator's unit of work
    (:mod:`repro_torch.core.plan`): ``instance_name`` is a display name
    (``scope/family/axis:value/...``), matched against every instance of
    ``benches``.  Crashes degrade to an error record, like
    :func:`run_benchmarks`; an unknown name raises ``KeyError`` so the
    caller can tell "no such instance" apart from "instance failed".
    """
    opts = opts or RunOptions()
    for bench in benches:
        for name, params in bench.instances():
            if name != instance_name:
                continue
            try:
                records = run_instance(bench, params, opts)
            except Exception as e:  # noqa: BLE001 - isolate benchmark crashes
                log.error("benchmark %s crashed: %s", name, e)
                st = State()
                st.skip_with_error(f"crashed: {e}")
                records = [_error_record(bench, name, st, 1)]
            return {
                "context": build_context(context_extra, device=opts.device),
                "benchmarks": [r.to_json() for r in records],
            }
    raise KeyError(f"no benchmark instance named {instance_name!r}")


def run_benchmarks(benches: Sequence[Benchmark],
                   opts: Optional[RunOptions] = None,
                   context_extra: Optional[Dict[str, Any]] = None,
                   progress: bool = True) -> Dict[str, Any]:
    """Run benchmark families; return the full GB-JSON document as a dict.

    Instances not matching ``opts.param_filter`` (the ``--param``
    selection) are skipped without a record — selection, not failure.
    """
    opts = opts or RunOptions()
    all_records: List[RunRecord] = []
    t0 = time.perf_counter()
    for bench in benches:
        for name, params in bench.instances():
            if not match_params(params, opts.param_filter):
                continue
            if progress:
                log.info("running %s", name)
            try:
                all_records.extend(run_instance(bench, params, opts))
            except Exception as e:  # noqa: BLE001 - isolate benchmark crashes
                log.error("benchmark %s crashed: %s", name, e)
                st = State()
                st.skip_with_error(f"crashed: {e}")
                all_records.append(_error_record(bench, name, st, 1))
    elapsed = time.perf_counter() - t0
    log.info("ran %d records in %.2fs", len(all_records), elapsed)
    return {
        "context": build_context(context_extra, device=opts.device),
        "benchmarks": [r.to_json() for r in all_records],
    }


def write_json(doc: Dict[str, Any], path_or_file) -> None:
    if hasattr(path_or_file, "write"):
        json.dump(doc, path_or_file, indent=2)
    else:
        with open(path_or_file, "w") as f:
            json.dump(doc, f, indent=2)
