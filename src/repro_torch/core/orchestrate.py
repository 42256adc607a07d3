"""Run-orchestration subsystem — plan → schedule → shard → merge.

The torch port of ``repro.core.orchestrate``: the run stage of the
SCOPE binary (paper Fig. 2(d)) as an orchestrator instead of a
sequential loop.  Execution is planned at one of two granularities
(``--shard-grain``):

  * **benchmark** (default when ``--jobs > 1`` or resuming) — the
    work-plan layer (:mod:`repro_torch.core.plan`) enumerates the
    registry into addressable benchmark *instances*; items are binned
    across workers with greedy longest-processing-time using cost hints
    from a prior run, each completed instance is streamed to
    ``results/<run-id>/shards/<id>.json``, and ``manifest.json`` records
    plan → shard status.  An interrupted run resumes with ``--resume
    <run-id>`` (completed instances are skipped), and a crashed instance
    degrades only itself — the rest of its scope still reports;
  * **scope** (the paper's granularity, default when ``--jobs 1``) — each
    enabled scope is one schedulable unit yielding one shard under
    ``results/<run-id>/<scope>.json``.

Shared machinery at both grains:

  * **parallelism** — work runs in fresh interpreters (``--jobs N``):
    standalone ``python -m repro_torch.core.orchestrate`` subprocesses,
    or a ``spawn``-context process pool at scope grain.  A process that
    has initialised CUDA is never forked.  Each worker holds its own
    registry, flags and CUDA context;
  * **the card** — the full :class:`~repro_torch.core.runner.RunOptions`
    (``device`` and the ``--meters`` selection included) travels to
    every worker as JSON, so a worker measures exactly what an inline
    run would.  A worker sent ``device=cuda`` that finds no card fails
    its instances with error records; it never measures on the CPU.
    Before it starts workers for a ``cuda`` run, the parent builds every
    kernel library once (``nvcc`` needs no CUDA context), so the workers
    load them instead of each paying ``nvcc``.  With ``--jobs > 1`` the
    workers share the card and their times contend, as the reference's
    workers share one host; ``--jobs 1`` (the default) measures alone;
  * **failure isolation** — a unit that *errors* produces an error shard;
    a unit that *kills its interpreter* (segfault, ``os._exit``) is
    retried in a standalone subprocess (scope grain) or narrowed down to
    the single poisonous instance (benchmark grain) and degraded to an
    error record;
  * **merged document** — shards are merged in plan order into one
    schema-identical GB-JSON document (``merged.json``), so ``--jobs``,
    ``--shard-grain``, and ``--resume`` never change the merged output's
    benchmark names, order, or schema.  Provenance lives inside
    ``context["run_id"]``, ``context["shards"]`` (and
    ``context["instances"]`` at benchmark grain); the context describes
    the run's device, so a ``cuda`` run's document says ``backend:
    cuda`` and names the card;
  * **baseline diffing** — the merged document is what
    :mod:`repro_torch.core.baseline` stores and compares (``python -m
    repro_torch compare A.json B.json``);
  * **run history** — a persisted run appends one record per benchmark
    instance to ``<results-dir>/history.jsonl`` at merge time
    (:mod:`repro_torch.core.history`), which ``--baseline
    results/history.jsonl`` gates against;
  * **delta runs** — ``--since`` and ``python -m repro_torch ci`` hand
    the orchestrator the fingerprint-fresh instances
    (:mod:`repro_torch.core.fingerprint`) as ``cached_results``: each is
    replayed from its latest history record as a ``cached: true``
    record instead of executed, so the merged document stays complete.
"""
from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor, as_completed
from concurrent.futures.process import BrokenProcessPool
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .history import append_run
from .logging import get_logger
from .plan import Plan, PlanItem, build_plan, load_cost_hints, scope_worklist
from .runner import (RunOptions, run_benchmarks, run_single_instance,
                     write_json)
from .sysinfo import build_context

log = get_logger("orchestrate")

# Shard status values.
OK = "ok"            # unit ran; doc holds its records (may include errors)
ERROR = "error"      # unit failed to import/register/run; no usable records
CRASHED = "crashed"  # unit killed its interpreter(s); no records
PENDING = "pending"  # planned but not yet executed (manifest only)
PARTIAL = "partial"  # scope rollup: some instances ok, some not

EXTERNAL = "<external>"   # module marker for add_scope()-registered scopes

#: The module every worker interpreter runs (``python -m``).
WORKER_MODULE = "repro_torch.core.orchestrate"


def _spawn_safe_main() -> bool:
    main = sys.modules.get("__main__")
    if getattr(main, "__spec__", None) is not None:   # python -m …
        return True
    path = getattr(main, "__file__", None)
    return bool(path and os.path.exists(path))


def _device_error(run_opts: RunOptions) -> str:
    """Why a worker cannot run ``run_opts`` here: a run sent to the card
    that finds no CUDA device fails its instances with error records
    rather than measure on the CPU.  Empty when it can run."""
    if run_opts.device != "cuda":
        return ""
    import torch
    if torch.cuda.is_available():
        return ""
    return "no CUDA device is available in the worker (run sent to cuda)"


def _build_kernels(run_opts: RunOptions) -> None:
    """Build every kernel library once in the parent before workers
    start on the card: each worker then loads the libraries instead of
    running ``nvcc`` itself (concurrent builds are correct but pay the
    compiler once a worker).  ``nvcc`` needs no CUDA context.  A failed
    build is logged; each worker then reports it on its instances."""
    if run_opts.device != "cuda":
        return
    from ..kernels import _build
    t0 = time.perf_counter()
    try:
        _build.build(_build.kernel_names())
    except RuntimeError as e:
        log.error("kernel build before the workers failed: %s", e)
        return
    log.info("kernel libraries ready for the workers (%.2fs)",
             time.perf_counter() - t0)


@dataclass
class OrchestratorOptions:
    """How to schedule the enabled scopes' benchmarks."""

    jobs: int = 1                   # worker parallelism (1 → inline)
    isolate: str = "auto"           # auto | inline | pool | subprocess
    shard_grain: str = "auto"       # auto | benchmark | scope
    benchmark_filter: str = ".*"
    run: RunOptions = field(default_factory=RunOptions)
    # parsed flag values forwarded to workers (scopes read global FLAGS)
    flag_values: Dict[str, Any] = field(default_factory=dict)
    results_dir: Optional[str] = None   # persist shards+merged when set
    run_id: Optional[str] = None        # defaults to a timestamp
    resume: bool = False                # re-open results_dir/run_id; skip
    #                                     instances whose shard is complete
    cost_source: Optional[str] = None   # prior run dir / GB doc → cost hints
    subprocess_timeout: float = 1800.0
    # delta runs (--since / repro_torch ci): instance_id → latest history
    # record vouching for a fingerprint-fresh instance; those instances
    # are materialized as cached results instead of executed
    cached_results: Optional[Dict[str, Dict[str, Any]]] = None
    history_tag: Optional[str] = None   # tag for appended history records

    def grain(self) -> str:
        if self.shard_grain != "auto":
            return self.shard_grain
        # resuming/delta-skipping only makes sense at instance grain
        return "benchmark" if self.jobs > 1 or self.resume \
            or self.cached_results is not None else "scope"

    def mode(self) -> str:
        if self.isolate != "auto":
            return self.isolate
        if self.jobs <= 1:
            return "inline"
        # spawn re-executes __main__; a parent without a real main module
        # (stdin, embedded interpreter) would break every pool worker at
        # startup, so fall straight to standalone subprocesses there.
        return "pool" if _spawn_safe_main() else "subprocess"


@dataclass
class ScopeShard:
    """One scope's contribution to a run."""

    scope: str
    module: str
    status: str = OK
    doc: Optional[Dict[str, Any]] = None   # GB-JSON document when status==OK
    error: str = ""
    duration_s: float = 0.0

    def meta(self) -> Dict[str, Any]:
        m: Dict[str, Any] = {"scope": self.scope, "module": self.module,
                             "status": self.status,
                             "duration_s": round(self.duration_s, 6)}
        if self.error:
            m["error"] = self.error
        return m


@dataclass
class InstanceResult:
    """One benchmark instance's contribution to a plan-grained run."""

    item: PlanItem
    status: str = PENDING
    doc: Optional[Dict[str, Any]] = None   # GB-JSON doc for this instance
    error: str = ""
    duration_s: float = 0.0
    started: Optional[float] = None        # epoch seconds (manifest proof
    finished: Optional[float] = None       #  that --resume didn't re-run)
    cached: bool = False                   # satisfied from a previous run

    def meta(self) -> Dict[str, Any]:
        m = {**self.item.meta(), "status": self.status,
             "shard": f"shards/{self.item.instance_id}.json",
             "duration_s": round(self.duration_s, 6),
             "started": self.started, "finished": self.finished}
        if self.error:
            m["error"] = self.error[-2000:]
        if self.cached:
            m["cached"] = True
        return m


@dataclass
class RunResult:
    """Merged document + per-scope shards, as returned by :func:`execute`.

    Plan-grained runs additionally expose the plan and the per-instance
    results (``instances``); per-scope shards are then rollups so
    scope-grained consumers keep working unchanged.
    """

    doc: Dict[str, Any]
    shards: List[ScopeShard]
    run_id: str
    out_dir: Optional[str] = None
    plan: Optional[Plan] = None
    instances: List[InstanceResult] = field(default_factory=list)

    def shard(self, scope: str) -> Optional[ScopeShard]:
        for s in self.shards:
            if s.scope == scope:
                return s
        return None

    def instance(self, name: str) -> Optional[InstanceResult]:
        for r in self.instances:
            if r.item.name == name or r.item.instance_id == name:
                return r
        return None


# ---------------------------------------------------------------------------
# scope-grain worker (runs in a fresh interpreter under pool/subprocess)
# ---------------------------------------------------------------------------

def run_one_scope(module: str, run_opts: RunOptions, benchmark_filter: str,
                  flag_values: Optional[Dict[str, Any]] = None
                  ) -> Dict[str, Any]:
    """Load ONE scope module and run its benchmarks; return the GB-JSON doc.

    Top-level (picklable) so it can be dispatched to a spawn-context
    process pool.  Uses the process-global registry/flags/hooks because
    scope bodies read them (e.g. ``FLAGS.get("example/greet")``) — under
    pool/subprocess isolation the process is fresh, so this *is* a clean
    slate; callers running inline should prefer :func:`execute`.
    """
    from .flags import FLAGS
    from .hooks import HOOKS
    from .registry import REGISTRY
    from .scope import ScopeManager

    device_error = _device_error(run_opts)
    if device_error:
        raise RuntimeError(device_error)
    REGISTRY.reset()
    mgr = ScopeManager()
    mgr.load([module])
    loaded = mgr.scopes()[0]
    if not loaded.available:
        raise RuntimeError(f"scope module {module} failed to import:\n"
                           f"{loaded.error}")
    for name, value in (flag_values or {}).items():
        FLAGS.set(name, value)
    rc = HOOKS.run_pre_parse()
    if rc is None:
        rc = HOOKS.run_post_parse()
    if rc is not None:
        raise RuntimeError(f"scope {loaded.scope.name} init hook requested "
                           f"exit ({rc})")
    mgr.register_all()
    if not loaded.available:
        raise RuntimeError(f"scope {loaded.scope.name} registration "
                           f"failed:\n{loaded.error}")
    benches = REGISTRY.filter(benchmark_filter,
                              scopes=[loaded.scope.name])
    return run_benchmarks(benches, run_opts,
                          context_extra={"scope": loaded.scope.name},
                          progress=False)


def _pool_worker(module: str, run_opts_dict: Dict[str, Any],
                 benchmark_filter: str, flag_values: Dict[str, Any]
                 ) -> Tuple[Dict[str, Any], float]:
    """Returns (doc, runtime) — timed in the worker, excluding queue wait."""
    t0 = time.perf_counter()
    doc = run_one_scope(module, RunOptions(**run_opts_dict),
                        benchmark_filter, flag_values)
    return doc, time.perf_counter() - t0


# ---------------------------------------------------------------------------
# scope-grain execution strategies
# ---------------------------------------------------------------------------

def _run_inline(name: str, module: str, registry, opts: OrchestratorOptions
                ) -> ScopeShard:
    """Run a scope in-process against the parent's already-built registry."""
    t0 = time.perf_counter()
    try:
        benches = registry.filter(opts.benchmark_filter, scopes=[name])
        doc = run_benchmarks(benches, opts.run,
                             context_extra={"scope": name}, progress=False)
        return ScopeShard(name, module, OK, doc,
                          duration_s=time.perf_counter() - t0)
    except Exception:  # noqa: BLE001 - isolation requirement
        return ScopeShard(name, module, ERROR,
                          error=traceback.format_exc(limit=4),
                          duration_s=time.perf_counter() - t0)


def _run_subprocess(name: str, module: str, opts: OrchestratorOptions
                    ) -> ScopeShard:
    """Run a scope in a standalone interpreter — survives hard crashes."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "shard.json")
        cmd = [sys.executable, "-m", WORKER_MODULE,
               "--worker", "--module", module, "--out", out,
               "--filter", opts.benchmark_filter,
               "--run-json", json.dumps(asdict(opts.run)),
               "--flags-json", json.dumps(opts.flag_values)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=opts.subprocess_timeout)
        except subprocess.TimeoutExpired:
            return ScopeShard(name, module, CRASHED,
                              error=f"timed out after "
                                    f"{opts.subprocess_timeout}s",
                              duration_s=time.perf_counter() - t0)
        if proc.returncode != 0 or not os.path.exists(out):
            payload = None
            if os.path.exists(out):
                try:
                    with open(out) as f:
                        payload = json.load(f)
                except (OSError, json.JSONDecodeError):
                    payload = None
            if isinstance(payload, dict) and "worker_error" in payload:
                # worker survived to report a clean Python exception —
                # an ERROR shard, same as pool/inline would produce
                return ScopeShard(name, module, ERROR,
                                  error=payload["worker_error"],
                                  duration_s=time.perf_counter() - t0)
            return ScopeShard(
                name, module, CRASHED,
                error=f"worker exited {proc.returncode}:\n"
                      f"{proc.stderr[-2000:]}",
                duration_s=time.perf_counter() - t0)
        with open(out) as f:
            doc = json.load(f)
    return ScopeShard(name, module, OK, doc,
                      duration_s=time.perf_counter() - t0)


def _run_pool(items: Sequence[Tuple[str, str]], opts: OrchestratorOptions,
              on_shard) -> List[ScopeShard]:
    """Process-pool execution with subprocess fallback on worker death.

    A worker that raises keeps the pool alive and yields an error shard.
    A worker that *dies* (segfault/``os._exit``) breaks the whole
    ProcessPoolExecutor — every unfinished scope then falls back to its
    own standalone subprocess, so one hostile scope cannot take down the
    rest of the run.
    """
    ctx = multiprocessing.get_context("spawn")
    shards: Dict[str, ScopeShard] = {}
    retry: List[Tuple[str, str]] = []
    run_dict = asdict(opts.run)
    t_submit = time.perf_counter()
    pool = ProcessPoolExecutor(max_workers=max(1, opts.jobs),
                               mp_context=ctx)
    try:
        futs = {pool.submit(_pool_worker, module, run_dict,
                            opts.benchmark_filter,
                            opts.flag_values): (name, module)
                for name, module in items}
        for fut in as_completed(futs):
            name, module = futs[fut]
            try:
                doc, dt = fut.result()
                shards[name] = ScopeShard(name, module, OK, doc,
                                          duration_s=dt)
                on_shard(shards[name])
            except BrokenProcessPool:
                retry.append((name, module))
            except Exception:  # noqa: BLE001 - worker raised, pool alive
                shards[name] = ScopeShard(
                    name, module, ERROR,
                    error=traceback.format_exc(limit=4),
                    duration_s=time.perf_counter() - t_submit)
                on_shard(shards[name])
    finally:
        pool.shutdown(wait=False, cancel_futures=True)

    if retry:
        log.warning("process pool broke; retrying %d scope(s) in "
                    "standalone subprocesses: %s",
                    len(retry), [n for n, _ in retry])
        with ThreadPoolExecutor(max_workers=max(1, opts.jobs)) as tp:
            sub_futs = {tp.submit(_run_subprocess, n, m, opts): n
                        for n, m in retry}
            for fut in as_completed(sub_futs):
                shard = fut.result()
                shards[shard.scope] = shard
                on_shard(shard)
    # preserve the submitted scope order in the output
    return [shards[name] for name, _ in items if name in shards]


# ---------------------------------------------------------------------------
# merge + persistence (shared)
# ---------------------------------------------------------------------------

def _gb_error_record(name: str, status: str, error: str) -> Dict[str, Any]:
    return {
        "name": name,
        "run_name": name,
        "run_type": "iteration",
        "repetitions": 1, "repetition_index": 0, "threads": 1,
        "iterations": 0, "real_time": 0.0, "cpu_time": 0.0,
        "time_unit": "us",
        "error_occurred": True,
        "error_message": f"[{status}] {error}".strip(),
    }


def cached_instance_result(item: PlanItem, rec: Dict[str, Any]
                           ) -> InstanceResult:
    """Materialize a delta-skipped instance from its history record.

    The merged document must stay *complete* on a sparse delta run, so
    the skipped instance contributes a schema-conforming GB record
    replaying its latest measured mean — marked ``cached: true`` (plus
    the run it echoes) so history appending, drift pooling and readers
    can tell a replay from a measurement.
    """
    gb: Dict[str, Any] = {
        "name": item.name, "run_name": item.name, "run_type": "iteration",
        "repetitions": 1, "repetition_index": 0, "threads": 1,
        "iterations": max(1, int(rec.get("n") or 1)),
        "real_time": float(rec.get("mean_s") or 0.0),
        "cpu_time": float(rec.get("mean_s") or 0.0),
        "time_unit": "s",
        "cached": True,
        "cached_from_run": rec.get("run_id", ""),
    }
    counters = rec.get("counters")
    if isinstance(counters, dict):
        for key, value in counters.items():
            if isinstance(value, (int, float)) \
                    and not isinstance(value, bool):
                gb.setdefault(key, value)
    doc = {"context": {}, "benchmarks": [gb]}
    now = time.time()
    return InstanceResult(item, OK, doc, duration_s=0.0,
                          started=now, finished=now, cached=True)


def scope_error_record(shard: ScopeShard) -> Dict[str, Any]:
    """A schema-conforming GB record marking a failed/crashed scope."""
    return _gb_error_record(f"{shard.scope}/SCOPE_FAILED", shard.status,
                            shard.error)


def instance_error_record(name: str, status: str, error: str
                          ) -> Dict[str, Any]:
    """A schema-conforming GB record for one failed/crashed instance.

    Unlike a scope failure, the record keeps the *instance's own name* —
    siblings in the same scope report normally, and baseline comparison
    attributes the failure to exactly the benchmark that died.
    """
    return _gb_error_record(name, status, error)


def merge_shards(shards: Sequence[ScopeShard],
                 context_extra: Optional[Dict[str, Any]] = None,
                 run_id: Optional[str] = None,
                 device: str = "cuda") -> Dict[str, Any]:
    """Concatenate scope shard documents into one GB-JSON document.

    Top-level schema is identical to the sequential
    :func:`~repro_torch.core.runner.run_benchmarks` output (``context`` +
    ``benchmarks``); shard provenance lives in ``context["shards"]``,
    and the context describes ``device``, where the shards ran.
    """
    ctx = build_context(context_extra, device=device)
    if run_id:
        ctx["run_id"] = run_id
    ctx["shards"] = [s.meta() for s in shards]
    benchmarks: List[Dict[str, Any]] = []
    for s in shards:
        if s.status == OK and s.doc is not None:
            benchmarks.extend(s.doc.get("benchmarks", []))
        else:
            benchmarks.append(scope_error_record(s))
    return {"context": ctx, "benchmarks": benchmarks}


def default_run_id() -> str:
    return time.strftime("%Y%m%dT%H%M%S") + f"-{os.getpid()}"


def _atomic_write_json(doc: Dict[str, Any], path: str) -> None:
    """Write-then-rename so crash-time readers never see a torn file."""
    tmp = path + ".tmp"
    write_json(doc, tmp)
    os.replace(tmp, path)


def _append_history(results_dir: str, doc: Dict[str, Any],
                    run_id: str, tag: Optional[str] = None) -> None:
    """Best-effort run-history append — never fails a finished run."""
    try:
        append_run(results_dir, doc, run_id=run_id, tag=tag)
    except Exception:  # noqa: BLE001 - history is an artifact, not a gate
        log.warning("run-history append failed for %s:\n%s", run_id,
                    traceback.format_exc(limit=2))


def _persist_shard(out_dir: str, shard: ScopeShard) -> None:
    doc = shard.doc if shard.status == OK and shard.doc is not None else {
        "context": {"scope": shard.scope, **shard.meta()},
        "benchmarks": [scope_error_record(shard)],
    }
    write_json(doc, os.path.join(out_dir, f"{shard.scope}.json"))


# ---------------------------------------------------------------------------
# plan-grain: manifest + instance shards
# ---------------------------------------------------------------------------

def manifest_path(out_dir: str) -> str:
    return os.path.join(out_dir, "manifest.json")


def read_manifest(out_dir: str) -> Dict[str, Any]:
    with open(manifest_path(out_dir)) as f:
        return json.load(f)


def write_manifest(out_dir: str, run_id: str, plan: Plan,
                   results: Dict[str, InstanceResult]) -> None:
    """Record plan → shard status, rewritten as instances complete."""
    items = []
    for item in plan.items:
        r = results.get(item.instance_id)
        if r is not None:
            items.append(r.meta())
        else:
            items.append({**item.meta(), "status": PENDING,
                          "shard": f"shards/{item.instance_id}.json"})
    _atomic_write_json({
        "run_id": run_id,
        "grain": "benchmark",
        "total": len(plan.items),
        "completed": sum(1 for r in results.values() if r.status == OK),
        "items": items,
    }, manifest_path(out_dir))


def _instance_shard_file(spool: str, item: PlanItem) -> str:
    return os.path.join(spool, f"{item.instance_id}.json")


def _write_instance_shard(spool: str, res: InstanceResult) -> None:
    doc = res.doc if res.doc is not None else {
        "context": {},
        "benchmarks": [instance_error_record(res.item.name, res.status,
                                             res.error)],
    }
    doc.setdefault("context", {})["instance"] = res.meta()
    _atomic_write_json(doc, _instance_shard_file(spool, res.item))


def _load_instance_shard(spool: str, item: PlanItem
                         ) -> Optional[InstanceResult]:
    """Read one instance's spool shard; None if absent or torn."""
    path = _instance_shard_file(spool, item)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    meta = doc.get("context", {}).get("instance", {})
    return InstanceResult(
        item=item, status=meta.get("status", OK), doc=doc,
        error=meta.get("error", ""),
        duration_s=meta.get("duration_s", 0.0),
        started=meta.get("started"), finished=meta.get("finished"))


# ---------------------------------------------------------------------------
# plan-grain: execution
# ---------------------------------------------------------------------------

def _instance_status(doc: Dict[str, Any]) -> Tuple[str, str]:
    """(status, error) from a freshly-run instance document.

    An instance whose every record errored is an ERROR result — it will
    be re-attempted by ``--resume`` — while partial/record-level errors
    (e.g. one repetition skipped) leave the instance OK, matching
    scope-grain semantics.
    """
    recs = doc.get("benchmarks", [])
    if recs and all(r.get("error_occurred") for r in recs):
        return ERROR, str(recs[0].get("error_message") or "")
    return OK, ""


def _run_instance_inline(item: PlanItem, registry,
                         opts: OrchestratorOptions) -> InstanceResult:
    """Run one plan item in-process against the parent's registry."""
    started = time.time()
    t0 = time.perf_counter()
    try:
        bench = registry.get(item.family)
        doc = run_single_instance([bench], item.name, opts.run)
        status, error = _instance_status(doc)
    except Exception:  # noqa: BLE001 - isolation requirement
        status, error = ERROR, traceback.format_exc(limit=4)
        doc = {"context": {},
               "benchmarks": [instance_error_record(item.name, status,
                                                    error)]}
    return InstanceResult(item, status, doc, error,
                          duration_s=time.perf_counter() - t0,
                          started=started, finished=time.time())


def run_plan_items(items_meta: Sequence[Dict[str, Any]],
                   run_opts: RunOptions,
                   flag_values: Optional[Dict[str, Any]],
                   spool: str) -> int:
    """Worker body: run a bin of plan items, streaming instance shards.

    Loads every scope module the bin references once (imports are the
    expensive part — torch, a CUDA context, the kernel libraries — so
    instances are batched per worker, not spawned one interpreter
    each), then executes the items in plan order,
    writing ``<spool>/<instance_id>.json`` after each.  A Python-level
    failure degrades that instance to an error shard and the worker keeps
    going; only interpreter death stops the stream — the parent then
    narrows the gap down via solo retries.
    """
    from .flags import FLAGS
    from .hooks import HOOKS
    from .registry import REGISTRY
    from .scope import ScopeManager

    REGISTRY.reset()
    mgr = ScopeManager()
    modules: List[str] = []
    for m in items_meta:
        if m["module"] not in modules:
            modules.append(m["module"])
    mgr.load(modules)
    for name, value in (flag_values or {}).items():
        FLAGS.set(name, value)
    rc = HOOKS.run_pre_parse()
    if rc is None:
        rc = HOOKS.run_post_parse()
    init_error = f"init hook requested exit ({rc})" if rc is not None \
        else _device_error(run_opts)
    if not init_error:
        mgr.register_all()
    unavailable = {s.scope.name: s.error for s in mgr.scopes()
                   if not s.available}

    for m in items_meta:
        item = PlanItem.from_meta(m)
        started = time.time()
        t0 = time.perf_counter()
        try:
            if init_error:
                raise RuntimeError(init_error)
            if item.scope in unavailable:
                raise RuntimeError(f"scope {item.scope} unavailable in "
                                   f"worker:\n{unavailable[item.scope]}")
            bench = REGISTRY.get(item.family)
            doc = run_single_instance([bench], item.name, run_opts)
            status, error = _instance_status(doc)
        except Exception:  # noqa: BLE001 - isolate instance failures
            status, error = ERROR, traceback.format_exc(limit=4)
            doc = {"context": {},
                   "benchmarks": [instance_error_record(item.name, status,
                                                        error)]}
        res = InstanceResult(item, status, doc, error,
                             duration_s=time.perf_counter() - t0,
                             started=started, finished=time.time())
        _write_instance_shard(spool, res)
    return 0


def _spawn_plan_worker(items: Sequence[PlanItem], spool: str,
                       opts: OrchestratorOptions) -> Tuple[int, str]:
    """Run a bin of items in a standalone interpreter; (returncode, stderr).

    Results travel through the spool directory, not the return value, so
    a worker that dies mid-bin still leaves every finished instance's
    shard behind.
    """
    fd, items_file = tempfile.mkstemp(suffix=".items", dir=spool)
    try:
        with os.fdopen(fd, "w") as f:
            json.dump([i.meta() for i in items], f)
        cmd = [sys.executable, "-m", WORKER_MODULE,
               "--worker-plan", "--items-json", items_file,
               "--spool", spool,
               "--run-json", json.dumps(asdict(opts.run)),
               "--flags-json", json.dumps(opts.flag_values)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=opts.subprocess_timeout)
        except subprocess.TimeoutExpired:
            return -9, f"timed out after {opts.subprocess_timeout}s"
        return proc.returncode, proc.stderr or ""
    finally:
        try:
            os.unlink(items_file)
        except OSError:
            pass


def _run_bin(bin_items: Sequence[PlanItem], spool: str,
             opts: OrchestratorOptions) -> Dict[str, InstanceResult]:
    """Execute one worker bin; recover per-instance from worker death.

    If the batch interpreter dies, finished instances are recovered from
    the spool and each missing one is retried in its own interpreter —
    the instance that kills its solo worker too is marked CRASHED, its
    bin-mates all still report.
    """
    rc, stderr = _spawn_plan_worker(bin_items, spool, opts)
    out: Dict[str, InstanceResult] = {}
    missing: List[PlanItem] = []
    for item in bin_items:
        res = _load_instance_shard(spool, item)
        if res is not None:
            out[item.instance_id] = res
        else:
            missing.append(item)
    if missing and len(bin_items) > 1:
        log.warning("plan worker died (exit %s); retrying %d instance(s) "
                    "solo: %s", rc, len(missing),
                    [i.name for i in missing])
    for item in missing:
        if len(bin_items) > 1:
            rc, stderr = _spawn_plan_worker([item], spool, opts)
            res = _load_instance_shard(spool, item)
            if res is not None:
                out[item.instance_id] = res
                continue
        now = time.time()
        res = InstanceResult(
            item, CRASHED, None,
            error=f"worker exited {rc}:\n{stderr[-2000:]}",
            started=now, finished=now)
        _write_instance_shard(spool, res)
        # re-read so doc/meta match what a resume would reconstruct
        out[item.instance_id] = _load_instance_shard(spool, item) or res
    return out


def merge_plan(plan: Plan, results: Dict[str, InstanceResult],
               context_extra: Optional[Dict[str, Any]] = None,
               run_id: Optional[str] = None,
               rollups: Optional[List[ScopeShard]] = None,
               device: str = "cuda") -> Dict[str, Any]:
    """Merge instance results into one GB-JSON document, in *plan order*.

    Plan order — not completion order — is what makes the merged document
    deterministic across ``--jobs`` and bin assignments: it is identical,
    benchmark for benchmark, to an inline scope-grained run.  The plan
    enumerates scope by scope, so concatenating the per-scope rollups
    (pass precomputed ``rollups`` to avoid rebuilding them) *is* plan
    order.  The context describes ``device``, where the instances ran.
    """
    rollups = _scope_rollups(plan, results) if rollups is None else rollups
    ctx = build_context(context_extra, device=device)
    if run_id:
        ctx["run_id"] = run_id
    ctx["shard_grain"] = "benchmark"
    ctx["shards"] = [r.meta() for r in rollups]
    ctx["instances"] = [
        results[i.instance_id].meta() if i.instance_id in results
        else {**i.meta(), "status": PENDING}
        for i in plan.items
    ]
    benchmarks: List[Dict[str, Any]] = []
    for shard in rollups:
        benchmarks.extend(shard.doc.get("benchmarks", []))
    return {"context": ctx, "benchmarks": benchmarks}


def _scope_rollups(plan: Plan, results: Dict[str, InstanceResult]
                   ) -> List[ScopeShard]:
    """Per-scope ScopeShard views over instance results.

    Keeps scope-grained consumers (benchmarks/run.py, ScopePlot's
    ``shards()``) working on plan-grained runs: ``ok`` when every
    instance succeeded, ``partial`` when some did, ``error``/``crashed``
    when none did.
    """
    shards: List[ScopeShard] = []
    for scope in plan.scopes():
        scope_items = [i for i in plan.items if i.scope == scope]
        rs = [results.get(i.instance_id) for i in scope_items]
        statuses = [r.status if r is not None else PENDING for r in rs]
        n_ok = sum(1 for s in statuses if s == OK)
        if n_ok == len(statuses):
            status = OK
        elif n_ok:
            status = PARTIAL
        elif CRASHED in statuses:
            status = CRASHED
        else:
            status = ERROR
        benchmarks: List[Dict[str, Any]] = []
        for item, r in zip(scope_items, rs):
            if r is not None and r.doc is not None:
                benchmarks.extend(r.doc.get("benchmarks", []))
            else:
                benchmarks.append(instance_error_record(
                    item.name, r.status if r else PENDING,
                    r.error if r else "never executed"))
        error = "; ".join(
            f"{i.name}: {r.error.strip().splitlines()[-1]}"
            for i, r in zip(scope_items, rs)
            if r is not None and r.status != OK and r.error)[:2000]
        shards.append(ScopeShard(
            scope, scope_items[0].module, status,
            {"context": {"scope": scope}, "benchmarks": benchmarks},
            error=error,
            duration_s=sum(r.duration_s for r in rs if r is not None)))
    return shards


def _execute_plan_grain(mgr, registry, opts: OrchestratorOptions,
                        context_extra: Optional[Dict[str, Any]] = None
                        ) -> RunResult:
    """Benchmark-grained execution: plan → LPT bins → shards → merge."""
    cost_hints: Dict[str, float] = {}
    if opts.cost_source:
        try:
            cost_hints = load_cost_hints(opts.cost_source)
        except (OSError, json.JSONDecodeError) as e:
            log.warning("cost source %s unreadable (%s); planning without "
                        "hints", opts.cost_source, e)
    plan = build_plan(mgr, registry, opts.benchmark_filter,
                      cost_hints=cost_hints,
                      param_filter=opts.run.param_filter)
    run_id = opts.run_id or default_run_id()
    out_dir = None
    if opts.results_dir:
        out_dir = os.path.join(opts.results_dir, run_id)
    if opts.resume and (out_dir is None or not os.path.isdir(out_dir)):
        raise FileNotFoundError(
            f"--resume {run_id}: no run directory "
            f"{out_dir or '(need --results-dir)'}")

    spool_tmp = None
    if out_dir:
        spool = os.path.join(out_dir, "shards")
        os.makedirs(spool, exist_ok=True)
    else:
        spool = spool_tmp = tempfile.mkdtemp(prefix="repro-torch-spool-")

    try:
        results: Dict[str, InstanceResult] = {}
        if opts.resume:
            # shard files are the source of truth — an orchestrator killed
            # between a worker's shard write and the next manifest rewrite
            # must not re-run that instance
            for item in plan.items:
                res = _load_instance_shard(spool, item)
                if res is not None and res.status == OK:
                    res.cached = True
                    results[item.instance_id] = res
            log.info("resume %s: %d/%d instance(s) already complete",
                     run_id, len(results), len(plan.items))
        if opts.cached_results:
            # delta run: fingerprint-fresh instances replay their latest
            # history record instead of executing
            # (repro_torch.core.fingerprint)
            skipped = 0
            for item in plan.items:
                rec = opts.cached_results.get(item.instance_id)
                if rec is None or item.instance_id in results:
                    continue
                res = cached_instance_result(item, rec)
                if out_dir:
                    _write_instance_shard(spool, res)
                results[item.instance_id] = res
                skipped += 1
            log.info("delta %s: %d/%d instance(s) fresh (cached), "
                     "%d to run", run_id, skipped, len(plan.items),
                     len(plan.items) - len(results))
        pending = [i for i in plan.items if i.instance_id not in results]

        if out_dir:
            write_manifest(out_dir, run_id, plan, results)

        def on_result(res: InstanceResult) -> None:
            results[res.item.instance_id] = res
            log.info("instance %s: %s (%.2fs)", res.item.name, res.status,
                     res.duration_s)
            if out_dir:
                write_manifest(out_dir, run_id, plan, results)

        mode = opts.mode()
        # external scopes (add_scope, no importable module) can't be
        # re-imported by a worker — they always run inline in the parent
        inline_items = [i for i in pending
                        if mode == "inline" or i.module == EXTERNAL]
        worker_items = [i for i in pending if i not in inline_items]

        if worker_items:
            _build_kernels(opts.run)
            bins = plan.bins(opts.jobs, worker_items)
            log.info("scheduling %d instance(s) across %d worker bin(s) "
                     "(LPT, predicted makespan %.2fs)",
                     len(worker_items), len(bins),
                     max(sum(plan.cost_of(i) for i in b) for b in bins))
            with ThreadPoolExecutor(max_workers=max(1, opts.jobs)) as tp:
                futs = [tp.submit(_run_bin, b, spool, opts) for b in bins]
                for fut in as_completed(futs):
                    for res in fut.result().values():
                        on_result(res)
        for item in inline_items:
            res = _run_instance_inline(item, registry, opts)
            if out_dir:
                _write_instance_shard(spool, res)
            on_result(res)

        shards = _scope_rollups(plan, results)
        doc = merge_plan(plan, results, context_extra=context_extra,
                         run_id=run_id, rollups=shards,
                         device=opts.run.device)
        if out_dir:
            write_json(doc, os.path.join(out_dir, "merged.json"))
            log.info("wrote %s (%d records from %d instances)",
                     os.path.join(out_dir, "merged.json"),
                     len(doc["benchmarks"]), len(plan.items))
            _append_history(opts.results_dir, doc, run_id,
                            tag=opts.history_tag)
        return RunResult(doc=doc, shards=shards, run_id=run_id,
                         out_dir=out_dir, plan=plan,
                         instances=[results[i.instance_id]
                                    for i in plan.items
                                    if i.instance_id in results])
    finally:
        if spool_tmp:
            shutil.rmtree(spool_tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def execute(mgr, registry, opts: OrchestratorOptions,
            context_extra: Optional[Dict[str, Any]] = None) -> RunResult:
    """Run every enabled scope of ``mgr`` under ``opts``; merge the shards.

    ``mgr`` must already be loaded/configured *and registered*
    (``mgr.register_all()``) — plan construction enumerates the registry.
    ``opts.grain()`` picks the schedulable unit: benchmark instances
    (:func:`_execute_plan_grain`) or whole scopes.  External scopes
    (added with ``add_scope``, no importable module) always run inline —
    a worker cannot re-import them.
    """
    if opts.grain() == "benchmark":
        return _execute_plan_grain(mgr, registry, opts, context_extra)
    if opts.resume:
        # silently re-running everything would invalidate the manifest
        # timestamps resume exists to preserve
        raise ValueError("--resume requires benchmark shard grain "
                         "(drop --shard-grain scope)")
    if opts.cached_results is not None:
        raise ValueError("--since delta runs require benchmark shard "
                         "grain (drop --shard-grain scope)")

    items = scope_worklist(mgr)
    run_id = opts.run_id or default_run_id()
    out_dir = None
    if opts.results_dir:
        out_dir = os.path.join(opts.results_dir, run_id)
        os.makedirs(out_dir, exist_ok=True)

    def on_shard(shard: ScopeShard) -> None:
        log.info("scope %s: %s (%d records, %.2fs)", shard.scope,
                 shard.status,
                 len(shard.doc["benchmarks"]) if shard.doc else 0,
                 shard.duration_s)
        if out_dir:
            _persist_shard(out_dir, shard)

    mode = opts.mode()
    parallel_items = [(n, m) for n, m in items if m != EXTERNAL]
    inline_items = [(n, m) for n, m in items if m == EXTERNAL]
    if mode == "inline":
        inline_items, parallel_items = items, []

    shards: List[ScopeShard] = []
    for name, module in inline_items:
        shard = _run_inline(name, module, registry, opts)
        on_shard(shard)
        shards.append(shard)
    if parallel_items:
        _build_kernels(opts.run)
        if mode == "subprocess":
            with ThreadPoolExecutor(max_workers=max(1, opts.jobs)) as tp:
                futs = {tp.submit(_run_subprocess, n, m, opts): (n, m)
                        for n, m in parallel_items}
                got = {}
                for fut in as_completed(futs):
                    shard = fut.result()
                    on_shard(shard)
                    got[shard.scope] = shard
            shards.extend(got[n] for n, _ in parallel_items if n in got)
        else:
            shards.extend(_run_pool(parallel_items, opts, on_shard))

    doc = merge_shards(shards, context_extra=context_extra, run_id=run_id,
                       device=opts.run.device)
    if out_dir:
        write_json(doc, os.path.join(out_dir, "merged.json"))
        log.info("wrote %s (%d records from %d shards)",
                 os.path.join(out_dir, "merged.json"),
                 len(doc["benchmarks"]), len(shards))
        _append_history(opts.results_dir, doc, run_id,
                        tag=opts.history_tag)
    return RunResult(doc=doc, shards=shards, run_id=run_id, out_dir=out_dir)


# ---------------------------------------------------------------------------
# standalone worker CLI (the subprocess-isolation entries)
# ---------------------------------------------------------------------------

def _worker_main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog=f"python -m {WORKER_MODULE}")
    ap.add_argument("--worker", action="store_true",
                    help="scope-grain worker: run one scope module")
    ap.add_argument("--worker-plan", action="store_true",
                    help="plan-grain worker: run a bin of instances")
    ap.add_argument("--module", help="[--worker] scope module to run")
    ap.add_argument("--out", help="[--worker] output document path")
    ap.add_argument("--items-json",
                    help="[--worker-plan] JSON file of plan-item metas")
    ap.add_argument("--spool",
                    help="[--worker-plan] instance-shard output directory")
    ap.add_argument("--filter", default=".*")
    ap.add_argument("--run-json", default="{}")
    ap.add_argument("--flags-json", default="{}")
    ns = ap.parse_args(argv)

    if ns.worker_plan:
        if not (ns.items_json and ns.spool):
            ap.error("--worker-plan requires --items-json and --spool")
        with open(ns.items_json) as f:
            items = json.load(f)
        return run_plan_items(items, RunOptions(**json.loads(ns.run_json)),
                              json.loads(ns.flags_json), ns.spool)

    if not (ns.worker and ns.module and ns.out):
        ap.error("need --worker with --module/--out, or --worker-plan")
    try:
        doc = run_one_scope(ns.module,
                            RunOptions(**json.loads(ns.run_json)),
                            ns.filter, json.loads(ns.flags_json))
    except Exception:  # noqa: BLE001 - report, don't look like a crash
        # a clean Python failure is an ERROR shard, not a CRASHED one —
        # write the traceback so the parent can tell them apart
        write_json({"worker_error": traceback.format_exc(limit=6)}, ns.out)
        return 3
    write_json(doc, ns.out)
    return 0


if __name__ == "__main__":
    sys.exit(_worker_main())
