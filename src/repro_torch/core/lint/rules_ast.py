"""Built-in AST-tier rules (SCOPE0xx/SCOPE1xx): source-level hazards.

The port of ``repro.core.lint.rules_ast``: the same ids, severities and
conditions, with the reference's jax names given their torch
counterparts (the tensor constructors and compile/transform entry points
of SCOPE102, the kernel wrappers and tile knobs of SCOPE107, this
package's meters and tree for SCOPE108 and SCOPE109).  Each rule names
a way a benchmark silently measures the wrong thing; the catalog is
docs/linting.md, and tests/test_torch_lint.py keeps one triggering and
one clean family per rule.
"""
from __future__ import annotations

import ast
import os
from typing import Iterable

from .framework import FamilyContext, FamilyRule, Finding, LintContext, \
    RegistryRule, register_rule
from .analysis import dotted_name

#: Tensor-constructor / compile entry points that belong in a fixture —
#: inside the timed loop they bill allocation/trace/compile time to the
#: workload.  Keyed by full dotted call name as written in the body.
_MODULE_ALIASES = ("np", "numpy", "torch")
_ALLOC_FNS = ("ones", "zeros", "full", "empty", "arange", "linspace",
              "eye", "ones_like", "zeros_like", "asarray", "array")
TIMED_REGION_BANNED = frozenset(
    {f"{mod}.{fn}" for mod in _MODULE_ALIASES for fn in _ALLOC_FNS}
    | {"torch.randn", "torch.rand", "torch.randint", "torch.tensor",
       "torch.as_tensor", "torch.from_numpy",
       "torch.compile", "torch.func.grad", "torch.func.vmap",
       "torch.manual_seed", "torch.Generator"})

#: Host clocks a body must never read — the meter stack owns timing
#: (manual-time families are the sanctioned exception).
WALL_CLOCK_CALLS = frozenset({
    "time.time", "time.time_ns", "time.perf_counter",
    "time.perf_counter_ns", "time.monotonic", "time.monotonic_ns",
    "time.process_time", "time.process_time_ns",
    "datetime.datetime.now", "datetime.datetime.utcnow",
})


@register_rule
class UnanalyzableFamily(FamilyRule):
    """Source unavailable/unparseable → the AST tier is flying blind."""

    id = "SCOPE000"
    severity = "info"
    title = ("benchmark body source could not be captured or parsed; "
             "AST-tier rules were skipped for this family")
    fix_hint = ("register a plain function (not a lambda/partial) so "
                "inspect.getsource sees it")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        if not fam.analysis.analyzable():
            yield self.finding(fam)


@register_rule
class UnfencedAsyncBody(FamilyRule):
    """Body never declares deliverables and family has no sync fence.

    CUDA dispatch is asynchronous: a launch returns as soon as the work
    is queued, so the timed loop then measures *enqueue* cost — the
    clock stops and the card finishes afterwards, unobserved.
    """

    id = "SCOPE101"
    severity = "error"
    title = ("timed loop never calls state.deliver and the family "
             "declares no set_sync fence — on an async backend "
             "real_time measures dispatch enqueue, not the workload")
    fix_hint = ("declare the output with state.deliver(out) inside the "
                "loop, or mark the family host-synchronous with "
                "bench.set_sync(lambda ctx: None)")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        bench = fam.bench
        ana = fam.analysis
        if not ana.analyzable() or not ana.timed_loops:
            return
        if bench.use_manual_time or bench.sync_fn is not None:
            return
        if ana.calls_state_method("deliver"):
            return
        yield self.finding(fam)


@register_rule
class TimedRegionSetupWork(FamilyRule):
    """Allocation / jit construction inside the timed loop."""

    id = "SCOPE102"
    severity = "error"
    title = ""  # built per finding
    fix_hint = ("move allocation and jit/grad construction into a "
                "set_fixture(setup) — fixtures run untimed, and the "
                "warm phase reports compile time separately")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        if not fam.analysis.analyzable():
            return
        for call in fam.analysis.timed_region_calls():
            if call.name in TIMED_REGION_BANNED:
                yield self.finding(
                    fam,
                    message=(f"{call.name}() runs inside the timed loop "
                             f"(line {call.line}): allocation/compilation "
                             f"is billed to every measured iteration"))


@register_rule
class DeadParamAxis(FamilyRule):
    """A declared axis neither the body nor the fixture ever reads."""

    id = "SCOPE103"
    severity = "warning"
    title = ""
    fix_hint = ("drop the axis from the ParamSpace, or read it "
                "(state.params.<axis> in the body, params.<axis> in "
                "the fixture)")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        dead = fam.analysis.dead_axes()
        if not dead:
            return
        for axis in dead:
            yield self.finding(
                fam,
                message=(f"parameter axis {axis!r} is declared but never "
                         f"read by the body or fixture — every point "
                         f"along it re-measures the same workload"))


@register_rule
class NoThroughputCounters(FamilyRule):
    """No bytes/items/counters: the record is a bare time."""

    id = "SCOPE104"
    severity = "warning"
    title = ("body sets no throughput signal (set_bytes_processed / "
             "set_items_processed / state.counters) — records carry "
             "times but nothing to normalize them by, so cross-size "
             "comparisons and roofline columns stay empty")
    fix_hint = ("set bytes/items processed per iteration, or record a "
                "workload counter (state.counters[...] = ...)")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        ana = fam.analysis
        if not ana.analyzable() or not ana.timed_loops:
            return
        if ana.calls_state_method("set_bytes_processed") \
                or ana.calls_state_method("set_items_processed") \
                or ana.sets_counters():
            return
        yield self.finding(fam)


@register_rule
class WallClockInBody(FamilyRule):
    """Body reads a host clock — timing belongs to the meter stack."""

    id = "SCOPE105"
    severity = "error"
    title = ""
    fix_hint = ("delete the clock call; the wall/cpu meters own timing "
                "(a family that must time itself should declare "
                "manual_time() and use state.set_iteration_time)")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        if fam.bench.use_manual_time or not fam.analysis.analyzable():
            return
        for call in fam.analysis.body_calls():
            if call.name in WALL_CLOCK_CALLS:
                yield self.finding(
                    fam,
                    message=(f"{call.name}() called in the benchmark body "
                             f"(line {call.line}): bodies must not read "
                             f"host clocks — the meter stack owns timing"))


@register_rule
class ManualTimeNeverReported(FamilyRule):
    """manual_time() family that never calls set_iteration_time."""

    id = "SCOPE106"
    severity = "error"
    title = ("family declares manual_time() but the body never calls "
             "state.set_iteration_time — every record reports zero "
             "time, and cost hints derived from it schedule garbage")
    fix_hint = ("call state.set_iteration_time(seconds) inside the "
                "loop, or drop manual_time()")

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        if not fam.bench.use_manual_time or not fam.analysis.analyzable():
            return
        if not fam.analysis.calls_state_method("set_iteration_time"):
            yield self.finding(fam)


#: AST cache for SCOPE109's package-tree scan, keyed by file path →
#: (mtime, size, findings-data).  test suites run the linter dozens of
#: times per process; re-parsing the whole package each pass would
#: dominate the AST tier.
_HISTORY_OPEN_CACHE: dict = {}

#: Modules allowed to open history.jsonl directly: the store layer they
#: implement IS the sanctioned access path.
_HISTORY_OPEN_ALLOWED = ("core/history.py", "store/")


def _history_open_sites(path: str) -> list:
    """``(lineno, call text)`` for every ``open()`` whose argument
    subtree contains a ``history.jsonl`` string literal, cached by
    (mtime, size)."""
    try:
        st = os.stat(path)
        key = (st.st_mtime_ns, st.st_size)
    except OSError:
        return []
    cached = _HISTORY_OPEN_CACHE.get(path)
    if cached is not None and cached[0] == key:
        return cached[1]
    sites: list = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src)
    except (OSError, SyntaxError, ValueError):
        _HISTORY_OPEN_CACHE[path] = (key, sites)
        return sites
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) \
                or dotted_name(node.func) != "open":
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            hit = any(isinstance(sub, ast.Constant)
                      and isinstance(sub.value, str)
                      and "history.jsonl" in sub.value
                      for sub in ast.walk(arg))
            if hit:
                sites.append((node.lineno,
                              ast.get_source_segment(src, node)
                              or "open(...)"))
                break
    _HISTORY_OPEN_CACHE[path] = (key, sites)
    return sites


@register_rule
class DirectHistoryOpen(RegistryRule):
    """``open("...history.jsonl")`` outside the sanctioned access layer.

    ``repro_torch.core.history`` and ``repro_torch.store`` are the only
    modules
    that may touch the history file directly: they own the corrupt-line
    skip semantics, the append protocol, and the store index's
    byte-offset watermark.  Any other call site re-opening the JSONL
    by hand bypasses all three — it crashes on the torn/garbage lines
    the sanctioned readers skip, and what it writes is invisible to the
    index until a rebuild.
    """

    id = "SCOPE109"
    severity = "warning"
    title = ""
    fix_hint = ("go through the store layer: repro_torch.core.history "
                "(iter_lines/load_history/append_run) or "
                "repro_torch.store (run_query/ingest_shards) — never "
                "open the JSONL directly")

    def check_registry(self, ctx: LintContext) -> Iterable[Finding]:
        import repro_torch
        pkg_root = os.path.dirname(os.path.abspath(repro_torch.__file__))
        for dirpath, dirnames, filenames in os.walk(pkg_root):
            dirnames[:] = [d for d in dirnames
                           if d not in ("__pycache__",)]
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                rel = os.path.relpath(path, pkg_root).replace(os.sep, "/")
                if rel.startswith(_HISTORY_OPEN_ALLOWED[1]) \
                        or rel == _HISTORY_OPEN_ALLOWED[0]:
                    continue
                for lineno, call in _history_open_sites(path):
                    yield self.finding(
                        family=f"module:repro_torch/{rel}",
                        location=f"{path}:{lineno}",
                        message=(
                            f"{call} opens history.jsonl directly "
                            f"outside repro_torch.core.history/"
                            f"repro_torch.store — "
                            f"it bypasses the corrupt-line skip "
                            f"semantics and the store index watermark"))


#: Tunable-kernel wrappers and their tile knobs.  Call sites that pin
#: these to literal ints opt out of the searched defaults that
#: ``python -m repro_torch tune`` ships (repro_torch.kernels.tuning), so
#: a refreshed tuned.json never reaches them.  Keyed by the *last*
#: dotted component so aliased imports still match.
TUNED_KERNEL_KNOBS = {
    "matmul": ("bm", "bn", "bk"),
    "flash_attention": ("bq", "bk"),
    "rmsnorm": ("br",),
    "ssd": ("chunk",),
    "ssd_chunk": ("chunk",),
}


@register_rule
class HardcodedKernelBlocks(FamilyRule):
    """Kernel call site pins a block-size knob to a literal int."""

    id = "SCOPE107"
    severity = "warning"
    title = ""
    fix_hint = ("drop the literal so the call picks up the tuned "
                "defaults (repro_torch.kernels.tuning: tuned.json, "
                "REPRO_TUNED_* env, builtin); refresh them with "
                "`python -m repro_torch tune <family>`")

    def _funcs(self, fam: FamilyContext):
        ana = fam.analysis
        for func in (ana.body, ana.fixture):
            if func is not None:
                yield func

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        if not fam.analysis.analyzable():
            return
        for func in self._funcs(fam):
            for node in ast.walk(func):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                if name is None:
                    continue
                leaf = name.rsplit(".", 1)[-1]
                knobs = TUNED_KERNEL_KNOBS.get(leaf)
                if knobs is None:
                    continue
                for kw in node.keywords:
                    if kw.arg not in knobs:
                        continue
                    val = kw.value
                    if isinstance(val, ast.Constant) \
                            and type(val.value) is int:
                        yield self.finding(
                            fam,
                            message=(
                                f"{name}(..., {kw.arg}={val.value}) "
                                f"hardcodes a block size (line "
                                f"{kw.value.lineno}): literal knobs "
                                f"shadow the tuned defaults shipped by "
                                f"`python -m repro_torch tune`"))


@register_rule
class HostClockInMeter(RegistryRule):
    """A registered meter's measurement methods read a host clock.

    Meters consume the timestamps the state and the sample payload
    provide (``state.elapsed``, ``state.cpu_elapsed``, per-sample
    ``latency_s``/``ttft_s`` fields stamped by the instrumented source).
    A meter that calls ``time.time()``/``perf_counter()`` in
    ``begin``/``observe``/``end`` re-measures *its own position in the
    call sequence*, not the event: under CUDA's asynchronous dispatch
    the method runs at launch-enqueue time, so the self-read clock
    reports enqueue —
    the exact un-fenced-timestamp bug class the serve engine's
    ``fence_timestamps`` and the wall meter's sync fence exist to fix.
    """

    id = "SCOPE108"
    severity = "error"
    title = ""
    fix_hint = ("read timestamps from the state (state.elapsed, "
                "state.cpu_elapsed) or from the sample payload the "
                "instrumented source stamped after fencing — never from "
                "a host clock inside the meter")

    #: The methods the stack drives around/inside the measured batch.
    METHODS = ("prepare", "begin", "observe", "end")

    def check_registry(self, ctx: LintContext) -> Iterable[Finding]:
        import inspect
        import textwrap

        from ..measure import METERS
        for name, factory in sorted(METERS.items()):
            cls = factory if isinstance(factory, type) else None
            if cls is None:
                try:
                    cls = type(factory())
                except Exception:  # noqa: BLE001 - unanalyzable factory
                    continue
            # own methods only: inherited Meter no-ops are clean by
            # definition, and scanning them would blame every meter
            # for one bad base class
            for meth in self.METHODS:
                fn = cls.__dict__.get(meth)
                if fn is None:
                    continue
                fn = inspect.unwrap(getattr(fn, "__func__", fn))
                try:
                    src = textwrap.dedent(inspect.getsource(fn))
                    tree = ast.parse(src)
                except (OSError, TypeError, SyntaxError):
                    continue
                loc = ""
                code = getattr(fn, "__code__", None)
                if code is not None:
                    loc = f"{code.co_filename}:{code.co_firstlineno}"
                for node in ast.walk(tree):
                    if not isinstance(node, ast.Call):
                        continue
                    called = dotted_name(node.func)
                    if called in WALL_CLOCK_CALLS:
                        yield self.finding(
                            family=f"meter:{name}",
                            location=loc,
                            message=(
                                f"meter {name!r} ({cls.__name__}."
                                f"{meth}) calls {called}(): meters "
                                f"must consume state/sample-provided "
                                f"timestamps, not read host clocks — "
                                f"a self-read clock stamps enqueue "
                                f"time under async dispatch"))


@register_rule
class MutableGlobalInBody(FamilyRule):
    """Body reads module-level mutable state the fingerprint can't see.

    The instance fingerprint (:mod:`repro_torch.core.fingerprint`)
    hashes the body/fixture *source*, the kernel modules it imports, the
    params, the tuned artifact and the torch/CUDA versions — a
    module-level ``list`` /
    ``dict`` / ``set`` the body reads at call time is none of those.
    Mutate it between runs and two identical fingerprints time two
    different workloads, so ``repro_torch ci`` happily skips an instance
    whose behavior changed.  Functions, classes, modules and constants
    are fine (their definitions live in hashed source); only mutable
    containers resolved from the body's globals — or an explicit
    ``global`` statement — are flagged.
    """

    id = "SCOPE110"
    severity = "warning"
    title = ""
    fix_hint = ("pass the value through the ParamSpace or build it in "
                "the fixture (both are fingerprinted); if it is truly "
                "constant, make it a scalar/tuple constant")

    #: Containers whose in-place mutation is invisible to source hashes.
    MUTABLE_TYPES = (list, dict, set, bytearray)

    @staticmethod
    def _local_names(func: ast.FunctionDef) -> set:
        """Names bound inside ``func`` — assignments, loop targets,
        comprehension vars, ``with ... as``, except aliases, args."""
        names = {a.arg for a in func.args.args + func.args.kwonlyargs}
        for extra in (func.args.vararg, func.args.kwarg):
            if extra is not None:
                names.add(extra.arg)
        for node in ast.walk(func):
            if isinstance(node, ast.Name) and isinstance(
                    node.ctx, (ast.Store, ast.Del)):
                names.add(node.id)
            elif isinstance(node, (ast.FunctionDef,
                                   ast.AsyncFunctionDef, ast.ClassDef)):
                if node is not func:
                    names.add(node.name)
            elif isinstance(node, ast.ExceptHandler) and node.name:
                names.add(node.name)
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                for alias in node.names:
                    names.add((alias.asname
                               or alias.name.split(".")[0]))
        return names

    def check_family(self, ctx: LintContext,
                     fam: FamilyContext) -> Iterable[Finding]:
        ana = fam.analysis
        if not ana.analyzable():
            return
        body = ana.body
        fn_globals = getattr(fam.bench.fn, "__globals__", None)
        if fn_globals is None:
            return
        for node in ast.walk(body):
            if isinstance(node, ast.Global):
                yield self.finding(
                    fam,
                    message=(f"body declares `global "
                             f"{', '.join(node.names)}` (line "
                             f"{node.lineno}): state carried across "
                             f"iterations through module globals is "
                             f"invisible to the instance fingerprint, "
                             f"so delta runs (`repro_torch ci`) can replay a "
                             f"changed workload as fresh"))
        locals_ = self._local_names(body)
        seen = set()
        for node in ast.walk(body):
            if not isinstance(node, ast.Name) \
                    or not isinstance(node.ctx, ast.Load) \
                    or node.id in locals_ or node.id in seen:
                continue
            if node.id not in fn_globals:
                continue
            value = fn_globals[node.id]
            if isinstance(value, self.MUTABLE_TYPES):
                seen.add(node.id)
                yield self.finding(
                    fam,
                    message=(f"body reads module-level "
                             f"{type(value).__name__} {node.id!r} "
                             f"(line {node.lineno}): mutable state "
                             f"outside the fingerprinted source — "
                             f"mutating it changes the measurement "
                             f"without changing the fingerprint, and "
                             f"delta runs (`repro_torch ci`) will skip the "
                             f"instance as fresh"))
