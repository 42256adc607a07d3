"""Benchmark, State & typed parameter spaces (paper §III-E) — torch port.

A copy of ``repro.core.benchmark`` (the JAX package's module) kept
import-free of it: instance names, duplicate rejection and the State
protocol are byte-identical, so documents from both packages pair by
name.  The tunable-kernel declaration (``Benchmark.set_tunable``, read
by ``python -m repro_torch tune``) is the reference's, and so is the
registration-time source capture that instance fingerprints hash
(:mod:`repro_torch.core.fingerprint`).

SCOPE provides "the entire Google Benchmark library ... to configure and
register the benchmark code".  This module reimplements the parts of that
library's semantics that SCOPE's benchmarks rely on, in Python, and then
goes where Google Benchmark cannot: benchmarks here sweep **named, typed
axes**, not tuples of ints.

  * ``ParamSpace`` — named axes of JSON-able values (ints, floats,
    strings, bools) composed by product / zip / explicit cases, crossed
    with ``*``, concatenated with ``+``, and pruned by constraint
    predicates (``.where``).  One registered family covers every
    dtype/backend/layout variant instead of a hand-copied clone per
    variant.
  * ``Params`` — one point of a space, handed to benchmark bodies as
    ``state.params`` (``state.params.dtype``); ``state.range(i)`` stays
    as a compat shim over the int-valued axes.
  * ``State`` — the iteration object handed to a benchmark body.
    Supports the ``while state.keep_running():`` / ``for _ in state:``
    protocols, manual timing pause/resume, counters, bytes/items
    rates, ``skip_with_error``, the fixture context
    (``state.fixture``), and **sync deliverables**
    (``state.deliver(out)``): the body hands its outputs to the state
    so the measurement layer (repro_torch.core.measure) can fence async
    dispatch *before the clock stops* — a body no longer blocks the
    device every iteration just to be measurable.  Per-*sample*
    measurements (one request's latency, one step's queue depth) flow
    through ``state.observe(sample)`` to meters implementing the
    observe channel, and ``state.now()`` is the sanctioned timestamp
    source for bodies that pace open-loop load.
  * ``Benchmark`` — a registered family: a body plus either a typed
    ``ParamSpace`` or a legacy int-tuple sweep (``args`` / ``ranges``,
    mirroring GB's ``->Args()``/``->Ranges()``), an optional *fixture*
    (``setup(params) -> ctx`` runs untimed before calibration, so
    tensor allocation leaves the timed region), a time unit, and per-benchmark overrides.

Instance naming: typed families render every axis as ``name:value``
(``family/dtype:bf16/n:256``); legacy int-tuple families keep the exact
Google-Benchmark names they always had (``family/256`` or named via
``set_arg_names``), so plan IDs, baselines and history round-trip
byte-identically across the redesign.

Duplicate arg-sets / instances are rejected at registration time (they
would otherwise collide later as plan-ID duplicates), and ``set_unit``
raises ``ValueError`` on an unknown unit instead of ``assert`` (which
``python -O`` strips).
"""
from __future__ import annotations

import inspect
import itertools
import time
from collections.abc import Mapping
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

TIME_UNITS = {"ns": 1e9, "us": 1e6, "ms": 1e3, "s": 1.0}

#: Axis values must be JSON-able scalars — they appear in instance names,
#: plan metadata and manifests verbatim.
_SCALAR_TYPES = (bool, int, float, str)


class SkipError(Exception):
    """Raised internally when a benchmark calls skip_with_error."""


def format_value(v: Any) -> str:
    """Canonical string form of an axis value, as used in instance names
    and matched by ``--param key=value`` (bools are JSON-style)."""
    if isinstance(v, bool):
        return "true" if v else "false"
    return str(v)


class Params(Mapping):
    """One point of a parameter space: an ordered, read-only mapping of
    axis name → value with attribute access (``params.dtype``)."""

    __slots__ = ("_values",)

    def __init__(self, values: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_values", dict(values or {}))

    # -- mapping protocol ---------------------------------------------
    def __getitem__(self, key: str) -> Any:
        return self._values[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._values)

    def __len__(self) -> int:
        return len(self._values)

    # -- attribute access ---------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self._values[name]
        except KeyError:
            raise AttributeError(
                f"no parameter axis {name!r} (have {list(self._values)})"
            ) from None

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("Params is read-only")

    # -- identity -----------------------------------------------------
    def canonical(self) -> str:
        """Canonical JSON of this point (sorted keys) — the stable,
        order-independent identity used for duplicate detection and
        recorded in plan metadata."""
        import json
        return json.dumps(self._values, sort_keys=True,
                          separators=(",", ":"))

    def int_values(self) -> Tuple[int, ...]:
        """The int-valued axes in axis order — what ``state.range(i)``
        indexes (the compat shim; bools are not ranges)."""
        return tuple(v for v in self._values.values()
                     if isinstance(v, int) and not isinstance(v, bool))

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v!r}" for k, v in self._values.items())
        return f"Params({inner})"


def _check_scalar(axis: str, v: Any) -> None:
    if not isinstance(v, _SCALAR_TYPES):
        raise TypeError(f"axis {axis!r}: value {v!r} is not a JSON-able "
                        f"scalar (int, float, str, bool)")


class ParamSpace:
    """Named, typed axes expanded into benchmark instances.

    Build one with :meth:`product`, :meth:`zip` or :meth:`cases`, then
    compose: ``*`` crosses two spaces with disjoint axes, ``+``
    concatenates two case lists, and :meth:`where` prunes by a
    constraint predicate::

        space = (ParamSpace.product(backend=["xla", "pallas"],
                                    dtype=["f32", "bf16"],
                                    n=[256, 512, 1024])
                 .where(lambda p: p.backend == "xla" or p.n <= 512))

    Duplicate points are rejected at construction time — they would
    produce identical instance names and collide later as plan-ID
    duplicates.
    """

    def __init__(self, points: Iterable[Dict[str, Any]]):
        self._points: List[Dict[str, Any]] = []
        seen: Dict[str, Dict[str, Any]] = {}
        for p in points:
            if not isinstance(p, dict) or not p:
                raise TypeError(f"each point must be a non-empty mapping "
                                f"(got {p!r})")
            for k, v in p.items():
                _check_scalar(k, v)
            key = Params(p).canonical()
            if key in seen:
                raise ValueError(f"duplicate parameter point {p!r}")
            seen[key] = p
            self._points.append(dict(p))

    # -- constructors ---------------------------------------------------
    @classmethod
    def product(cls, **axes: Sequence[Any]) -> "ParamSpace":
        """Cartesian product of named axes, in keyword order."""
        if not axes:
            return cls([])
        names = list(axes)
        return cls(dict(zip(names, combo))
                   for combo in itertools.product(*axes.values()))

    @classmethod
    def zip(cls, **axes: Sequence[Any]) -> "ParamSpace":
        """Equal-length axes zipped point-by-point (no cross product)."""
        lengths = {k: len(list(v)) for k, v in axes.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"zip axes must have equal lengths: {lengths}")
        names = list(axes)
        cols = [list(axes[n]) for n in names]
        return cls(dict(zip(names, row)) for row in zip(*cols))

    @classmethod
    def cases(cls, *points: Dict[str, Any]) -> "ParamSpace":
        """Explicit list of points (each a dict of axis → value)."""
        return cls(points)

    # -- composition ------------------------------------------------
    def where(self, pred: Callable[[Params], bool]) -> "ParamSpace":
        """Keep only the points the constraint predicate accepts."""
        return ParamSpace(p for p in self._points if pred(Params(p)))

    def __mul__(self, other: "ParamSpace") -> "ParamSpace":
        """Cross product of two spaces with disjoint axes."""
        overlap = set().union(*self._points or [{}]) & \
            set().union(*other._points or [{}])
        if overlap:
            raise ValueError(f"cannot cross spaces sharing axes {overlap}")
        return ParamSpace({**a, **b} for a in self._points
                          for b in other._points)

    def __add__(self, other: "ParamSpace") -> "ParamSpace":
        """Concatenate the case lists (duplicates still rejected)."""
        return ParamSpace(list(self._points) + list(other._points))

    # -- access -----------------------------------------------------
    def points(self) -> List[Params]:
        return [Params(p) for p in self._points]

    def axes(self) -> List[str]:
        """Axis names in first-seen order across all points."""
        out: List[str] = []
        for p in self._points:
            for k in p:
                if k not in out:
                    out.append(k)
        return out

    def __len__(self) -> int:
        return len(self._points)

    def __iter__(self) -> Iterator[Params]:
        return iter(self.points())


def parse_param_filter(pairs: Sequence[str]
                       ) -> Optional[Dict[str, List[str]]]:
    """``--param KEY=VALUE`` occurrences → ``{key: [values]}`` (None
    when empty).  Raises ``ValueError`` on a pair without ``=``."""
    out: Dict[str, List[str]] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"--param expects KEY=VALUE, got {pair!r}")
        key, value = pair.split("=", 1)
        out.setdefault(key, []).append(value)
    return out or None


def name_params(name: str) -> Dict[str, str]:
    """Parse the ``axis:value`` components back out of an instance name
    (the inverse of typed naming, for documents where only names
    survive — baselines, history records)."""
    out: Dict[str, str] = {}
    for part in name.split("/")[1:]:
        if ":" in part:
            k, v = part.split(":", 1)
            out[k] = v
    return out


def match_params(params: Mapping, param_filter:
                 Optional[Dict[str, Sequence[str]]]) -> bool:
    """Does an instance's ``Params`` satisfy a ``--param`` filter?

    ``param_filter`` maps axis name → accepted *string* values (as typed
    on the command line); values are compared through
    :func:`format_value`, so ``--param n=256`` matches the int axis
    value ``256``.  Multiple values for one key OR together; distinct
    keys AND together.  An instance lacking a filtered axis never
    matches.
    """
    if not param_filter:
        return True
    for key, accepted in param_filter.items():
        if key not in params:
            return False
        if format_value(params[key]) not in accepted:
            return False
    return True


class State:
    """Iteration state for one benchmark run (one point of the space)."""

    def __init__(self, ranges: Sequence[int] = (), max_iterations: int = 1,
                 params: Optional[Params] = None, fixture: Any = None):
        self.params: Params = params if params is not None else Params()
        self._ranges: Tuple[int, ...] = (tuple(ranges) if ranges
                                         else self.params.int_values())
        self.fixture = fixture
        self.max_iterations = max_iterations
        self.iterations = 0
        self.counters: Dict[str, float] = {}
        self.bytes_processed = 0
        self.items_processed = 0
        self.label = ""
        self.error_occurred = False
        self.error_message = ""
        self.skipped = False
        self.skip_message = ""
        # sync deliverables: the batch's outputs, declared by the body
        # (state.deliver(out)); the measurement layer fences on them
        self.deliverables: Any = None
        # fence hook installed by the wall-clock meter: runs before the
        # stop timestamp is captured, so async dispatch is inside the
        # timed window (repro_torch.core.measure.WallClockMeter)
        self._sync: Optional[Callable[["State"], Any]] = None
        # per-sample observer installed by the meter stack: state.observe
        # routes per-request samples (TTFT, latency, queue depth) to the
        # meters' observe channel (repro_torch.core.measure.Meter.observe)
        self._observer: Optional[Callable[["State", Mapping], None]] = None
        # manual timing
        self._timing = False
        self._t_start = 0.0
        self._elapsed = 0.0
        self._cpu_start = 0.0
        self._cpu_elapsed = 0.0
        self._paused_elapsed = 0.0

    # -- GB arg access ------------------------------------------------
    def range(self, i: int = 0) -> int:
        """Compat shim: the i-th *int-valued* axis of ``state.params``
        (exactly the old tuple position for legacy int sweeps)."""
        return self._ranges[i]

    @property
    def ranges(self) -> Tuple[int, ...]:
        return self._ranges

    # -- iteration protocol --------------------------------------------
    def keep_running(self) -> bool:
        if self.error_occurred or self.skipped:
            return False
        if self.iterations == 0:
            self._start_timer()
        if self.iterations >= self.max_iterations:
            self._stop_timer()
            return False
        self.iterations += 1
        return True

    def __iter__(self):
        while self.keep_running():
            yield self.iterations

    # -- timing ----------------------------------------------------------
    def _start_timer(self) -> None:
        self._timing = True
        self._t_start = time.perf_counter()
        self._cpu_start = time.process_time()

    def _stop_timer(self) -> None:
        if self._timing:
            # fence BEFORE capturing the stop timestamp: async dispatch
            # (CUDA enqueues work and returns) must complete inside the
            # timed window, or the clock measures enqueue cost
            if self._sync is not None:
                self._sync(self)
            self._elapsed += time.perf_counter() - self._t_start
            self._cpu_elapsed += time.process_time() - self._cpu_start
            self._timing = False

    def pause_timing(self) -> None:
        """GB PauseTiming(): exclude a section from the measured time."""
        self._stop_timer()

    def resume_timing(self) -> None:
        self._start_timer()

    def set_iteration_time(self, seconds: float) -> None:
        """GB SetIterationTime() for manual-time benchmarks."""
        self._paused_elapsed += seconds

    @property
    def elapsed(self) -> float:
        return self._elapsed

    @property
    def cpu_elapsed(self) -> float:
        """Process CPU seconds over the same window as :attr:`elapsed`."""
        return self._cpu_elapsed

    @property
    def manual_elapsed(self) -> float:
        return self._paused_elapsed

    @staticmethod
    def now() -> float:
        """Sanctioned monotonic timestamp for bodies that *schedule* work.

        Benchmark bodies must not read host clocks to time themselves
        (the meter stack owns timing) —
        but an open-loop load generator legitimately needs the current
        time to pace arrivals and stamp per-request samples.  ``state
        .now()`` is that sanctioned source: same epoch as the timer
        (``time.perf_counter``), and its readings are only meaningful
        relative to each other.
        """
        return time.perf_counter()

    # -- results ----------------------------------------------------------
    def deliver(self, value: Any) -> Any:
        """Declare the batch's output as the sync deliverable.

        Call inside the timed loop with whatever the body computes
        (``state.deliver(fn(x))``); the default sync fence blocks on the
        *last* delivered value before the clock stops, so the whole
        pipelined batch — not just its enqueue — is measured.  Returns
        ``value`` so it can wrap an expression in place.
        """
        self.deliverables = value
        return value

    def observe(self, sample: Mapping) -> Mapping:
        """Deliver one per-*sample* measurement to the meter stack.

        ``begin``/``end`` bracket a whole batch; some measurements are
        per-event inside it — one serving request's TTFT and end-to-end
        latency, one step's queue depth.  The body hands each event to
        ``state.observe({"latency_s": ..., ...})`` and meters that
        implement the observe channel (repro_torch.core.measure.Meter.observe,
        e.g. ``--meters latency``) aggregate them into counters.  With
        no observing meter installed the sample is dropped — bodies
        never need to know which meters are measuring them.  Returns
        ``sample`` so it can wrap an expression in place.
        """
        if self._observer is not None:
            self._observer(self, sample)
        return sample

    def set_bytes_processed(self, n: int) -> None:
        self.bytes_processed = n

    def set_items_processed(self, n: int) -> None:
        self.items_processed = n

    def set_label(self, label: str) -> None:
        self.label = label

    def skip_with_error(self, msg: str) -> None:
        self.error_occurred = True
        self.error_message = msg

    def skip_with_message(self, msg: str) -> None:
        self.skipped = True
        self.skip_message = msg


BenchmarkFn = Callable[[State], None]
FixtureFn = Callable[[Params], Any]


def _capture_source(fn: Any) -> Tuple[Optional[str], str, int]:
    """Best-effort ``(source, file, line)`` for a registered callable.

    Captured eagerly at registration so the instance fingerprint
    (:mod:`repro_torch.core.fingerprint`) still sees the text when the
    defining module is later rewritten or the function was built
    dynamically.
    """
    try:
        source = inspect.getsource(fn)
    except (OSError, TypeError):
        return None, "", 0
    try:
        file = inspect.getsourcefile(fn) or ""
        line = inspect.getsourcelines(fn)[1]
    except (OSError, TypeError):
        file, line = "", 0
    return source, file, line


@dataclass(frozen=True)
class Tunable:
    """A family's tunable-kernel declaration (``python -m repro_torch
    tune``).

    ``kernel`` names the :mod:`repro_torch.kernels.tuning` artifact the
    search writes; ``space`` is the knob space searched (axes must be
    that kernel's knobs); ``instance`` is a parameter filter (axis →
    formatted value) selecting which point of the family's sweep each
    trial drives.  The core stays kernel-agnostic — knob validity is
    checked by the tune CLI against the tuning registry, and the
    variant by the wrapper the instance calls.
    """

    kernel: str
    space: ParamSpace
    instance: Tuple[Tuple[str, str], ...] = ()

    def instance_filter(self) -> Optional[Dict[str, List[str]]]:
        """The declaration's filter in ``--param`` shape (None if empty)."""
        return {k: [v] for k, v in self.instance} or None


@dataclass
class Benchmark:
    """A registered benchmark family (body + parameter space + metadata).

    The sweep is either a typed :class:`ParamSpace` (``param_space``) or
    a legacy int-tuple sweep built with the GB-style fluent builders —
    never both.  Legacy sweeps keep their exact historical instance
    names; typed sweeps render every axis as ``name:value``.
    """

    name: str
    fn: BenchmarkFn
    scope: str = "core"
    arg_sets: List[Tuple[int, ...]] = field(default_factory=list)
    arg_names: List[str] = field(default_factory=list)
    space: Optional[ParamSpace] = None
    fixture: Optional[FixtureFn] = None
    unit: str = "us"
    min_time: Optional[float] = None       # per-benchmark override
    repetitions: Optional[int] = None
    iterations: Optional[int] = None       # fixed iteration count (no adaptation)
    use_manual_time: bool = False
    # per-family measurement overrides (repro_torch.core.measure): a sync(ctx)
    # fence for the wall meter, and a meter-set override (names or
    # Meter instances) taking precedence over RunOptions.meters
    sync_fn: Optional[Callable[[Any], Any]] = None
    meters: Optional[List[Any]] = None
    # tunable-kernel declaration (python -m repro_torch tune): which
    # repro_torch.kernels.tuning artifact this family's measurements
    # feed, the knob space to search, and the instance point to drive
    tunable: Optional[Tunable] = None
    labels: Dict[str, str] = field(default_factory=dict)
    doc: str = ""
    # source captured at registration time for the instance fingerprint
    # (repro_torch.core.fingerprint) — None when inspect.getsource
    # cannot see it (lambdas, REPL definitions)
    source: Optional[str] = None
    source_file: str = ""
    source_line: int = 0
    fixture_source: Optional[str] = None

    # -- typed sweep builders -------------------------------------------
    def param_space(self, space: Optional[ParamSpace] = None,
                    **axes: Sequence[Any]) -> "Benchmark":
        """Attach a typed parameter space (or build a product from
        keyword axes): ``b.param_space(dtype=["f32", "bf16"], n=[256])``."""
        if self.arg_sets:
            raise ValueError(
                f"benchmark {self.name!r} already has int-tuple arg-sets; "
                "a family is typed or legacy, not both")
        if space is not None and axes:
            raise ValueError("pass a ParamSpace or keyword axes, not both")
        self.space = space if space is not None \
            else ParamSpace.product(**axes)
        return self

    def set_fixture(self, fn: FixtureFn) -> "Benchmark":
        """``setup(params) -> ctx`` runs once per instance, untimed,
        before calibration; the context is handed to the body as
        ``state.fixture``."""
        self.fixture = fn
        self.fixture_source = _capture_source(fn)[0]
        return self

    def set_sync(self, fn: Callable[[Any], Any]) -> "Benchmark":
        """Per-family device-sync fence, run by the wall-clock meter
        *before the clock stops* (repro_torch.core.measure).

        ``fn(state)`` receives the batch state (``state.deliverables``,
        ``state.fixture``, ``state.params``).  Default when unset:
        ``torch.cuda.synchronize`` when the delivered outputs hold a
        CUDA tensor (falling back to the fixture context).  Pass a no-op (``lambda ctx:
        None``) to declare a host-synchronous family that needs no
        fence.
        """
        self.sync_fn = fn
        return self

    def set_meters(self, *meters: Any) -> "Benchmark":
        """Per-family meter-set override: names from
        ``repro_torch.core.measure.METERS`` and/or Meter instances.  Takes
        precedence over the run-level ``--meters`` selection; the wall
        and CPU meters are always included (the time sources).  Name
        typos fail here, at registration — not as per-instance error
        records at run time."""
        from .measure import validate_meter_name
        for m in meters:
            if isinstance(m, str):
                validate_meter_name(m)
        self.meters = list(meters)
        return self

    def set_tunable(self, kernel: str, space: Optional[ParamSpace] = None,
                    instance: Optional[Dict[str, Any]] = None,
                    **axes: Sequence[Any]) -> "Benchmark":
        """Declare the tunable kernel this family measures::

            matmul.set_tunable("matmul", bm=[64, 128], bn=[64, 128],
                               bk=[64],
                               instance={"backend": "cuda",
                                         "dtype": "bf16"})

        ``python -m repro_torch tune <family>`` searches the knob space,
        runs this family's ``instance`` point per trial, and writes the
        winner as the artifact entry of the variant and card it ran."""
        if space is not None and axes:
            raise ValueError("pass a ParamSpace or keyword axes, not both")
        space = space if space is not None else ParamSpace.product(**axes)
        if not len(space):
            raise ValueError(
                f"benchmark {self.name!r}: tunable knob space is empty")
        inst = tuple(sorted((k, format_value(v))
                            for k, v in (instance or {}).items()))
        self.tunable = Tunable(kernel=kernel, space=space, instance=inst)
        return self

    # -- GB-style fluent sweep builders -----------------------------------
    def _append_arg_set(self, values: Tuple[int, ...]) -> None:
        if self.space is not None:
            raise ValueError(
                f"benchmark {self.name!r} already has a ParamSpace; "
                "a family is typed or legacy, not both")
        if values in self.arg_sets:
            raise ValueError(
                f"benchmark {self.name!r}: duplicate arg-set {values!r} "
                f"(instance {self.instance_name(values)!r} would collide)")
        self.arg_sets.append(values)

    def args(self, values: Sequence[int]) -> "Benchmark":
        self._append_arg_set(tuple(values))
        return self

    def args_product(self, lists: Sequence[Sequence[int]]) -> "Benchmark":
        """GB ArgsProduct: cartesian product of per-position value lists."""
        for combo in itertools.product(*lists):
            self._append_arg_set(tuple(combo))
        return self

    def range_multiplier_args(self, lo: int, hi: int, mult: int = 2
                              ) -> "Benchmark":
        """GB Range(lo, hi): geometric sweep of a single argument."""
        v = lo
        while v <= hi:
            self._append_arg_set((v,))
            v *= mult
        return self

    def ranges(self, pairs: Sequence[Tuple[int, int]], mult: int = 2
               ) -> "Benchmark":
        """GB Ranges: cartesian product of geometric sweeps."""
        axes: List[List[int]] = []
        for lo, hi in pairs:
            ax, v = [], lo
            while v <= hi:
                ax.append(v)
                v *= mult
            axes.append(ax)
        for combo in itertools.product(*axes):
            self._append_arg_set(tuple(combo))
        return self

    def set_arg_names(self, names: Sequence[str]) -> "Benchmark":
        self.arg_names = list(names)
        return self

    def set_unit(self, unit: str) -> "Benchmark":
        if unit not in TIME_UNITS:
            raise ValueError(f"unknown time unit {unit!r} (expected one "
                             f"of: {', '.join(TIME_UNITS)})")
        self.unit = unit
        return self

    def set_min_time(self, seconds: float) -> "Benchmark":
        self.min_time = seconds
        return self

    def set_iterations(self, n: int) -> "Benchmark":
        self.iterations = n
        return self

    def manual_time(self) -> "Benchmark":
        self.use_manual_time = True
        return self

    def set_label(self, key: str, value: str) -> "Benchmark":
        self.labels[key] = value
        return self

    # -- naming -------------------------------------------------------
    def _legacy_params(self, arg_set: Tuple[int, ...]) -> Params:
        """Params view of a legacy int arg-set: named axes when
        ``set_arg_names`` matches, positional ``arg<i>`` keys otherwise."""
        if self.arg_names and len(self.arg_names) == len(arg_set):
            return Params(dict(zip(self.arg_names, arg_set)))
        return Params({f"arg{i}": v for i, v in enumerate(arg_set)})

    def instance_name(self, point) -> str:
        """Display name of one instance.

        Typed families: ``family/axis:value/...`` for every axis.
        Legacy families (``point`` may also be the raw int tuple):
        GB-style ``family/arg0/arg1`` or named args — byte-identical to
        the pre-ParamSpace naming.
        """
        if self.space is not None:
            parts = [f"{k}:{format_value(v)}" for k, v in point.items()]
            return self.name + "/" + "/".join(parts) if parts else self.name
        arg_set = tuple(point.values()) if isinstance(point, Mapping) \
            else tuple(point)
        if not arg_set:
            return self.name
        if self.arg_names and len(self.arg_names) == len(arg_set):
            parts = [f"{n}:{v}" for n, v in zip(self.arg_names, arg_set)]
        else:
            parts = [str(v) for v in arg_set]
        return self.name + "/" + "/".join(parts)

    def instances(self) -> List[Tuple[str, Params]]:
        """Every (display name, Params) instance of this family."""
        if self.space is not None:
            return [(self.instance_name(p), p) for p in self.space.points()]
        sets = self.arg_sets or [()]
        return [(self.instance_name(s), self._legacy_params(s))
                for s in sets]
