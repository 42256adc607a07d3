"""Pluggable measurement meters — the run stage's observation layer.

The torch port of ``repro.core.measure``.  The runner drives a
:class:`MeterStack` around every warm, calibration and repetition
batch:

  * :class:`Meter` — the provider protocol: ``begin(state)`` before the
    batch body runs, ``end(state) -> {metric: value}`` after, plus the
    per-*sample* channel ``observe(state, sample)`` fed by bodies
    calling ``state.observe({...})``.  Two metric keys are reserved for
    the canonical GB record fields (:data:`WALL_TIME`,
    :data:`CPU_TIME`); everything else lands as inlined GB counters;
  * :class:`WallClockMeter` — the primary clock.  Installs the family's
    ``sync(ctx)`` fence into the state's timer-stop path so CUDA's
    asynchronous launches are *fenced before the clock stops*: the
    default fence synchronizes the device whenever the batch's
    deliverables (``state.deliver(out)``) hold a CUDA tensor, falling
    back to the fixture context with a weak-fence warning;
  * :class:`CpuTimeMeter` — ``time.process_time`` over the same window;
  * :class:`CostModelMeter` — ``flops``, ``bytes_accessed`` and
    ``arithmetic_intensity`` from one call of the fixture's callable,
    once per instance; with the wall clock the stack derives achieved
    ``flops_per_second`` on every record;
  * :class:`LatencyMeter` — tail percentiles from the observe channel.
"""
from __future__ import annotations

import sys
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

from .logging import get_logger

log = get_logger("measure")

#: Reserved metric keys consumed by the runner for canonical GB record
#: fields (seconds per *batch*); everything else becomes a counter.
WALL_TIME = "real_time_s"
CPU_TIME = "cpu_time_s"

#: The meter set a run uses when neither the family nor the run options
#: select one.
DEFAULT_METERS = ("wall", "cpu")

#: Families already warned about a weak (inputs-only) default fence.
_WEAK_FENCE_WARNED: set = set()


def leaves(tree: Any) -> Iterator[Any]:
    """The leaves of nested tuples, lists and dicts, in order."""
    if isinstance(tree, (tuple, list)):
        for node in tree:
            yield from leaves(node)
    elif isinstance(tree, dict):
        for node in tree.values():
            yield from leaves(node)
    else:
        yield tree


def tensor_leaves(tree: Any) -> Iterator[Any]:
    """Every ``torch.Tensor`` among the leaves of ``tree``.

    Yields nothing when torch was never imported: then no tensor can
    exist, and a numpy-only family must not pay a torch import.
    """
    torch = sys.modules.get("torch")
    if torch is None:
        return
    yield from (t for t in leaves(tree) if isinstance(t, torch.Tensor))


def cuda_devices(tree: Any) -> List[Any]:
    """The distinct CUDA devices the tensors of ``tree`` lie on."""
    devices: List[Any] = []
    for t in tensor_leaves(tree):
        if t.is_cuda and t.device not in devices:
            devices.append(t.device)
    return devices


def default_sync(state, family: str = "") -> None:
    """Fence CUDA's asynchronous launches before the clock stops.

    Synchronizes every CUDA device the batch's declared deliverables
    (``state.deliver(out)``) lie on, falling back to the fixture
    context.  A family whose deliverables and fixture hold no CUDA
    tensor (numpy, or torch on the CPU) has nothing in flight, and the
    fence is a no-op for it.

    The fixture fallback is a *weak* fence in spirit: the family never
    said what it computed.  Synchronizing the device still waits for
    the work, but a family that keeps CUDA tensors in its fixture and
    never delivers is warned once, as the reference warns.
    """
    target = state.deliverables
    fallback = target is None
    if fallback:
        target = state.fixture
    if target is None:
        return
    devices = cuda_devices(target)
    if not devices:
        return
    if fallback and family not in _WEAK_FENCE_WARNED:
        _WEAK_FENCE_WARNED.add(family)
        log.warning(
            "benchmark %s: body never declared deliverables "
            "(state.deliver) — the fence falls back to the fixture's "
            "CUDA tensors; declare deliverables or set_sync", family)
    torch = sys.modules["torch"]
    for device in devices:
        torch.cuda.synchronize(device)


def fixture_call(state) -> Optional[Tuple[Callable, tuple]]:
    """The ``(callable, args)`` convention of fixture contexts.

    Builtin fixtures return ``(fn, *operands)``; meters that need the
    computation (cost model) recover it from that shape.  ``None`` when
    the fixture doesn't follow the convention.
    """
    ctx = state.fixture
    if isinstance(ctx, tuple) and ctx and callable(ctx[0]):
        return ctx[0], tuple(ctx[1:])
    return None


class Meter:
    """Measurement provider protocol (see ``repro.core.measure.Meter``).

    ``begin(state)`` runs immediately before the batch body,
    ``end(state)`` immediately after and returns ``{metric: value}``.
    ``observe(state, sample)`` receives every ``state.observe({...})``
    of the batch.  ``bind(bench)`` is called once when the stack is
    built; ``configure(opts)`` hands the meter the run options.
    """

    name = "meter"

    def bind(self, bench) -> None:  # pragma: no cover - default no-op
        pass

    def configure(self, opts) -> None:  # pragma: no cover - default no-op
        """Run-level configuration (a ``RunOptions``), once at build."""

    def prepare(self, state) -> None:  # pragma: no cover - default no-op
        """Once per instance, before the warm batch."""

    def begin(self, state) -> None:  # pragma: no cover - default no-op
        pass

    def observe(self, state, sample) -> None:  # pragma: no cover - no-op
        """One per-sample event from ``state.observe`` (a mapping)."""

    def end(self, state) -> Dict[str, float]:
        return {}


class WallClockMeter(Meter):
    """The primary clock: the state's timed window, device-fenced.

    The state's timer stops inside ``keep_running``, so the meter
    installs the family's ``sync(ctx)`` hook into the state and the
    state runs it *before capturing the stop timestamp*.  Manual-time
    families report their accumulated ``set_iteration_time`` instead.
    """

    name = "wall"

    def __init__(self, sync: Optional[Callable] = None):
        self._ctor_sync = sync           # explicit ctor fence always wins
        self._sync: Optional[Callable] = sync
        self._manual = False

    def bind(self, bench) -> None:
        self._manual = bench.use_manual_time
        if self._ctor_sync is not None:
            self._sync = self._ctor_sync
        elif bench.sync_fn is not None:
            self._sync = bench.sync_fn
        else:
            family = bench.name
            self._sync = lambda state: default_sync(state, family)

    def begin(self, state) -> None:
        if not self._manual:
            state._sync = self._sync or default_sync

    def end(self, state) -> Dict[str, float]:
        t = state.manual_elapsed if self._manual else state.elapsed
        return {WALL_TIME: t}


class CpuTimeMeter(Meter):
    """Process CPU seconds over the wall clock's timed window."""

    name = "cpu"

    def end(self, state) -> Dict[str, float]:
        return {CPU_TIME: state.cpu_elapsed}


def _tensor_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tensor_leaves(tree))


def _bytes_mode():
    """A ``TorchDispatchMode`` that sums, over every op dispatched under
    it, the bytes of the op's tensor operands and results.  Ops that
    move no data are skipped: the ops the schema marks as views
    (``func.is_view``), ``_unsafe_view``, which is one without the
    mark, the ``prim`` metadata queries (``prim.device``, which a view
    of a fake tensor dispatches) and a functional collective's
    ``wait_tensor`` (a fence on its result).  Built on call so that
    importing this module imports no torch."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    unsafe_view = torch.ops.aten._unsafe_view.default
    import torch.distributed  # noqa: F401 - registers _c10d_functional
    wait = getattr(getattr(torch.ops, "_c10d_functional", None),
                   "wait_tensor", None)
    wait = getattr(wait, "default", None)

    class BytesMode(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if not (func.is_view or func is unsafe_view or func is wait
                    or func.namespace == "prim"):
                self.nbytes += _tensor_bytes((args, kwargs)) \
                    + _tensor_bytes(out)
            return out

    return BytesMode()


class CostModelMeter(Meter):
    """Cost-model counters from one call of the fixture's callable.

    The port of ``repro.core.measure.CostModelMeter``.  The reference
    lowers the fixture's ``(fn, *args)`` through XLA and reads the
    optimized HLO; here ``prepare`` calls ``fn(*args)`` once, on the
    run's device, under two dispatch modes:

      * ``flops`` — ``torch.utils.flop_counter.FlopCounterMode``: exact
        for products (2·out·contract for ``mm``/``bmm``, convolutions,
        attention) and 0 for elementwise work, which it does not count.
        The hand kernels are ``torch.library`` custom ops, opaque to the
        counter; each registers a formula
        (``register_flop_formula``) equal to the count of its plain
        version, so a ``torch`` row and a ``cuda`` row of one family
        report the same ``flops``;
      * ``bytes_accessed`` — :func:`_bytes_mode`: each dispatched op's
        tensor operands and results, summed.  XLA's ``bytes accessed``
        is taken after fusion, so an intermediate that stays on chip
        counts nowhere; here every op is counted alone, with no fusion:
        an intermediate counts once as the result of the op that makes
        it and again as an operand of each op that reads it.  A custom
        op counts as one op (its operands and results), whatever its
        kernel reads again.

    ``arithmetic_intensity`` is their ratio.  Each counter is omitted
    when zero.  The analysis runs once per ``(family, params)`` in
    ``prepare``, before the warm batch, so it stays out of
    ``compile_time_s``; ``prepare`` synchronizes the operands' devices
    before it returns, so the analysis call's work cannot leak into the
    warm batch's timing.  A family whose fixture does not follow the
    ``(fn, *args)`` convention, or whose call raises, gets no counters
    and does not fail.
    """

    name = "costmodel"

    def __init__(self):
        self._cache: Dict[str, Dict[str, float]] = {}
        self._family = ""

    def bind(self, bench) -> None:
        # part of the cache key: a meter instance shared across
        # families (set_meters) must not hand one family's flops to
        # another family whose point has the same axis values
        self._family = bench.name

    def _key(self, state) -> str:
        return f"{self._family}|{state.params.canonical()}"

    def prepare(self, state) -> None:
        key = self._key(state)
        if key not in self._cache:
            self._cache[key] = self._analyze(state)

    def end(self, state) -> Dict[str, float]:
        key = self._key(state)
        if key not in self._cache:
            self._cache[key] = self._analyze(state)
        return dict(self._cache[key])

    def _analyze(self, state) -> Dict[str, float]:
        call = fixture_call(state)
        if call is None:
            return {}
        fn, args = call
        import torch
        from torch.utils.flop_counter import FlopCounterMode
        try:
            with FlopCounterMode(display=False) as counter, \
                    _bytes_mode() as moved:
                fn(*args)
            for device in cuda_devices(args):
                torch.cuda.synchronize(device)
        except Exception as e:  # noqa: BLE001 - degrade, don't fail the run
            log.debug("costmodel: %s could not be analyzed: %s",
                      state.params, e)
            return {}
        flops = float(counter.get_total_flops())
        nbytes = float(moved.nbytes)
        out: Dict[str, float] = {}
        if flops:
            out["flops"] = flops
        if nbytes:
            out["bytes_accessed"] = nbytes
        if flops and nbytes:
            out["arithmetic_intensity"] = flops / nbytes
        return out


class LatencyMeter(Meter):
    """Tail-latency distribution counters from the per-sample channel.

    Consumes ``latency_s``, ``ttft_s`` and ``queue_depth`` samples and
    emits ``latency_p50_s`` … ``latency_p999_s``, ``ttft_p50_s`` /
    ``ttft_p99_s``, ``queue_depth_mean``, ``requests_completed``,
    ``goodput_rps`` and, with ``--slo-ms``, ``slo_attainment`` — the
    counters of ``repro.core.measure.LatencyMeter``.
    """

    name = "latency"

    def __init__(self, slo_ms: Optional[float] = None):
        self._ctor_slo = slo_ms
        self.slo_ms = slo_ms
        self._latency: List[List[float]] = []
        self._ttft: List[List[float]] = []
        self._depth: List[float] = []

    def configure(self, opts) -> None:
        if self._ctor_slo is None:
            self.slo_ms = getattr(opts, "slo_ms", None)

    def begin(self, state) -> None:
        self._latency = [[]]
        self._ttft = [[]]
        self._depth = []

    def observe(self, state, sample) -> None:
        if "latency_s" in sample:
            self._latency[-1].append(float(sample["latency_s"]))
        if "ttft_s" in sample:
            self._ttft[-1].append(float(sample["ttft_s"]))
        if "queue_depth" in sample:
            self._depth.append(float(sample["queue_depth"]))

    def end(self, state) -> Dict[str, float]:
        from .quantile import combine, percentile, tail_percentiles
        out: Dict[str, float] = {}
        lat = combine(*self._latency)
        ttft = combine(*self._ttft)
        out.update(tail_percentiles(lat, prefix="latency_"))
        if ttft:
            out["ttft_p50_s"] = percentile(ttft, 0.50)
            out["ttft_p99_s"] = percentile(ttft, 0.99)
        if self._depth:
            out["queue_depth_mean"] = sum(self._depth) / len(self._depth)
        if lat:
            out["requests_completed"] = float(len(lat))
            slo_s = self.slo_ms / 1e3 if self.slo_ms is not None else None
            good = len(lat) if slo_s is None \
                else sum(1 for t in lat if t <= slo_s)
            span = state.manual_elapsed or state.elapsed
            if span > 0:
                out["goodput_rps"] = good / span
            if slo_s is not None:
                out["slo_attainment"] = good / len(lat)
        return out


#: Built-in meter registry: ``--meters`` names → factories.
METERS: Dict[str, Callable[[], Meter]] = {
    "wall": WallClockMeter,
    "cpu": CpuTimeMeter,
    "costmodel": CostModelMeter,
    "latency": LatencyMeter,
}


def validate_meter_name(name: str) -> str:
    """Raise ``ValueError`` unless ``name`` is a registered meter."""
    if name not in METERS:
        raise ValueError(
            f"unknown meter {name!r} (available: {', '.join(METERS)})")
    return name


def parse_meters(spec: str) -> List[str]:
    """``--meters wall,cpu,costmodel`` → validated name list."""
    names: List[str] = []
    for part in spec.split(","):
        name = part.strip()
        if not name:
            continue
        validate_meter_name(name)
        if name not in names:
            names.append(name)
    if not names:
        raise ValueError("--meters needs at least one meter name")
    return names


class MeterStack:
    """An ordered meter set driven around one batch.

    ``begin`` runs meters in order, ``end`` in reverse order (the wall
    meter is always first, so its clock brackets the others' reads).
    ``end`` merges every meter's metrics and, with both a cost model and
    a wall time present, adds achieved ``flops_per_second``.
    """

    def __init__(self, meters: Sequence[Meter]):
        self.meters = list(meters)

    @classmethod
    def build(cls, spec: Optional[Sequence[Any]], bench,
              run_opts: Optional[Any] = None) -> "MeterStack":
        """Resolve a meter spec (names, instances, factories) for one
        family.  The wall and CPU meters are mandatory and prepended
        when the spec omits them — they are the record's time sources."""
        meters: List[Meter] = []
        for item in (spec or DEFAULT_METERS):
            if isinstance(item, str):
                meters.append(METERS[validate_meter_name(item)]())
            elif isinstance(item, Meter):
                meters.append(item)
            elif callable(item):
                meters.append(item())
            else:
                raise TypeError(f"not a meter: {item!r}")
        if not any(isinstance(m, CpuTimeMeter) for m in meters):
            meters.insert(0, CpuTimeMeter())
        if not any(isinstance(m, WallClockMeter) for m in meters):
            meters.insert(0, WallClockMeter())
        for m in meters:
            m.bind(bench)
            if run_opts is not None:
                m.configure(run_opts)
        return cls(meters)

    def prepare(self, state) -> None:
        for m in self.meters:
            m.prepare(state)

    def begin(self, state) -> None:
        state._observer = self._observe
        for m in self.meters:
            m.begin(state)

    def _observe(self, state, sample) -> None:
        for m in self.meters:
            m.observe(state, sample)

    def end(self, state) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        for m in reversed(self.meters):
            metrics.update(m.end(state))
        wall = metrics.get(WALL_TIME)
        flops = metrics.get("flops")
        if wall and flops:
            metrics["flops_per_second"] = \
                flops * max(state.iterations, 1) / wall
        return metrics
