"""Global benchmark registry — how benchmark code reaches the SCOPE binary
(a copy of ``repro.core.registry`` for the torch port).

In the paper, scopes register benchmarks through Google Benchmark's
``BENCHMARK()`` macro and the core binary links every object library into a
single executable.  Here, scopes register through :func:`register_benchmark`
(usually via the :func:`benchmark` decorator) and the registry is the link
step: one namespace, uniform filtering, uniform reporting.

Names are mangled ``<scope>/<family>`` so results are attributable to the
scope that produced them, mirroring SCOPE's per-scope name prefixes.
"""
from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence

from .benchmark import Benchmark, BenchmarkFn, _capture_source, match_params


class BenchmarkRegistry:
    def __init__(self) -> None:
        self._benchmarks: Dict[str, Benchmark] = {}

    def register(self, bench: Benchmark) -> Benchmark:
        if bench.name in self._benchmarks:
            raise ValueError(f"benchmark {bench.name!r} already registered")
        self._benchmarks[bench.name] = bench
        return bench

    def get(self, name: str) -> Benchmark:
        return self._benchmarks[name]

    def all(self) -> List[Benchmark]:
        return list(self._benchmarks.values())

    def filter(self, pattern: str = ".*",
               scopes: Optional[Sequence[str]] = None,
               params: Optional[Dict[str, List[str]]] = None
               ) -> List[Benchmark]:
        """Select benchmark families by name regex, owning scope, and/or
        a ``--param key=value`` predicate (family kept when *any* of its
        instances carries a matching parameter point)."""
        rx = re.compile(pattern)
        out = []
        for b in self._benchmarks.values():
            if scopes is not None and b.scope not in scopes:
                continue
            instances = b.instances()
            # match either the family name or any instance name
            if not (rx.search(b.name) or any(
                    rx.search(n) for n, _ in instances)):
                continue
            if params and not any(match_params(p, params)
                                  for _, p in instances):
                continue
            out.append(b)
        return out

    def remove_scope(self, scope: str) -> None:
        for name in [n for n, b in self._benchmarks.items()
                     if b.scope == scope]:
            del self._benchmarks[name]

    def reset(self) -> None:
        self._benchmarks.clear()

    def __len__(self) -> int:
        return len(self._benchmarks)

    def __contains__(self, name: str) -> bool:
        return name in self._benchmarks


REGISTRY = BenchmarkRegistry()


def register_benchmark(name: str, fn: BenchmarkFn, scope: str = "core",
                       registry: Optional[BenchmarkRegistry] = None,
                       **kwargs) -> Benchmark:
    """Imperative registration (GB ``RegisterBenchmark`` analogue)."""
    reg = registry if registry is not None else REGISTRY
    full = f"{scope}/{name}" if not name.startswith(scope + "/") else name
    bench = Benchmark(name=full, fn=fn, scope=scope, **kwargs)
    # capture the body's source now for the instance fingerprint
    # (repro_torch.core.fingerprint); None when inspect cannot see it
    bench.source, bench.source_file, bench.source_line = _capture_source(fn)
    return reg.register(bench)


def benchmark(name: Optional[str] = None, scope: str = "core",
              registry: Optional[BenchmarkRegistry] = None,
              **kwargs) -> Callable[[BenchmarkFn], Benchmark]:
    """Decorator registration (GB ``BENCHMARK()`` macro analogue).

    Returns the :class:`Benchmark` so callers can chain sweep builders::

        @benchmark(scope="example")
        def axpy(state):
            ...
        axpy.range_multiplier_args(1 << 10, 1 << 20)
    """
    def deco(fn: BenchmarkFn) -> Benchmark:
        bname = name or fn.__name__
        b = register_benchmark(bname, fn, scope=scope, registry=registry,
                               **kwargs)
        b.doc = (fn.__doc__ or "").strip()
        return b
    return deco
