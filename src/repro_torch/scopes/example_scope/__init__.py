"""Example|Scope — the template scope (paper §IV-C), ported as it is: it
is numpy-only, so its instance names and record keys equal the JAX
package's.

Demonstrates every required or suggested structure for a new scope:

  1. a ``SCOPE`` export (the CMakeLists.txt/object-library analogue) —
     *required*;
  2. benchmark bodies registered through the core benchmark library —
     *required*;
  3. two new command-line flags (``--example.exit_code`` and
     ``--example.greet``), declared clara::Opts-style — *optional*;
  4. an init hook that makes the binary exit during initialization when
     ``--example.exit_code`` is given (exactly what the paper's
     Example|Scope does) — *optional*;
  5. per-benchmark documentation in docstrings — *optional*;
  6. a typed parameter space with a fixture (``axpy``): a ``dtype``
     axis instead of per-dtype family clones, with array allocation in
     ``setup(params)`` so it never pollutes the timed region —
     *recommended for new benchmarks*;
  7. sync deliverables (``state.deliver(out)``): the body declares its
     output so the measurement layer can fence async dispatch before
     the clock stops (docs/measurement.md) — on a host-numpy scope the
     fence is a no-op, but declaring the deliverable keeps the body
     correct under any backend — *recommended for new benchmarks*.
"""
from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.flags import FlagRegistry
from repro_torch.core.registry import BenchmarkRegistry

import numpy as np

NAME = "example"


def _declare_flags(flags: FlagRegistry) -> None:
    flags.declare(f"{NAME}/exit_code", owner=NAME, type=int, default=None,
                  help="exit immediately with this status (demo of init "
                       "hooks aborting the binary)")
    flags.declare(f"{NAME}/greet", owner=NAME, default=None,
                  help="print a greeting during post-parse init")


def _post_parse():
    code = FLAGS.get(f"{NAME}/exit_code")
    if code is not None:
        return int(code)
    greet = FLAGS.get(f"{NAME}/greet")
    if greet:
        print(f"example scope says: {greet}")
    return None


def _register(registry: BenchmarkRegistry) -> None:
    @benchmark(scope=NAME, registry=registry)
    def noop(state: State):
        """Measures benchmark-harness overhead: an empty timed body."""
        while state.keep_running():
            pass
        state.set_items_processed(1)
    # nothing is dispatched, so there is nothing to fence
    noop.set_sync(lambda ctx: None)

    @benchmark(scope=NAME, registry=registry)
    def saxpy(state: State):
        """Single-precision a*x+y on the host — the classic demo kernel."""
        n = state.range(0)
        x = np.ones(n, np.float32)
        y = np.ones(n, np.float32)
        while state.keep_running():
            y = 2.0 * x + y
        state.set_bytes_processed(3 * 4 * n)
        state.set_items_processed(n)
    saxpy.range_multiplier_args(1 << 8, 1 << 16, mult=4)
    saxpy.set_arg_names(["n"])
    # host numpy is synchronous; declare that instead of leaving the
    # family unfenced
    saxpy.set_sync(lambda ctx: None)

    _DTYPES = {"f32": np.float32, "f64": np.float64}

    def axpy_setup(params):
        dt = _DTYPES[params.dtype]
        return np.ones(params.n, dt), np.ones(params.n, dt)

    @benchmark(scope=NAME, registry=registry)
    def axpy(state: State):
        """Typed-axis a*x+y: ``dtype`` is a named axis (no per-dtype
        family clones), the arrays come from the fixture (untimed), and
        the result is the declared sync deliverable."""
        x, y = state.fixture
        while state.keep_running():
            y = state.deliver(2.0 * x + y)
        itemsize = x.dtype.itemsize
        state.set_bytes_processed(3 * itemsize * state.params.n)
        state.set_items_processed(state.params.n)
    axpy.param_space(ParamSpace.product(dtype=list(_DTYPES), n=[1 << 14]))
    axpy.set_fixture(axpy_setup)


SCOPE = Scope(
    name=NAME,
    version="1.0.0",
    description="Template scope demonstrating the integration surface.",
    register=_register,
    declare_flags=_declare_flags,
    post_parse=_post_parse,
)
