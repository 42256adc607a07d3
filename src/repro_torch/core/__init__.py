"""repro_torch.core — the SCOPE repository analogue (paper §III), on torch.

The same public surface for scope authors as ``repro.core``::

    from repro_torch.core import ParamSpace, Scope, State, benchmark

    def _register(registry):
        @benchmark(scope="myscope", registry=registry)
        def my_bench(state: State):
            x = state.fixture                  # from set_fixture(setup)
            while state.keep_running():
                state.deliver(fn(x))
        my_bench.param_space(dtype=["f32", "bf16"], n=[256, 1024])
        my_bench.set_fixture(lambda params: make_input(params))

    SCOPE = Scope(name="myscope", register=_register)
"""
from .benchmark import (Benchmark, ParamSpace, Params, State, SkipError,
                        Tunable, match_params, parse_param_filter)
from .errorcheck import ScopeError, check_finite, check_shape, checked, sync
from .flags import FLAGS, FlagRegistry
from .hooks import HOOKS, HookChain
from .logging import get_logger
from .measure import (CostModelMeter, CpuTimeMeter, DEFAULT_METERS,
                      LatencyMeter, METERS, Meter, MeterStack, WallClockMeter,
                      parse_meters)
from .baseline import Comparison, compare_documents, save_baseline
from .orchestrate import (InstanceResult, OrchestratorOptions, RunResult,
                          ScopeShard, execute, merge_shards)
from .plan import Plan, PlanItem, build_plan, load_cost_hints
from .registry import (REGISTRY, BenchmarkRegistry, benchmark,
                       register_benchmark)
from .runner import (RunOptions, run_benchmarks, run_single_instance,
                     write_json)
from .scope import BUILTIN_SCOPES, Scope, ScopeManager
from .sysinfo import H100_PCIE, H100_SXM, build_context, target_hardware

__all__ = [
    "Benchmark", "ParamSpace", "Params", "State", "SkipError", "Tunable",
    "match_params", "parse_param_filter",
    "ScopeError", "check_finite", "check_shape", "checked", "sync",
    "FLAGS", "FlagRegistry", "HOOKS", "HookChain", "get_logger",
    "Meter", "MeterStack", "WallClockMeter", "CpuTimeMeter", "LatencyMeter",
    "CostModelMeter", "METERS", "DEFAULT_METERS", "parse_meters",
    "REGISTRY", "BenchmarkRegistry", "benchmark", "register_benchmark",
    "RunOptions", "run_benchmarks", "run_single_instance", "write_json",
    "BUILTIN_SCOPES", "Scope", "ScopeManager",
    "Plan", "PlanItem", "build_plan", "load_cost_hints",
    "InstanceResult", "OrchestratorOptions", "RunResult", "ScopeShard",
    "execute", "merge_shards", "Comparison", "compare_documents",
    "save_baseline",
    "H100_SXM", "H100_PCIE", "build_context", "target_hardware",
]
