"""Instr|Scope — instruction/op latencies and throughput, on the card.

The port of the JAX package's instr scope: elementwise transcendentals,
a reduction and a dtype conversion at a fixed array size, the per-op
cost floor that model-level numbers decompose into.  One
``elementwise`` family sweeps a typed ``op`` axis; every family builds
its operand on the run's device in a fixture (untimed) and delivers its
output, so the wall meter fences the batch once.  The ops are plain
eager torch (one library kernel a call on the card): ``gelu`` is the
tanh approximation, as ``jax.nn.gelu``'s default is, and ``rsqrt`` is
``torch.rsqrt`` where the reference calls ``lax.rsqrt``.
"""
import torch
import torch.nn.functional as F

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry

NAME = "instr"

_OPS = {
    "exp": torch.exp,
    "tanh": torch.tanh,
    "rsqrt": torch.rsqrt,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "add": lambda x: x + x,
    "mul": lambda x: x * x,
}


def _register(registry: BenchmarkRegistry) -> None:
    def elementwise_setup(params):
        device = torch.device(FLAGS.get("device"))
        x = torch.linspace(0.1, 1.0, params.n, dtype=torch.float32,
                           device=device)
        return _OPS[params.op], x

    @benchmark(scope=NAME, registry=registry)
    def elementwise(state: State):
        """Elementwise op throughput; the ``op`` axis selects the
        primitive."""
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(state.params.n)
        state.set_bytes_processed(8 * state.params.n)
    elementwise.param_space(
        ParamSpace.product(op=list(_OPS), n=[1 << 20]))
    elementwise.set_fixture(elementwise_setup)

    def reduce_sum_setup(params):
        device = torch.device(FLAGS.get("device"))
        return torch.sum, torch.ones((params.n,), dtype=torch.float32,
                                     device=device)

    @benchmark(scope=NAME, registry=registry)
    def reduce_sum(state: State):
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_bytes_processed(4 * state.params.n)
    reduce_sum.args([1 << 20]).set_arg_names(["n"])
    reduce_sum.set_fixture(reduce_sum_setup)

    def convert_setup(params):
        device = torch.device(FLAGS.get("device"))
        return ((lambda x: x.to(torch.bfloat16)),
                torch.ones((params.n,), dtype=torch.float32, device=device))

    @benchmark(scope=NAME, registry=registry)
    def convert_f32_bf16(state: State):
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_bytes_processed(6 * state.params.n)
    convert_f32_bf16.args([1 << 20]).set_arg_names(["n"])
    convert_f32_bf16.set_fixture(convert_setup)


SCOPE = Scope(name=NAME, version="2.0.0",
              description="per-op latencies/throughput", register=_register)
