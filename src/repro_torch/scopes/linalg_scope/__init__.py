"""LinAlg|Scope — linear-algebra operations (paper Table IV), on torch.

The JAX package's scope with its instance names, operands and counters,
all float32 (jax runs with x64 off):

  * ``batched_matmul`` sweeps a typed ``dtype`` axis (f32 vs bf16)
    through ``torch.einsum("bij,bjk->bik")`` alongside the batch/size
    ints, with TF32 off as in the mxu fixture;
  * ``matmul_rect`` is the rectangular 512×256×256 float32 product
    through the hand-written kernel of :mod:`repro_torch.kernels.matmul`
    (its ``simt`` variant: float32 stays on the CUDA cores).  The family
    has no backend axis, so under ``--device cpu`` it is not registered,
    as the nn scope's card-only families are not: a CPU document never
    holds a row that ran no CUDA kernel;
  * ``cholesky`` (``torch.linalg.cholesky``) and ``triangular_solve``
    (``torch.linalg.solve_triangular``, lower, 16 right-hand sides) stay
    legacy int sweeps.

Every fixture returns ``(fn, *operands)`` on the run's ``--device``; the
bodies deliver the result, so the wall meter synchronizes the card
before the clock stops.  ``matmul_rect`` declares the matmul kernel's
tile space tunable, as the reference does, over the ``simt`` variant's
instantiated tiles (``python -m repro_torch tune linalg/matmul_rect``).
"""
import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.kernels.matmul import matmul as cuda_matmul

NAME = "linalg"

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _device() -> torch.device:
    return torch.device(FLAGS.get("device"))


def _batched_einsum(x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bij,bjk->bik", x, x)


def _solve_lower(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.solve_triangular(a, b, upper=False)


def _register(registry: BenchmarkRegistry) -> None:
    def batched_matmul_setup(params):
        torch.backends.cuda.matmul.allow_tf32 = False
        x = torch.ones((params.b, params.n, params.n),
                       dtype=_DTYPES[params.dtype], device=_device())
        return _batched_einsum, x

    @benchmark(scope=NAME, registry=registry)
    def batched_matmul(state: State):
        """Batched einsum matmul; ``dtype`` selects the accumulation
        input precision."""
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(2 * state.params.b * state.params.n ** 3)
    batched_matmul.param_space(
        ParamSpace.product(dtype=["f32", "bf16"], b=[8], n=[128, 256]))
    batched_matmul.set_fixture(batched_matmul_setup)

    # the family has no backend axis: on the CPU it is not registered,
    # as the nn scope's card-only families are not, so that no family
    # expands to zero instances there
    if FLAGS.get("device") == "cuda":
        def matmul_rect_setup(params):
            x = torch.ones((params.m, params.k), dtype=torch.float32,
                           device=_device())
            y = torch.ones((params.k, params.n), dtype=torch.float32,
                           device=_device())
            return cuda_matmul, x, y

        @benchmark(scope=NAME, registry=registry)
        def matmul_rect(state: State):
            """Rectangular matmul through the hand-written CUDA kernel —
            the non-square shape the MXU scope's square sweep never
            exercises."""
            fn, x, y = state.fixture
            while state.keep_running():
                state.deliver(fn(x, y))
            p = state.params
            state.counters["flops"] = 2.0 * p.m * p.n * p.k
        matmul_rect.param_space(
            ParamSpace.product(m=[512], n=[256], k=[256]))
        matmul_rect.set_fixture(matmul_rect_setup)
        # the float32 product runs matmul's simt variant: its instantiated
        # tiles (the reference searched Pallas blocks up to 512)
        matmul_rect.set_tunable("matmul", bm=[64, 128], bn=[64, 128],
                                bk=[16])

    def cholesky_setup(params):
        a = torch.eye(params.n, device=_device()) * 4.0 + 0.1
        return torch.linalg.cholesky, a

    @benchmark(scope=NAME, registry=registry)
    def cholesky(state: State):
        fn, a = state.fixture
        while state.keep_running():
            state.deliver(fn(a))
        # ~n^3/3 fused multiply-adds for a dense Cholesky factorization
        state.counters["flops"] = state.params.n ** 3 / 3.0
    cholesky.args([256]).args([512]).set_arg_names(["n"])
    cholesky.set_fixture(cholesky_setup)

    def triangular_solve_setup(params):
        n = params.n
        a = torch.eye(n, device=_device()) \
            + torch.tril(torch.ones((n, n), device=_device()) * 0.01)
        b = torch.ones((n, 16), device=_device())
        return _solve_lower, a, b

    @benchmark(scope=NAME, registry=registry)
    def triangular_solve(state: State):
        fn, a, b = state.fixture
        while state.keep_running():
            state.deliver(fn(a, b))
        # n^2 multiply-adds per right-hand side, 16 rhs columns
        state.counters["flops"] = state.params.n ** 2 * 16.0
    triangular_solve.args([256]).set_arg_names(["n"])
    triangular_solve.set_fixture(triangular_solve_setup)


SCOPE = Scope(name=NAME, version="2.0.0",
              description="linear algebra operations", register=_register)
