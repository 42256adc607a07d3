"""MXU|Scope — the paper's TCU|Scope ("Nvidia GPU tensor cores"), back on
an NVIDIA card.

One ``matmul`` family over typed axes, as in the JAX package's scope:
``backend`` (torch: ``torch.matmul`` on cuBLAS, the production path, as
``xla`` was; cuda: the hand-written kernel of
:mod:`repro_torch.kernels.matmul`), ``dtype`` (f32, bf16) and size
``n``.  On the card both backends sweep the whole grid: the reference
pruned its kernel row to one point only because interpret mode is slow.
Under ``--device cpu`` the ``cuda`` rows are left out, so a CPU document
never holds a ``backend:cuda`` record that ran no CUDA kernel.  The
fixture allocates the operands (``ones``, as the reference) and turns
TF32 off, so float32 products are full float32 — the context block
records the switch.  Reports achieved FLOP/s and the modeled roofline
time at the card's bf16 peak.  ``python -m repro_torch tune mxu/matmul``
searches the ``wgmma`` variant's tiles on the bf16 ``cuda`` instance.
"""
import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.sysinfo import target_hardware
from repro_torch.kernels.matmul import matmul as cuda_matmul

NAME = "mxu"

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
_BACKENDS = {"torch": torch.matmul, "cuda": cuda_matmul}


def _peak_bf16_flops(x: torch.Tensor) -> float:
    name = torch.cuda.get_device_name(x.device) if x.is_cuda else None
    return target_hardware(name)["peak_bf16_flops"]


def _register(registry: BenchmarkRegistry) -> None:
    def setup(params):
        torch.backends.cuda.matmul.allow_tf32 = False
        device = torch.device(FLAGS.get("device"))
        dtype = _DTYPES[params.dtype]
        x = torch.ones((params.n, params.n), dtype=dtype, device=device)
        y = torch.ones((params.n, params.n), dtype=dtype, device=device)
        return _BACKENDS[params.backend], x, y

    @benchmark(scope=NAME, registry=registry)
    def matmul(state: State):
        """Square matmul through the selected backend/dtype.  The body
        delivers its product; the wall meter synchronizes the device
        once, before the clock stops."""
        fn, x, y = state.fixture
        while state.keep_running():
            state.deliver(fn(x, y))
        n = state.params.n
        flops = 2.0 * n * n * n
        state.counters["flops_per_call"] = flops
        state.counters["model_roofline_s"] = flops / _peak_bf16_flops(x)
        state.set_items_processed(int(flops))

    on_card = FLAGS.get("device") == "cuda"
    matmul.param_space(
        ParamSpace.product(backend=list(_BACKENDS),
                           dtype=list(_DTYPES),
                           n=[256, 512, 1024])
        .where(lambda p: on_card or p.backend != "cuda"))
    matmul.set_fixture(setup)
    # `python -m repro_torch tune mxu/matmul` searches the wgmma variant's
    # instantiated tiles on the bf16 kernel instance (the reference
    # searched Pallas blocks up to 256 on its pallas instance)
    matmul.set_tunable("matmul", bm=[64, 128], bn=[64, 128], bk=[64],
                       instance={"backend": "cuda", "dtype": "bf16"})


SCOPE = Scope(name=NAME, version="2.0.0",
              description="tensor-core matmul characterization",
              register=_register)
