"""Histo|Scope — GPU histogramming (paper Table IV), on the card.

One ``histogram`` family with a typed ``backend`` axis compares
``torch.bincount`` (the library path, as ``jnp.bincount`` was in the JAX
package) against the hand-written privatised shared-memory kernel of
:mod:`repro_torch.kernels.histogram`, over input sizes and bin counts.
On the card both backends sweep the whole grid; under ``--device cpu``
the ``cuda`` rows are left out, as in the mxu scope.  Inputs come from a
seeded
``torch.Generator`` on the run's device.
"""
import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.kernels.histogram import histogram as cuda_histogram

NAME = "histo"


def _register(registry: BenchmarkRegistry) -> None:
    def histogram_setup(params):
        device = torch.device(FLAGS.get("device"))
        gen = torch.Generator(device).manual_seed(0)
        x = torch.randint(0, params.bins, (params.n,), generator=gen,
                          device=device, dtype=torch.int32)
        bins = params.bins
        if params.backend == "torch":
            return (lambda x: torch.bincount(x, minlength=bins)), x
        return (lambda x: cuda_histogram(x, bins)), x

    @benchmark(scope=NAME, registry=registry)
    def histogram(state: State):
        """Histogramming through the selected backend (library bincount
        vs the shared-memory atomics kernel); the counts are the sync
        deliverable."""
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(state.params.n)

    on_card = FLAGS.get("device") == "cuda"
    histogram.param_space(
        ParamSpace.product(backend=["torch", "cuda"],
                           n=[1 << 16, 1 << 20],
                           bins=[256, 4096])
        .where(lambda p: on_card or p.backend != "cuda"))
    histogram.set_fixture(histogram_setup)


SCOPE = Scope(name=NAME, version="2.0.0",
              description="histogramming: library bincount vs shared-memory "
                          "atomics kernel",
              register=_register)
