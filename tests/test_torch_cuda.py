"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA card and ``nvcc``; on a host without
CUDA each one skips.  This file imports neither jax nor the JAX package,
so on a machine with the card it runs without them::

    PYTHONPATH=src python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.histogram import histogram, histogram_ref
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.matmul import bf16_ulp_error, matmul, matmul_ref
from repro_torch.kernels.matmul import ops as matmul_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("m,k,n", [(128, 64, 96), (256, 256, 256),
                                   (64, 128, 64), (1, 1, 1), (65, 17, 129),
                                   (300, 0, 5)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-1)])
def test_matmul_kernel_matches_plain(cuda, m, k, n, dtype, tol):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32) * 0.5)
    y = torch.from_numpy(rng.standard_normal((k, n), np.float32) * 0.5)
    x, y = x.to(cuda, dtype), y.to(cuda, dtype)
    before = matmul_ops.launches
    out = matmul(x, y)
    torch.cuda.synchronize()
    assert matmul_ops.launches == before + 1
    assert out.dtype == dtype and out.shape == (m, n)
    torch.testing.assert_close(out.float(), matmul_ref(x, y).float(),
                               atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        # float32 accumulation, rounded once: a bfloat16 sum fails this
        assert bf16_ulp_error(out, x, y) <= 2.0


@pytest.mark.parametrize("n,bins", [(4096, 64), (8192, 256), (1024, 16),
                                    (1, 1), (100003, 4096), (5000, 40000)])
def test_histogram_kernel_matches_plain(cuda, n, bins):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.integers(-3, bins + 3, n, dtype=np.int32))
    x = x.to(cuda)
    before = histogram_ops.launches
    out = histogram(x, bins)
    torch.cuda.synchronize()
    assert histogram_ops.launches == before + 1
    assert torch.equal(out, histogram_ref(x, bins))


def test_kernels_reject_what_they_cannot_take(cuda):
    x = torch.ones((64, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(x.t(), x)
    with pytest.raises(ValueError, match="shared memory"):
        histogram(torch.zeros(8, dtype=torch.int32, device=cuda),
                  histogram_ops.MAX_BINS + 1)
    with pytest.raises(ValueError, match="operands on"):
        matmul(x, x.cpu())
