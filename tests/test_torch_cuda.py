"""The port's CUDA kernels on the card, against their plain versions,
and the paths that run there: serving and training.

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
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.matmul import bf16_ulp_error, matmul, matmul_ref
from repro_torch.kernels.matmul import ops as matmul_ops
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk, ssd_chunk_ref,
                                          ssd_chunked, ssd_reference)
from repro_torch.kernels.ssd_scan import ops as ssd_ops

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


def _matmul_operands(m, k, n, dtype, device, offset=0):
    """x [m,k] and y [k,n] from a seed; ``offset`` > 0 makes both views
    start that many elements into their storage (a misaligned base)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(m * k + offset, np.float32))
    y = torch.from_numpy(rng.standard_normal(k * n + offset, np.float32))
    x = (x / np.sqrt(max(k, 1))).to(device, dtype)[offset:].view(m, k)
    y = y.to(device, dtype)[offset:].view(k, n)
    return x, y


@pytest.mark.parametrize("m,k,n,offset,want", [
    (200, 72, 136, 0, "wgmma"),      # ragged M, N and K tiles
    (1000, 1536, 776, 0, "wgmma"),
    (128, 8, 8, 0, "wgmma"),         # one K step, 8 columns of a 64 box
    (192, 200, 264, 0, "wgmma"),     # K a multiple of 8, not of 64
    (256, 4096, 256, 0, "wgmma"),    # a long K: the sum stays float32
    (200, 72, 136, 1, "simt"),       # bases 2 bytes past 16: no TMA
    (64, 4096, 48, 0, "wgmma"),
])
def test_matmul_bf16_variants_match_plain(cuda, m, k, n, offset, want):
    x, y = _matmul_operands(m, k, n, torch.bfloat16, cuda, offset)
    assert matmul_ops.variant(m, k, n, x.dtype, x.data_ptr(),
                              y.data_ptr()) == want
    before = dict(matmul_ops.launches_by_variant)
    out = matmul(x, y)
    torch.cuda.synchronize()
    assert matmul_ops.launches_by_variant[want] == before[want] + 1
    torch.testing.assert_close(out.float(), matmul_ref(x, y).float(),
                               atol=2e-1, rtol=2e-1)
    assert bf16_ulp_error(out, x, y) <= 2.0


@pytest.mark.parametrize("m,k,n,offset", [(1000, 4096, 520, 0),
                                          (130, 70, 90, 1)])
def test_matmul_f32_takes_any_operand(cuda, m, k, n, offset):
    x, y = _matmul_operands(m, k, n, torch.float32, cuda, offset)
    before = matmul_ops.launches_by_variant["simt"]
    out = matmul(x, y)
    torch.cuda.synchronize()
    assert matmul_ops.launches_by_variant["simt"] == before + 1
    torch.testing.assert_close(out, matmul_ref(x, y), atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("B,Sq,Sk,H,K,D", [
    (2, 128, 128, 4, 2, 32), (2, 64, 64, 2, 2, 64), (2, 256, 256, 4, 1, 16),
    (1, 100, 100, 4, 2, 128), (2, 37, 70, 4, 4, 64), (1, 70, 37, 2, 1, 32),
    (1, 1, 1, 1, 1, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 4e-2)])
def test_flash_attention_kernel_matches_plain(cuda, B, Sq, Sk, H, K, D,
                                              causal, dtype, tol):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        cuda, dtype) for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    before = flash_ops.launches
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.launches == before + 1
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
        atol=tol, rtol=tol)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", [
    (1, 200, 200, 8, 8, 16, True),      # GQA ratio 1, ragged tiles
    (2, 130, 300, 8, 4, 32, False),     # ratio 2, Sq != Sk
    (1, 333, 129, 8, 2, 64, True),      # ratio 4, causal with Sq > Sk
    (1, 129, 333, 4, 1, 128, True),     # causal with Sq < Sk
    (2, 1000, 1000, 32, 8, 64, True),   # llama3.2-1b's heads, ragged
    (1, 257, 257, 16, 8, 128, False),
])
def test_flash_attention_bf16_wgmma_matches_plain(cuda, B, Sq, Sk, H, K, D,
                                                  causal):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(
        cuda, torch.bfloat16)
        for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    assert flash_ops.variant(q.dtype) == "wgmma"
    before = flash_ops.launches_by_variant["wgmma"]
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.launches_by_variant["wgmma"] == before + 1
    torch.testing.assert_close(
        out.float(), flash_attention_ref(q, k, v, causal=causal).float(),
        atol=4e-2, rtol=4e-2)


def test_flash_attention_bf16_without_keys(cuda):
    """No keys: nothing for TMA to load, so the C entry writes the
    reference's zeros and launches no kernel."""
    q = torch.ones((1, 5, 2, 16), device=cuda, dtype=torch.bfloat16)
    k = torch.ones((1, 0, 1, 16), device=cuda, dtype=torch.bfloat16)
    before = flash_ops.launches
    out = flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert flash_ops.launches == before
    assert torch.equal(out, flash_attention_ref(q, k, k))
    # a view one element in: no load, so no 16-byte rule
    q1 = torch.ones(1 + q.numel(), device=cuda, dtype=q.dtype)[1:]
    assert torch.equal(flash_attention(q1.view(q.shape), k, k),
                       flash_attention_ref(q, k, k))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, None)])
def test_flash_attention_misaligned_operands(cuda, dtype, tol):
    """bf16 goes through TMA, which needs 16-byte bases: a view that
    starts one element in is refused.  The float32 body takes it."""
    rng = np.random.default_rng(2)
    shape = (1, 70, 4, 32)
    n = int(np.prod(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(n + 1, np.float32)).to(
        cuda, dtype)[1:].view(shape) for _ in range(3))
    if tol is None:
        with pytest.raises(ValueError, match="16 bytes"):
            flash_attention(q, k, v)
        return
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, flash_attention_ref(q, k, v),
                               atol=tol, rtol=tol)


def _flash_operands(B, S, H, K, D, device, scale=1.0, seed=3):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32)
                                  * np.float32(scale)).to(device)
                 for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))


@pytest.mark.parametrize("scale", [1.0, 4.0])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_f32_long_sequence(cuda, D, causal, scale):
    """float32 at 4096 tokens goes through the ffma body and holds the
    reference's 2e-5, also with inputs x4 (scores of tens)."""
    q, k, v = _flash_operands(1, 4096, 4, 2, D, cuda, scale)
    assert flash_ops.variant(q.dtype) == "ffma"
    before = flash_ops.launches_by_variant["ffma"]
    out = flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_ops.launches_by_variant["ffma"] == before + 1
    torch.testing.assert_close(out, flash_attention_ref(q, k, v,
                                                        causal=causal),
                               atol=2e-5, rtol=2e-5)


def test_flash_attention_f32_without_keys(cuda):
    """No keys: the float32 call writes the reference's zeros from the
    ffma C entry and launches no kernel."""
    q = torch.ones((1, 5, 2, 16), device=cuda)
    k = torch.ones((1, 0, 1, 16), device=cuda)
    assert flash_ops.variant(q.dtype) == "ffma"
    before = dict(flash_ops.launches_by_variant)
    out = flash_attention(q, k, k)
    torch.cuda.synchronize()
    assert flash_ops.launches_by_variant == before
    assert torch.equal(out, flash_attention_ref(q, k, k))


def _histogram_holds(x, bins):
    before = histogram_ops.launches
    out = histogram(x, bins)
    torch.cuda.synchronize()
    assert histogram_ops.launches == before + 1
    assert torch.equal(out, histogram_ref(x, bins))


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("n", [7, 1000, (1 << 20) + 5])
def test_histogram_misaligned_view(cuda, offset, n):
    """A view that starts 4, 8 or 12 bytes past 16: scalar head, int4
    body, scalar tail."""
    rng = np.random.default_rng(offset)
    x = torch.from_numpy(rng.integers(0, 4096, n + offset, dtype=np.int32))
    _histogram_holds(x.to(cuda)[offset:], 4096)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 7])
def test_histogram_tiny_inputs(cuda, n):
    x = torch.arange(n + 1, dtype=torch.int32, device=cuda) % 3
    _histogram_holds(x[:n], 4)
    _histogram_holds(x[1:], 4)


def test_histogram_one_hot_bin(cuda):
    """Every value in one bin: the shared atomics' worst contention."""
    _histogram_holds(torch.full((1 << 20,), 77, dtype=torch.int32,
                                device=cuda), 4096)


def test_histogram_max_bins(cuda):
    rng = np.random.default_rng(5)
    bins = histogram_ops.MAX_BINS
    x = torch.from_numpy(rng.integers(0, bins, 300001, dtype=np.int32))
    _histogram_holds(x.to(cuda), bins)


def test_histogram_out_of_range(cuda):
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1, 1 << 20,
                                      dtype=np.int64).astype(np.int32))
    x[::3] = torch.from_numpy(rng.integers(-5, 261, x[::3].numel(),
                                           dtype=np.int32))
    _histogram_holds(x.to(cuda), 256)


@pytest.mark.parametrize("delta", [-1, 0, 1, 5])
def test_histogram_around_one_cluster(cuda, delta):
    """n just below, at and above one cluster's worth of values (the
    grid goes from one cluster to two)."""
    n = histogram_ops.THREADS * histogram_ops.ITEMS_PER_THREAD \
        * histogram_ops.CLUSTER + delta
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-3, 4099, n, dtype=np.int32))
    _histogram_holds(x.to(cuda), 4096)


@pytest.mark.parametrize("rows,d", [(64, 128), (256, 512), (32, 1024),
                                    (4096, 1024), (7, 1000), (3, 8192)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_kernel_matches_plain(cuda, rows, d, dtype, tol):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((rows, d), np.float32))
    s = torch.from_numpy(rng.standard_normal(d, np.float32) + 1.0)
    x, s = x.to(cuda, dtype), s.to(cuda)
    before = rmsnorm_ops.launches
    out = rmsnorm(x, s)
    torch.cuda.synchronize()
    assert rmsnorm_ops.launches == before + 1
    assert out.dtype == dtype
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


def _ssd_operands(b, l, h, p, n, device, dt_scale=1.0):
    rng = np.random.default_rng(0)
    f = lambda a: torch.from_numpy(a.astype(np.float32)).to(device)  # noqa: E731
    x = f(rng.standard_normal((b, l, h, p)) * 0.4)
    dt = f(np.log1p(np.exp(rng.standard_normal((b, l, h)))) * dt_scale)
    A = f(-np.exp(rng.standard_normal(h) * 0.3))
    Bm = f(rng.standard_normal((b, l, 1, n)) * 0.3)
    Cm = f(rng.standard_normal((b, l, 1, n)) * 0.3)
    return x, dt, A, Bm, Cm, f(np.ones(h))


def _ssd_chunk_holds(x, dt, A, Bm, Cm, chunk):
    """One launch, through the variant ``ops.variant`` names, within
    3e-5 of the plain version on all three outputs, all finite."""
    b, l, h, p = x.shape
    which = ssd_ops.variant(min(chunk, l), p, Bm.shape[-1])
    before = ssd_ops.launches
    before_variant = ssd_ops.launches_by_variant[which]
    got = ssd_chunk(x, dt, A, Bm[:, :, 0], Cm[:, :, 0], chunk=chunk)
    torch.cuda.synchronize()
    assert ssd_ops.launches == before + 1
    assert ssd_ops.launches_by_variant[which] == before_variant + 1
    want = ssd_chunk_ref(x, dt, A, Bm[:, :, 0], Cm[:, :, 0], chunk=chunk)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, w, atol=3e-5, rtol=3e-5)


def _sms(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


@pytest.mark.parametrize("b,l,h,p,n,chunk", [
    (2, 32, 2, 8, 16, 8), (2, 64, 3, 8, 16, 16), (2, 128, 1, 8, 16, 32),
    (2, 1024, 4, 64, 64, 128), (1, 256, 2, 64, 128, 128),
    (1, 96, 2, 24, 40, 96)])
def test_ssd_kernel_matches_plain(cuda, b, l, h, p, n, chunk):
    x, dt, A, Bm, Cm, D = _ssd_operands(b, l, h, p, n, cuda)
    _ssd_chunk_holds(x, dt, A, Bm, Cm, chunk)
    y, s = ssd(x, dt, A, Bm, Cm, D, chunk=chunk)
    yr, sr = ssd_reference(x, dt, A, Bm, Cm, D)
    torch.testing.assert_close(y, yr, atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(s, sr, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("b,l,h,p,n", [
    (8, 512, 48, 64, 128),    # mamba2-780m's SSD widths, a short sequence
    (4, 4096, 5, 64, 64)])    # a head count the group does not divide
def test_ssd_kernel_head_groups(cuda, b, l, h, p, n):
    """Blocks that take several heads and share their C·Bᵀ (on an H100:
    G = 4 and G = 2, the second with a last group of one head)."""
    G = ssd_ops.head_group(b, l // 128, h, _sms(cuda))
    assert G > 1
    if h == 5:
        assert h % G
    x, dt, A, Bm, Cm, D = _ssd_operands(b, l, h, p, n, cuda)
    _ssd_chunk_holds(x, dt, A, Bm, Cm, 128)
    y, s = ssd(x, dt, A, Bm, Cm, D, chunk=128)
    yr, sr = ssd_reference(x, dt, A, Bm, Cm, D)
    torch.testing.assert_close(y, yr, atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(s, sr, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("b,l,h,p,n", [(2, 1024, 4, 64, 64),
                                       (8, 512, 48, 64, 128)])
def test_ssd_kernel_large_decay(cuda, b, l, h, p, n):
    """dt x8: in-chunk cumsums of hundreds, where an exponent taken above
    the diagonal overflows.  The kernel holds its plain version; ``ssd``
    holds the plain chunked formulation on the same card.  Both chunked
    forms sit off the sequential recurrence in y by more than 3e-5 here (their
    exponent differences of cumsums near -800 round at 6e-5;
    ``chip_smoke.py`` logs by how much)."""
    x, dt, A, Bm, Cm, D = _ssd_operands(b, l, h, p, n, cuda, dt_scale=8.0)
    _ssd_chunk_holds(x, dt, A, Bm, Cm, 128)
    y, s = ssd(x, dt, A, Bm, Cm, D, chunk=128)
    yr, sr = ssd_chunked(x, dt, A, Bm, Cm, D, chunk=128)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    torch.testing.assert_close(y, yr, atol=3e-5, rtol=3e-5)
    torch.testing.assert_close(s, sr, atol=3e-5, rtol=3e-5)


@pytest.mark.parametrize("p,n", [(8, 0), (0, 16), (7, 13)])
def test_ssd_kernel_empty_and_odd_widths(cuda, p, n):
    """No state or no head width still gives exp(cs) (and zeros for y);
    odd widths take the 4-byte copies."""
    x, dt, A, Bm, Cm, D = _ssd_operands(1, 64, 3, p, n, cuda)
    _ssd_chunk_holds(x, dt, A, Bm, Cm, 32)


def test_kernels_reject_what_they_cannot_take(cuda):
    x = torch.ones((64, 64), device=cuda)
    q = torch.ones((1, 8, 2, 48), device=cuda)
    with pytest.raises(ValueError, match="head size"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="contiguous"):
        rmsnorm(x.t(), torch.ones(64, device=cuda))
    big = _ssd_operands(1, 512, 1, 64, 128, cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ssd_chunk(big[0], big[1], big[2], big[3][:, :, 0], big[4][:, :, 0],
                  chunk=512)
    with pytest.raises(ValueError, match="contiguous"):
        matmul(x.t(), x)
    with pytest.raises(ValueError, match="shared memory"):
        histogram(torch.zeros(8, dtype=torch.int32, device=cuda),
                  histogram_ops.MAX_BINS + 1)
    with pytest.raises(ValueError, match="operands on"):
        matmul(x, x.cpu())


# -- the linalg scope, the cost meter and the orchestrator on the card -------

def test_matmul_rect_matches_plain(cuda):
    """The linalg scope's ``matmul_rect`` point, 512×256×256 float32,
    through the kernel's ``simt`` variant, to the reference's 1e-4."""
    x, y = _matmul_operands(512, 256, 256, torch.float32, cuda)
    before = dict(matmul_ops.launches_by_variant)
    out = matmul(x, y)
    torch.cuda.synchronize()
    assert matmul_ops.launches_by_variant["simt"] == before["simt"] + 1
    torch.testing.assert_close(out, matmul_ref(x, y), atol=1e-4, rtol=1e-4)


def test_cost_meter_counts_a_kernel_row(cuda):
    """``--meters costmodel`` on a ``cuda`` matmul row: the analysis
    call launches the kernel once and counts 2·m·n·k from the custom
    op's formula; the operands and result are the bytes."""
    from repro_torch.core.benchmark import Params, State
    from repro_torch.core.measure import CostModelMeter
    x, y = _matmul_operands(512, 256, 256, torch.float32, cuda)
    st = State(params=Params({"m": 512}), fixture=(matmul, x, y))
    before = matmul_ops.launches
    meter = CostModelMeter()
    meter.prepare(st)
    assert matmul_ops.launches == before + 1
    got = meter.end(st)
    assert got["flops"] == 2.0 * 512 * 256 * 256
    assert got["bytes_accessed"] == 4.0 * (512 * 256 + 256 * 256
                                           + 512 * 256)


def test_linalg_pool_run_on_the_card(cuda, tmp_path):
    """``--jobs 2 --isolate pool`` over the linalg scope: two workers
    share the card, and every record, ``matmul_rect`` included, is
    free of errors."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(root, "src"),
                      os.environ.get("PYTHONPATH")])))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--enable-scope",
         "linalg", "--jobs", "2", "--isolate", "pool", "--results-dir",
         str(tmp_path), "--run-id", "card", "--benchmark_min_time", "0.02"],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads((tmp_path / "card" / "merged.json").read_text())
    names = [rec["name"] for rec in doc["benchmarks"]]
    assert "linalg/matmul_rect/m:512/n:256/k:256" in names
    assert not [rec for rec in doc["benchmarks"]
                if rec.get("error_occurred")]
    assert doc["context"]["backend"] == "cuda"


# -- every instantiated tile of every tuned variant ---------------------------

def _tiles(table):
    """Every tile of a variant's instantiated set, as knob dicts."""
    import itertools
    knobs = sorted(table)
    return [dict(zip(knobs, values))
            for values in itertools.product(*(table[k] for k in knobs))]


def _tile_id(tile):
    return "-".join(f"{k}{v}" for k, v in sorted(tile.items()))


@pytest.mark.parametrize("tile", _tiles(matmul_ops.TILES["wgmma"]),
                         ids=_tile_id)
@pytest.mark.parametrize("m,k,n", [(256, 4096, 256), (200, 72, 136),
                                   (1000, 1536, 776)])
def test_matmul_wgmma_every_tile(cuda, tile, m, k, n):
    """Each wgmma tile (one or two consumer warpgroups, one or two y
    boxes a stage) holds 2e-1 and 2 bf16 ulps; K = 4096 checks that the
    per-stage float32 fold holds for every tile."""
    x, y = _matmul_operands(m, k, n, torch.bfloat16, cuda)
    before = matmul_ops.launches_by_variant["wgmma"]
    out = matmul(x, y, **tile)
    torch.cuda.synchronize()
    assert matmul_ops.launches_by_variant["wgmma"] == before + 1
    torch.testing.assert_close(out.float(), matmul_ref(x, y).float(),
                               atol=2e-1, rtol=2e-1)
    assert bf16_ulp_error(out, x, y) <= 2.0


@pytest.mark.parametrize("tile", _tiles(matmul_ops.TILES["simt"]),
                         ids=_tile_id)
@pytest.mark.parametrize("m,k,n,dtype,offset", [
    (130, 70, 90, torch.float32, 0), (1000, 777, 1536, torch.float32, 0),
    (512, 256, 256, torch.float32, 0), (65, 17, 129, torch.bfloat16, 0),
    (200, 72, 136, torch.bfloat16, 1)])
def test_matmul_simt_every_tile(cuda, tile, m, k, n, dtype, offset):
    """Each simt tile on ragged M and N (float32 to 1e-4, bf16 through
    odd widths or a misaligned base to 2e-1 and 2 ulps)."""
    x, y = _matmul_operands(m, k, n, dtype, cuda, offset)
    assert matmul_ops.variant(m, k, n, dtype, x.data_ptr(),
                              y.data_ptr()) == "simt"
    before = matmul_ops.launches_by_variant["simt"]
    out = matmul(x, y, **tile)
    torch.cuda.synchronize()
    assert matmul_ops.launches_by_variant["simt"] == before + 1
    tol = 1e-4 if dtype == torch.float32 else 2e-1
    torch.testing.assert_close(out.float(), matmul_ref(x, y).float(),
                               atol=tol, rtol=tol)
    if dtype == torch.bfloat16:
        assert bf16_ulp_error(out, x, y) <= 2.0


@pytest.mark.parametrize("tile", _tiles(flash_ops.TILES["ffma"]),
                         ids=_tile_id)
@pytest.mark.parametrize("B,Sq,Sk,H,K,D,causal", [
    (2, 130, 300, 8, 4, 16, False), (1, 333, 129, 8, 2, 32, True),
    (2, 1024, 1024, 4, 2, 64, True), (1, 129, 333, 4, 1, 128, True),
    (2, 1000, 1000, 4, 2, 64, False)])
def test_flash_attention_ffma_every_tile(cuda, tile, B, Sq, Sk, H, K, D,
                                         causal):
    """Each ffma tile at every head size, ragged and at the nn scope's
    largest shape, to 2e-5, also with inputs x4 (scores of tens)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda)
               for s in ((B, Sq, H, D), (B, Sk, K, D), (B, Sk, K, D)))
    for scale in (1.0, 4.0):
        qs, ks, vs = q * scale, k * scale, v * scale
        before = flash_ops.launches_by_variant["ffma"]
        out = flash_attention(qs, ks, vs, causal=causal, **tile)
        torch.cuda.synchronize()
        assert flash_ops.launches_by_variant["ffma"] == before + 1
        torch.testing.assert_close(
            out, flash_attention_ref(qs, ks, vs, causal=causal),
            atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("br", rmsnorm_ops.TILES[rmsnorm_ops.VARIANT]["br"])
@pytest.mark.parametrize("rows,d", [(7, 1000), (4096, 1024), (13, 8192),
                                    (1, 64)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_rmsnorm_every_rows_a_block(cuda, br, rows, d, dtype, tol):
    """Each rows-a-block count, with row counts it does not divide."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((rows, d), np.float32))
    s = torch.from_numpy(rng.standard_normal(d, np.float32) + 1.0)
    x, s = x.to(cuda, dtype), s.to(cuda)
    before = rmsnorm_ops.launches
    out = rmsnorm(x, s, br=br)
    torch.cuda.synchronize()
    assert rmsnorm_ops.launches == before + 1
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, s).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("chunk", ssd_ops.TILES["tiled_n64"]["chunk"])
@pytest.mark.parametrize("b,l,h,p,n", [
    (2, 1024, 4, 64, 64), (2, 4096, 4, 64, 64),   # the nn scope's rows
    (1, 4096, 48, 64, 128)])                      # mamba2-780m's SSD layer
def test_ssd_every_tuned_chunk(cuda, chunk, b, l, h, p, n, monkeypatch):
    """Each chunk a tune may choose, taken through the tuning registry
    (the env knob), holds the plain version and the sequential
    recurrence to 3e-5."""
    from repro_torch.kernels import tuning
    assert chunk in ssd_ops.TILES[ssd_ops.state_variant(n)]["chunk"]
    monkeypatch.setenv("REPRO_TUNED_SSD_SCAN_CHUNK", str(chunk))
    tuning.invalidate_cache()
    try:
        x, dt, A, Bm, Cm, D = _ssd_operands(b, l, h, p, n, cuda)
        _ssd_chunk_holds(x, dt, A, Bm, Cm, chunk)
        got = ssd_chunk(x, dt, A, Bm[:, :, 0], Cm[:, :, 0])   # resolved
        assert got[1].shape[1] == l // chunk
        y, s = ssd(x, dt, A, Bm, Cm, D)
        yr, sr = ssd_reference(x, dt, A, Bm, Cm, D)
        torch.testing.assert_close(y, yr, atol=3e-5, rtol=3e-5)
        torch.testing.assert_close(s, sr, atol=3e-5, rtol=3e-5)
    finally:
        monkeypatch.delenv("REPRO_TUNED_SSD_SCAN_CHUNK")
        tuning.invalidate_cache()


def test_c_entries_refuse_tiles_outside_their_set(cuda):
    """A tile the source has no instantiation for is refused by the C
    entry (cudaErrorInvalidValue, nothing launched) and, before that,
    by the wrapper, on the card as on the CPU."""
    import ctypes
    from repro_torch.kernels import _build
    invalid = 1   # cudaErrorInvalidValue
    stream = torch.cuda.current_stream().cuda_stream
    x = torch.ones((64, 64), device=cuda)
    out = torch.empty_like(x)
    mlib = _build.load("matmul", matmul_ops._SIGNATURES)
    for sym, tile in (("matmul_f32", (96, 64, 16)),
                      ("matmul_f32", (128, 128, 64)),
                      ("matmul_bf16_wgmma", (128, 128, 16)),
                      ("matmul_bf16_wgmma", (256, 128, 64))):
        xb = x if sym == "matmul_f32" else x.bfloat16()
        ob = out if sym == "matmul_f32" else out.bfloat16()
        assert getattr(mlib, sym)(xb.data_ptr(), xb.data_ptr(),
                                  ob.data_ptr(), 64, 64, 64, *tile,
                                  stream) == invalid, (sym, tile)
    assert mlib.matmul_smem_bytes(1, 96, 128, 64) == -1
    q = torch.ones((1, 64, 2, 64), device=cuda)
    part = torch.empty(flash_ops.FFMA_SPLITS * 64 * 2 * 66, device=cuda)
    flib = _build.load("flash_attention", flash_ops._SIGNATURES)
    assert flib.flash_attention_f32_ffma(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(),
        part.data_ptr(), 1, 64, 64, 2, 2, 64, 1, 0.125, 32, 64,
        stream) == invalid
    rlib = _build.load("rmsnorm", rmsnorm_ops._SIGNATURES)
    assert rlib.rmsnorm_f32(x.data_ptr(), x.data_ptr(), out.data_ptr(), 64,
                            64, ctypes.c_float(1e-6), 3, stream) == invalid
    torch.cuda.synchronize()
    before = (matmul_ops.launches, flash_ops.launches, rmsnorm_ops.launches)
    with pytest.raises(ValueError, match="bm=96"):
        matmul(x, x, bm=96)
    with pytest.raises(ValueError, match="bq=32"):
        flash_attention(q, q, q, bq=32)
    with pytest.raises(ValueError, match="br=3"):
        rmsnorm(x, torch.ones(64, device=cuda), br=3)
    assert before == (matmul_ops.launches, flash_ops.launches,
                      rmsnorm_ops.launches)


def _tree_state(root):
    """Every file under ``src/`` with its size and mtime, and the git
    status of ``src/`` where the checkout has git."""
    import os
    import subprocess
    files = sorted((os.path.join(d, f), os.path.getsize(os.path.join(d, f)),
                    os.path.getmtime(os.path.join(d, f)))
                   for d, _, fs in os.walk(os.path.join(root, "src"))
                   if "__pycache__" not in d for f in fs)
    status = None
    if os.path.isdir(os.path.join(root, ".git")):
        status = subprocess.run(["git", "status", "--porcelain", "--", "src"],
                                capture_output=True, text=True,
                                cwd=root).stdout
    return files, status


def test_tune_on_the_card_leaves_the_tree_clean(cuda, tmp_path):
    """``python -m repro_torch tune nn/rmsnorm`` on the card with its
    artifact directory and results outside the checkout: the artifact
    holds the card's name and the variant, and the source tree is as it
    was (``git status --porcelain`` prints nothing new)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = _tree_state(root)
    env = dict(os.environ, REPRO_TUNED_DIR=str(tmp_path / "tuned"),
               PYTHONPATH=os.pathsep.join(
                   filter(None, [os.path.join(root, "src"),
                                 os.environ.get("PYTHONPATH")])))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "tune", "nn/rmsnorm",
         "--budget", "2", "--benchmark_min_time", "0.01", "--no-report",
         "--results-dir", str(tmp_path / "results"), "--run-id", "card"],
        capture_output=True, text=True, env=env, cwd=root, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    artifact = json.loads((tmp_path / "tuned" / "rmsnorm" /
                           "tuned.json").read_text())
    entry = artifact["devices"][torch.cuda.get_device_name(0)]["rows"]
    assert entry["config"]["br"] in rmsnorm_ops.TILES["rows"]["br"]
    summary = json.loads((tmp_path / "results" / "card" /
                          "tune.json").read_text())
    assert summary["baseline"]["params"] == {"br": 1}
    assert _tree_state(root) == before


# -- the model-free scopes and the incremental loop on the card ---------------

def test_comm_scope_all_reduces_on_nccl(cuda, tmp_path):
    """``all_reduce_measured`` under ``--device cuda``: a one-rank NCCL
    group in the worker, every record free of errors, ``devices`` 1."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [os.path.join(root, "src"),
                      os.environ.get("PYTHONPATH")])))
    code = (
        "import json, sys\n"
        "import torch.distributed as dist\n"
        "from repro_torch.core.main import main\n"
        "rc = main(['run', '--enable-scope', 'comm', '--benchmark_filter',"
        " 'comm/all_reduce', '--benchmark_min_time', '0.01',"
        " '--results-dir', '', '--benchmark_out', sys.argv[1]])\n"
        "print(json.dumps({'rc': rc, 'backend': dist.get_backend()}))\n")
    out = tmp_path / "comm.json"
    r = subprocess.run([sys.executable, "-c", code, str(out)],
                       capture_output=True, text=True, env=env, cwd=root,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {"rc": 0, "backend": "nccl"}
    records = json.loads(out.read_text())["benchmarks"]
    assert len(records) == 3
    assert all(not rec.get("error_occurred") and rec["devices"] == 1
               for rec in records), records


def test_checkpoint_round_trip_of_a_cuda_bf16_tree(cuda, tmp_path):
    """A CUDA tree is written from the host and restored as host
    tensors with the same bits (bfloat16 compared as its payload)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    gen = torch.Generator(cuda).manual_seed(0)
    tree = {"w": torch.randn((64, 33), generator=gen, device=cuda,
                             dtype=torch.bfloat16),
            "b": [torch.randn((7,), generator=gen, device=cuda),
                  torch.tensor(3, dtype=torch.int32, device=cuda)]}
    path = save_checkpoint(str(tmp_path / "ck"), tree, step=2)
    out, step = load_checkpoint(path, tree)
    assert step == 2
    assert out["w"].device.type == "cpu" and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].view(torch.int16),
                       tree["w"].cpu().view(torch.int16))
    assert torch.equal(out["b"][0], tree["b"][0].cpu())
    assert out["b"][1].item() == 3


def test_fingerprint_reads_the_cards_artifact(cuda, tmp_path, monkeypatch):
    """A tuned artifact entry under this card's name moves the mxu
    fingerprint of a card run; an entry for another card does not."""
    from repro_torch.core import fingerprint as fp
    from repro_torch.core.flags import FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.scope import ScopeManager
    from repro_torch.kernels import tuning
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(["repro_torch.scopes.mxu_scope"])
    mgr.register_all()
    bench = mgr.registry.all()[0]
    card = torch.cuda.get_device_name(0)
    assert fp.artifact_device("cuda") == card
    monkeypatch.setenv(tuning.DIR_ENV, str(tmp_path))
    tuning.invalidate_cache()
    path = str(tmp_path / "matmul" / "tuned.json")
    try:
        base = fp.family_digest(bench, "cuda")
        other = "NVIDIA H100 PCIe" if "PCIe" not in card \
            else "NVIDIA H100 80GB HBM3"
        tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 64,
                                                 "bk": 64}},
                           device=other, variant="wgmma", path=path)
        assert fp.family_digest(bench, "cuda") == base
        tuning.write_tuned("matmul", {"config": {"bm": 64, "bn": 64,
                                                 "bk": 64}},
                           device=card, variant="wgmma", path=path)
        assert fp.family_digest(bench, "cuda") != base
        assert fp.family_digest(bench, "cpu") == \
            fp.family_digest(bench, "cpu")
    finally:
        monkeypatch.delenv(tuning.DIR_ENV)
        tuning.invalidate_cache()


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-780m"])
def test_reduced_model_on_the_card_matches_the_cpu(cuda, arch):
    """A reduced float32 model on the card against the port's CPU run on
    the same weights and tokens: the loss within 1e-4, the logits within
    5e-3 (chip_smoke.py's full-width tolerances)."""
    from repro_torch.models import build, get_config
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.fail("float32 products must not run in TF32 here")
    cfg = get_config(arch).reduced().override(dtype="float32")
    api = build(cfg)
    params = api.init(torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(1))
    with torch.inference_mode():
        card_logits = api.logits(params, {"tokens": tokens.to(cuda)})[0]
        card_loss = api.loss(params, {"tokens": tokens.to(cuda)})[0]
        cpu_params = _to(params, "cpu")
        cpu_logits = api.logits(cpu_params, {"tokens": tokens})[0]
        cpu_loss = api.loss(cpu_params, {"tokens": tokens})[0]
    assert card_logits.device.type == "cuda"
    assert abs(float(card_loss) - float(cpu_loss)) <= 1e-4
    assert (card_logits.cpu() - cpu_logits).abs().max().item() <= 5e-3


def _greedy(api, params, prompt, n_tokens, device, cache_dtype):
    """Per-request generation: prefill, then uniform decode steps."""
    toks = torch.tensor(np.asarray(prompt)[None], dtype=torch.int32,
                        device=device)
    with torch.inference_mode():
        cache = api.init_cache(1, 128, cache_dtype, device=device)
        logits, cache = api.prefill(params, {"tokens": toks}, cache)
        out = [int(logits[0, -1].argmax())]
        for _ in range(n_tokens - 1):
            logits, cache = api.decode_step(
                params, torch.tensor([[out[-1]]], dtype=torch.int32,
                                     device=device), cache)
            out.append(int(logits[0, 0].argmax()))
    return out


def _small_llama(device, dtype):
    from repro_torch.models import build, get_config
    cfg = get_config("llama3.2-1b").reduced().override(
        num_layers=2, vocab_size=128, dtype=dtype)
    api = build(cfg)
    return api, api.init(torch.Generator(device=device).manual_seed(0))


def test_serve_engine_float32_tokens_on_the_card(cuda):
    """The engine on the card in float32 (a float32 cache): each
    request's greedy tokens equal its own prefill plus uniform decode
    steps, with mixed prompt lengths through two slots."""
    from repro_torch.serve import ServeConfig, ServeEngine
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.fail("float32 products must not run in TF32 here")
    api, params = _small_llama(cuda, "float32")
    prompts = [np.arange(1, 6), np.arange(20, 34), np.arange(3, 12)]
    refs = [_greedy(api, params, p, 6, cuda, torch.float32) for p in prompts]
    eng = ServeEngine(api, params, ServeConfig(
        max_batch=2, max_len=128, prompt_buckets=(16,),
        cache_dtype=torch.float32))
    assert eng.cache["k"].device.type == cuda.type
    reqs = [eng.submit(p, max_tokens=6) for p in prompts]
    eng.run()
    assert [r.output for r in reqs] == refs


class _SlowPrefillApi:
    """A ModelApi whose prefill queues a long chain of device work that
    the logits depend on, without changing them (a factor 1 + ~1e-34 is
    1 in float32): TTFT-visible device time."""

    def __init__(self, api, chain=48, dim=2048):
        self._api = api
        self.cfg = api.cfg
        self._chain = chain
        self._dim = dim

    def init_cache(self, *a, **k):
        return self._api.init_cache(*a, **k)

    def prefill(self, params, batch, cache, logit_pos=None):
        logits, cache = self._api.prefill(params, batch, cache,
                                          logit_pos=logit_pos)
        x = torch.full((self._dim, self._dim), 0.5, device=logits.device)
        for _ in range(self._chain):
            x = torch.sin(x @ x)                   # bounded: never inf/NaN
        return logits * (1.0 + x.mean() * 1e-34), cache


def test_fenced_ttft_not_below_unfenced_on_the_card(cuda):
    """On the card launches return before the device computes: without
    the fence ``first_token_at`` is stamped at enqueue, with it after
    the logits are computed, so on a slow prefill the fenced TTFT is the
    larger (the reference's test; on the CPU the two are equal)."""
    from repro_torch.serve import ServeConfig, ServeEngine
    api, params = _small_llama(cuda, "bfloat16")
    eng = ServeEngine(_SlowPrefillApi(api), params, ServeConfig(
        max_batch=1, max_len=128, prompt_buckets=(16,)))
    prompt = np.arange(1, 11)
    eng.submit(prompt, max_tokens=2)
    eng.run()                                      # warm

    def ttft(fenced):
        eng.cfg.fence_timestamps = fenced
        req = eng.submit(prompt, max_tokens=2)
        eng.run()
        return req.first_token_at - req.submitted_at

    unfenced = min(ttft(False) for _ in range(3))
    fenced = min(ttft(True) for _ in range(3))
    assert fenced >= unfenced


# -- training on the card (the train phase's checks (b)-(d)) ------------

def _train_batches(cfg, n, batch=2, seq=64, seed=0):
    from repro_torch.data import DataConfig, SyntheticLM
    src = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                 global_batch=batch, seed=seed))
    return [{k: torch.from_numpy(v) for k, v in src.batch(i).items()}
            for i in range(n)]


def _copy_to(t, device):
    from repro_torch.models import tree
    return tree.map(lambda x: x.to(device, copy=True), t)


@pytest.mark.parametrize("arch,kw", [("llama3.2-1b", {"num_layers": 2}),
                                     ("mamba2-780m", {}),
                                     ("deepseek-moe-16b", {})])
def test_train_steps_on_the_card_match_the_cpu(cuda, arch, kw):
    """Three float32 steps from one state on the same batches: the loss
    within 1e-4 and grad_norm relative 1e-4 of the CPU's."""
    from repro_torch.models import build, get_config
    from repro_torch.train import AdamWConfig, make_init_fn, make_train_step
    if torch.backends.cuda.matmul.allow_tf32:
        pytest.fail("float32 products must not run in TF32 here")
    cfg = get_config(arch).reduced().override(dtype="float32", **kw)
    api = build(cfg)
    opt = AdamWConfig(lr=1e-3, total_steps=20, warmup_steps=2)
    state = make_init_fn(api, opt)(torch.Generator().manual_seed(0))
    step = make_train_step(api, opt)
    runs = {}
    for device in (cuda, torch.device("cpu")):
        st, runs[device.type] = _copy_to(state, device), []
        for b in _train_batches(cfg, 3):
            st, m = step(st, _copy_to(b, device))
            runs[device.type].append((float(m["loss"]),
                                      float(m["grad_norm"])))
    for (lc, nc), (lh, nh) in zip(runs["cuda"], runs["cpu"]):
        assert abs(lc - lh) <= 1e-4
        assert abs(nc - nh) <= 1e-4 * nh


def test_remat_gradients_agree_on_the_card(cuda):
    from repro_torch.models import build, get_config, tree
    from repro_torch.train.step import _grad_fn
    cfg = get_config("llama3.2-1b").reduced().override(dtype="float32")
    params = build(cfg).init(torch.Generator(device=cuda).manual_seed(1))
    batch = _copy_to(_train_batches(cfg, 1, seq=128)[0], cuda)
    grads = {m: _grad_fn(build(cfg.override(remat=m)))(params, batch)[1]
             for m in ("none", "full", "dots")}
    for m in ("full", "dots"):
        for (_, a), (_, b) in zip(tree.leaves(grads[m]),
                                  tree.leaves(grads["none"])):
            assert float((a - b).abs().max()) <= 1e-6, m


def test_resume_on_the_card(cuda, tmp_path):
    """Halted at step 7 of 14 and resumed through the manager: the last
    loss within the reference test's 2e-3 of the uninterrupted run's."""
    from repro_torch.launch.train import train
    kw = dict(steps=14, global_batch=2, seq_len=32, lr=1e-3, seed=5,
              log_every=100, device="cuda")
    full = train("llama3.2-1b", **kw)
    ckpt = str(tmp_path / "ck")
    train("llama3.2-1b", ckpt_dir=ckpt, ckpt_every=7, halt_at=7, **kw)
    resumed = train("llama3.2-1b", ckpt_dir=ckpt, ckpt_every=7, **kw)
    assert resumed["steps"] == 7
    assert abs(resumed["last_loss"] - full["last_loss"]) < 2e-3
