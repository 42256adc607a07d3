"""The nn scope's kernels on the CPU: the port's plain versions against
the JAX package's Pallas kernels, and the wrappers' contract.

The Pallas kernels run in interpret mode on the CPU, at the shapes of
tests/test_kernels.py and with its tolerances: flash attention 2e-5 for
f32 and 4e-2 for bf16, rmsnorm 1e-5 and 2e-2, ssd 3e-5.  The flash
kernel is called with its blocks as given (``flash_attention_pallas``):
the reference wrapper clamps them to the head counts (ROADMAP queue 3).
Inputs are made from a seed with numpy and handed to both packages.  On
a CPU tensor a wrapper takes its plain version and launches nothing; the
CUDA kernels run only on the card (tests/test_torch_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.rmsnorm.kernel import rmsnorm_pallas
from repro.kernels.ssd_scan import ssd as jax_ssd
from repro.kernels.ssd_scan.kernel import ssd_chunk_pallas
from repro_torch.core.bridge import from_numpy
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_ref)
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.rmsnorm import ops as rmsnorm_ops
from repro_torch.kernels.ssd_scan import (ssd, ssd_chunk, ssd_chunk_ref,
                                          ssd_reference)
from repro_torch.kernels.ssd_scan import ops as ssd_ops

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _t(a):
    return from_numpy(np.asarray(a))


@pytest.mark.parametrize("S,H,K,D,bq,bk", [
    (128, 4, 2, 32, 32, 32),
    (64, 2, 2, 64, 64, 64),
    (256, 4, 1, 16, 64, 128),
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 4e-2)])
def test_flash_attention_plain_matches_pallas(S, H, K, D, bq, bk, causal,
                                              dtype, tol):
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    q, k, v = (jnp.asarray(rng.standard_normal(s, np.float32), jdt)
               for s in ((2, S, H, D), (2, S, K, D), (2, S, K, D)))
    want = np.asarray(flash_attention_pallas(q, k, v, causal=causal, bq=bq,
                                             bk=bk, interpret=True),
                      np.float32)
    tq, tk, tv = map(_t, (q, k, v))
    before = flash_ops.launches
    got = flash_attention(tq, tk, tv, causal=causal)
    assert flash_ops.launches == before
    assert got.dtype == tdt and got.shape == tq.shape
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    np.testing.assert_allclose(
        flash_attention_ref(tq, tk, tv, causal=causal).float().numpy(),
        want, atol=tol)


@pytest.mark.parametrize("rows,d,br", [(64, 128, 16), (256, 512, 64),
                                       (32, 1024, 32)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rmsnorm_plain_matches_pallas(rows, d, br, dtype, tol):
    jdt, tdt = _DTYPES[dtype]
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((rows, d), np.float32), jdt)
    s = jnp.asarray(rng.standard_normal(d, np.float32) + 1.0)
    want = np.asarray(rmsnorm_pallas(x, s, br=br, interpret=True),
                      np.float32)
    tx, ts = _t(x), _t(s)
    before = rmsnorm_ops.launches
    got = rmsnorm(tx, ts)
    assert rmsnorm_ops.launches == before
    assert got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol)
    np.testing.assert_allclose(rmsnorm_ref(tx, ts).float().numpy(), want,
                               atol=tol)


def _ssd_inputs(l, h, b=2, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, l, h, p)) * 0.4).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
    return x, dt, A, Bm, Cm, np.ones(h, np.float32)


@pytest.mark.parametrize("l,h,chunk", [(32, 2, 8), (64, 3, 16), (128, 1, 32)])
def test_ssd_chunk_plain_matches_pallas(l, h, chunk):
    x, dt, A, Bm, Cm, _ = _ssd_inputs(l, h)
    want = ssd_chunk_pallas(*map(jnp.asarray, (x, dt, A, Bm[:, :, 0],
                                                Cm[:, :, 0])),
                            chunk=chunk, interpret=True)
    before = ssd_ops.launches
    got = ssd_chunk(*map(_t, (x, dt, A, Bm[:, :, 0], Cm[:, :, 0])),
                    chunk=chunk)
    assert ssd_ops.launches == before
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=3e-5)


@pytest.mark.parametrize("l,h,chunk", [(32, 2, 8), (64, 3, 16), (128, 1, 32)])
def test_ssd_plain_matches_pallas(l, h, chunk):
    args = _ssd_inputs(l, h)
    want_y, want_s = jax_ssd(*map(jnp.asarray, args), chunk=chunk)
    y, s = ssd(*map(_t, args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(want_s), atol=3e-5)
    yr, sr = ssd_reference(*map(_t, args))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), sr.numpy(), atol=3e-5)


def test_ssd_init_state_and_default_chunk():
    args = _ssd_inputs(256, 2, b=1, seed=1)
    h0 = np.random.default_rng(2).standard_normal((1, 2, 8, 16)).astype(
        np.float32) * 0.1
    y, s = ssd(*map(_t, args), init_state=_t(h0))       # chunk 128
    yr, sr = ssd_reference(*map(_t, args), init_state=_t(h0))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), sr.numpy(), atol=3e-5)


def test_ssd_chunk_plain_keeps_the_upper_triangle_finite():
    """Long chunks with strong decay: the exponent above the diagonal
    would overflow; the plain version, like the kernel, never takes it."""
    x, dt, A, Bm, Cm, _ = _ssd_inputs(256, 2, b=1)
    A = np.full_like(A, -8.0)
    y, states, ecs = ssd_chunk(*map(_t, (x, dt * 4, A, Bm[:, :, 0],
                                         Cm[:, :, 0])), chunk=256)
    assert torch.isfinite(y).all() and torch.isfinite(states).all()


_Q = torch.ones(1, 8, 4, 32)
_KV = torch.ones(1, 8, 2, 32)


@pytest.mark.parametrize("args,err,match", [
    ((torch.ones(1, 8, 2, 48),) * 3, ValueError, "head size"),
    ((_Q, torch.ones(1, 8, 3, 32), torch.ones(1, 8, 3, 32)), ValueError,
     "multiple"),
    ((_Q, _KV, torch.ones(1, 8, 2, 16)), ValueError, "want"),
    ((_Q[0], _KV, _KV), ValueError, "want"),
    ((_Q, torch.ones(2, 8, 2, 32), torch.ones(2, 8, 2, 32)), ValueError,
     "batch"),
    ((_Q.half(), _KV.half(), _KV.half()), TypeError, "dtypes"),
    ((_Q, _KV.bfloat16(), _KV), TypeError, "dtypes"),
    ((_Q.transpose(1, 2).contiguous().transpose(1, 2), _KV, _KV), ValueError,
     "contiguous"),
    ((_Q, _KV.to("meta"), _KV), ValueError, "operands on"),
])
def test_flash_attention_wrapper_rejects(args, err, match):
    with pytest.raises(err, match=match):
        flash_attention(*args)


@pytest.mark.parametrize("x,s,err,match", [
    (torch.ones(4, 8), torch.ones(4), ValueError, "does not match"),
    (torch.ones(4, 8), torch.ones(1, 8), ValueError, "does not match"),
    (torch.ones(4, 8, dtype=torch.float16), torch.ones(8), TypeError,
     "float32 or"),
    (torch.ones(4, 8), torch.ones(8, dtype=torch.bfloat16), TypeError,
     "scale dtype"),
    (torch.ones(8, 4).t(), torch.ones(8), ValueError, "contiguous"),
    (torch.ones(4, 8), torch.ones(8, device="meta"), ValueError,
     "operands on"),
])
def test_rmsnorm_wrapper_rejects(x, s, err, match):
    with pytest.raises(err, match=match):
        rmsnorm(x, s)


def test_ssd_wrappers_reject():
    x, dt, A, Bm, Cm, D = map(_t, _ssd_inputs(48, 2, b=1))
    B0, C0 = Bm[:, :, 0], Cm[:, :, 0]
    with pytest.raises(ValueError, match="not a multiple"):
        ssd_chunk(x, dt, A, B0, C0, chunk=32)          # l % Q (Pallas assert)
    with pytest.raises(ValueError, match="not a multiple"):
        ssd(x, dt, A, Bm, Cm, D, chunk=32)
    with pytest.raises(ValueError, match="one group"):
        ssd(x, dt, A, Bm.expand(1, 48, 2, 16), Cm.expand(1, 48, 2, 16), D)
    with pytest.raises(ValueError, match="positive int"):
        ssd_chunk(x, dt, A, B0, C0, chunk=0)
    with pytest.raises(ValueError, match="shapes"):
        ssd_chunk(x, dt[:, :, :1], A, B0, C0, chunk=16)
    with pytest.raises(TypeError, match="float32"):
        ssd_chunk(x.double(), dt, A, B0, C0, chunk=16)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_chunk(x, dt, A, B0.transpose(1, 2).contiguous().transpose(1, 2),
                  C0, chunk=16)
    with pytest.raises(ValueError, match="operands on"):
        ssd_chunk(x, dt, A.to("meta"), B0, C0, chunk=16)
    assert ssd_ops.launches == 0


def test_nn_wrappers_are_custom_ops():
    """All three go through the dispatcher as repro_torch:: ops with a
    fake (shape) implementation."""
    util = ("test_schema", "test_faketensor")
    q, kv = torch.randn(1, 8, 4, 16), torch.randn(1, 8, 2, 16)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention.default,
                          (q, kv, kv, True), test_utils=util)
    x, s = torch.randn(4, 32), torch.randn(32)
    torch.library.opcheck(torch.ops.repro_torch.rmsnorm.default,
                          (x, s, 1e-6), test_utils=util)
    xs, dt, A, Bm, Cm, _ = map(_t, _ssd_inputs(32, 2, b=1))
    torch.library.opcheck(torch.ops.repro_torch.ssd_chunk.default,
                          (xs, dt, A, Bm[:, :, 0], Cm[:, :, 0], 16),
                          test_utils=util)
    got = torch.ops.repro_torch.ssd_chunk(xs, dt, A, Bm[:, :, 0],
                                          Cm[:, :, 0], 16)
    for g, w in zip(got, ssd_chunk_ref(xs, dt, A, Bm[:, :, 0], Cm[:, :, 0],
                                       chunk=16)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype,Sk,want", [
    (torch.bfloat16, 4096, "wgmma"), (torch.bfloat16, 1, "wgmma"),
    (torch.bfloat16, 0, "wgmma"), (torch.float32, 4096, "ffma"),
    (torch.float32, 0, "ffma"), (torch.float32, 1, "ffma")])
def test_flash_attention_variant(dtype, Sk, want):
    """bf16 takes wgmma and float32 the register-tiled CUDA-core body,
    with or without keys (a key-less call writes zeros from the same C
    entry)."""
    assert flash_ops.variant(dtype) == want
    assert want in flash_ops.launches_by_variant
    assert (want, dtype) in flash_ops._SYMBOLS
