"""The port's ``models.layers`` subset against the JAX package's, on the
CPU.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances are the reference's own (tests/test_layers.py): flash
attention 2e-5 forward and 1e-4 for its gradients, SSD 3e-5, MoE 1e-5;
RMSNorm as tests/test_kernels.py holds its oracle (1e-5 f32, 2e-2 bf16).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.core.bridge import from_numpy
from repro_torch.models import layers as TL


def _t(a):
    return from_numpy(np.asarray(a))


def _qkv(rng, B, Sq, Sk, H, K, D):
    q = rng.standard_normal((B, Sq, H, D)).astype(np.float32)
    k = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    v = rng.standard_normal((B, Sk, K, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("rows,d", [(8, 64), (33, 512)])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 2e-2)])
def test_rms_norm_matches_reference(rows, d, dtype, tol):
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((rows, d)), getattr(jnp, dtype))
    s = jnp.asarray(rng.standard_normal(d) + 1.0, jnp.float32)
    want = RL.rms_norm({"scale": s}, x)
    got = TL.rms_norm({"scale": _t(s)}, _t(x))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol)


@pytest.mark.parametrize("Sq,Sk,H,K,causal,q_offset,kv_len", [
    (16, 16, 4, 2, True, 0, None),
    (16, 16, 4, 4, False, 0, None),
    (1, 24, 4, 1, True, 20, 21),
    (8, 24, 2, 2, True, 16, None),
])
def test_naive_attention_matches_reference(Sq, Sk, H, K, causal, q_offset,
                                           kv_len):
    q, k, v = _qkv(np.random.default_rng(1), 2, Sq, Sk, H, K, 32)
    want = RL.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal, q_offset=q_offset, kv_len=kv_len)
    got = TL.naive_attention(_t(q), _t(k), _t(v), causal=causal,
                             q_offset=q_offset, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("Sq,Sk,cq,ck,causal,skip", [
    (64, 64, 16, 16, True, True),
    (64, 64, 16, 32, True, False),
    (32, 64, 16, 16, True, True),
    (48, 48, 16, 16, False, True),
])
def test_chunk_schedule_matches_reference(Sq, Sk, cq, ck, causal, skip):
    assert TL._chunk_pairs(Sq, Sk, cq, ck, causal, skip) == \
        RL._chunk_pairs(Sq, Sk, cq, ck, causal, skip)
    assert TL._split_pairs(Sq, Sk, cq, ck, causal, skip) == \
        RL._split_pairs(Sq, Sk, cq, ck, causal, skip)


_FLASH_CASES = [
    # B, Sq, Sk, H, K, D, cq, ck, causal, causal_skip
    (2, 64, 64, 4, 2, 32, 16, 16, True, True),
    (1, 64, 64, 4, 4, 16, 32, 16, True, False),
    (2, 32, 64, 4, 1, 32, 16, 16, True, True),
    (2, 48, 48, 2, 2, 16, 16, 16, False, True),
]


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,cq,ck,causal,skip", _FLASH_CASES)
def test_flash_attention_xla_forward(B, Sq, Sk, H, K, D, cq, ck, causal,
                                     skip):
    q, k, v = _qkv(np.random.default_rng(2), B, Sq, Sk, H, K, D)
    want = RL.flash_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, chunk_q=cq,
                                  chunk_k=ck, causal_skip=skip)
    got = TL.flash_attention_xla(_t(q), _t(k), _t(v), causal=causal,
                                 chunk_q=cq, chunk_k=ck, causal_skip=skip)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    if Sq == Sk:     # both causal conventions agree only at Sq == Sk
        oracle = TL.naive_attention(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=2e-5)


def test_flash_attention_xla_bf16_forward():
    q, k, v = _qkv(np.random.default_rng(3), 2, 64, 64, 4, 2, 32)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = RL.flash_attention_xla(jq, jk, jv, chunk_q=16, chunk_k=16)
    got = TL.flash_attention_xla(_t(jq), _t(jk), _t(jv), chunk_q=16,
                                 chunk_k=16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=4e-2)


@pytest.mark.parametrize("B,Sq,Sk,H,K,D,cq,ck,causal,skip", _FLASH_CASES)
def test_flash_attention_xla_gradients(B, Sq, Sk, H, K, D, cq, ck, causal,
                                       skip):
    q, k, v = _qkv(np.random.default_rng(4), B, Sq, Sk, H, K, D)

    def ref_loss(q, k, v):
        return jnp.sum(RL.flash_attention_xla(
            q, k, v, causal=causal, chunk_q=cq, chunk_k=ck,
            causal_skip=skip) ** 2)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = TL.flash_attention_xla(tq, tk, tv, causal=causal, chunk_q=cq,
                                 chunk_k=ck, causal_skip=skip)
    got = torch.autograd.grad((out ** 2).sum(), (tq, tk, tv))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def test_flash_attention_xla_refuses_ragged_chunks():
    q, k, v = _qkv(np.random.default_rng(5), 1, 48, 48, 2, 2, 16)
    with pytest.raises(ValueError, match="do not divide"):
        TL.flash_attention_xla(_t(q), _t(k), _t(v), chunk_q=32, chunk_k=32)


@pytest.mark.parametrize("B,S,tokens_dtype", [(1, 64, "float32"),
                                              (2, 16, "float32"),
                                              (4, 1, "float32")])
def test_moe_scatter_on_reference_params(B, S, tokens_dtype):
    d, E, ff, k = 32, 8, 64, 2
    params = RL.init_moe(jax.random.PRNGKey(0), d, E, ff, 0)
    x = np.random.default_rng(6).standard_normal((B, S, d)).astype(
        tokens_dtype)
    want_y, want_aux = RL.moe_scatter(params, jnp.asarray(x), top_k=k,
                                      capacity_factor=1.25)
    tparams = from_numpy({n: np.asarray(w) for n, w in params.items()})
    assert sorted(tparams) == ["router", "w_down", "w_gate", "w_up"]
    got_y, got_aux = TL.moe_scatter(tparams, _t(x), top_k=k,
                                    capacity_factor=1.25)
    np.testing.assert_allclose(got_y.numpy(), np.asarray(want_y), atol=1e-5)
    np.testing.assert_allclose(got_aux.item(), float(want_aux), atol=1e-5)


@pytest.mark.parametrize("T,E,k,cf", [(64, 8, 2, 1.25), (1, 8, 2, 1.0),
                                      (4096, 8, 2, 1.25), (100, 6, 1, 2.0)])
def test_moe_capacity_matches_reference(T, E, k, cf):
    assert TL.moe_capacity(T, E, k, cf) == RL.moe_capacity(T, E, k, cf)


def test_init_moe_shapes_and_seed():
    p = TL.init_moe(torch.Generator().manual_seed(0), 32, 8, 64, 0)
    ref = RL.init_moe(jax.random.PRNGKey(0), 32, 8, 64, 0)
    assert {n: tuple(w.shape) for n, w in p.items()} == \
        {n: tuple(w.shape) for n, w in ref.items()}
    again = TL.init_moe(torch.Generator().manual_seed(0), 32, 8, 64, 0)
    assert all(torch.equal(p[n], again[n]) for n in p)
    assert abs(p["w_up"].std().item() - 1 / np.sqrt(32)) < 0.01
    # shared experts: one MLP of width ff * n_shared, the reference's tree
    shared = TL.init_moe(torch.Generator().manual_seed(0), 32, 8, 64, 2)
    ref_shared = RL.init_moe(jax.random.PRNGKey(0), 32, 8, 64, 2)
    assert {n: tuple(w.shape) for n, w in shared["shared"].items()} == \
        {n: tuple(w.shape) for n, w in ref_shared["shared"].items()}


def _ssd_inputs(rng, b, l, h, p, n):
    x = (rng.standard_normal((b, l, h, p)) * 0.4).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    Bm = (rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
    Cm = (rng.standard_normal((b, l, 1, n)) * 0.3).astype(np.float32)
    D = np.ones(h, np.float32)
    return x, dt, A, Bm, Cm, D


@pytest.mark.parametrize("l,h,chunk,with_state", [(32, 2, 8, False),
                                                  (64, 3, 16, True),
                                                  (50, 2, 16, False)])
def test_ssd_chunked_matches_reference(l, h, chunk, with_state):
    rng = np.random.default_rng(7)
    args = _ssd_inputs(rng, 2, l, h, 8, 16)
    h0 = (rng.standard_normal((2, h, 8, 16)) * 0.1).astype(np.float32) \
        if with_state else None
    y, s = TL.ssd_chunked(*map(_t, args), chunk=chunk,
                          init_state=None if h0 is None else _t(h0))
    yr, sr = TL.ssd_reference(*map(_t, args),
                              init_state=None if h0 is None else _t(h0))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), sr.numpy(), atol=3e-5)
    jargs = tuple(map(jnp.asarray, args))
    jh0 = None if h0 is None else jnp.asarray(h0)
    ry, rs = RL.ssd_chunked(*jargs, chunk=chunk, init_state=jh0)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), atol=3e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=3e-5)
    ry, rs = RL.ssd_reference(*jargs, init_state=jh0)
    np.testing.assert_allclose(yr.numpy(), np.asarray(ry), atol=3e-5)
    np.testing.assert_allclose(sr.numpy(), np.asarray(rs), atol=3e-5)
