"""The model zoo's layers in the port against the JAX package's, on the
CPU.

Inputs are made from a seed with numpy; weights are the reference's
``init_*`` output carried across as numpy, so both packages compute on
the same numbers.  Tolerances: 1e-5 in float32, 2e-2 in bfloat16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as ref_encdec
from repro.models import get_config as ref_get_config
from repro.models import layers as RL
from repro_torch.core.bridge import from_numpy
from repro_torch.models import encdec, get_config
from repro_torch.models import layers as TL
from repro_torch.models import tree

TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _t(tree):
    return from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol,
                               rtol=tol)


def _x(shape, dtype, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal(shape) * scale, getattr(jnp, dtype))
    return x, _t(x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    x, tx = _x((3, 5, 96), dtype, scale=3.0)
    rng = np.random.default_rng(1)
    p = {"scale": jnp.asarray(rng.standard_normal(96) + 1.0, jnp.float32),
         "bias": jnp.asarray(rng.standard_normal(96), jnp.float32)}
    got = TL.layer_norm(_t(p), tx, 1e-5)
    assert got.dtype == getattr(torch, dtype)
    _close(got, RL.layer_norm(p, x, 1e-5), TOL[dtype])
    init = TL.init_layernorm(96, "cpu")
    _close(TL.layer_norm(init, tx), RL.layer_norm(RL.init_layernorm(96), x),
           TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sections", [(), (6, 5, 5)])
def test_apply_rope_matches_reference(dtype, sections):
    x, tx = _x((2, 24, 4, 32), dtype)
    rng = np.random.default_rng(2)
    shape = (3, 2, 24) if sections else (2, 24)
    pos = rng.integers(0, 4096, shape).astype(np.int32)
    want = RL.apply_rope(x, jnp.asarray(pos), 5e5, sections)
    got = TL.apply_rope(tx, torch.from_numpy(pos), 5e5, sections)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])
    assert TL.apply_rope(tx, torch.from_numpy(pos), 5e5, sections,
                         enabled=False) is tx


def test_mrope_collapses_to_rope_for_text():
    _, tx = _x((2, 8, 4, 32), "float32")
    pos = torch.arange(8)[None].expand(2, 8)
    a = TL.apply_rope(tx, pos, 10000.0)
    b = TL.apply_rope(tx, pos[None].expand(3, 2, 8), 10000.0,
                      mrope_sections=(6, 5, 5))
    torch.testing.assert_close(a, b, atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="M-RoPE"):
        TL.apply_rope(tx, pos, 10000.0, mrope_sections=(6, 5, 5))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_qkv_matches_reference(dtype, qk_norm):
    p = RL.init_attention(jax.random.PRNGKey(3), 64, 4, 2, 16, qk_norm)
    if qk_norm:    # scales away from 1, so the norms' scale is exercised
        p["q_norm"]["scale"] = p["q_norm"]["scale"] * 1.5
        p["k_norm"]["scale"] = p["k_norm"]["scale"] * 0.5
    x, tx = _x((2, 12, 64), dtype)
    want = RL._qkv(p, x, 4, 2, 16, qk_norm, 1e-6)
    got = TL._qkv(_t(p), tx, 4, 2, 16, qk_norm, 1e-6)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == tx.dtype
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "qwen3-1.7b"])
def test_attention_block_matches_reference(dtype, arch):
    """The whole sublayer: projections, qk-norm (qwen3), M-RoPE over
    three position streams (qwen2-vl), chunked causal attention, out."""
    ref = ref_get_config(arch).reduced()
    cfg = get_config(arch).reduced()
    p = RL.init_attention(jax.random.PRNGKey(30), ref.d_model, ref.num_heads,
                          ref.num_kv_heads, ref.hd, ref.qk_norm)
    x, tx = _x((2, 128, ref.d_model), dtype, seed=31)
    rng = np.random.default_rng(32)
    shape = (3, 2, 128) if ref.mrope_sections else (2, 128)
    pos = np.sort(rng.integers(0, 512, shape), axis=-1).astype(np.int32)
    want = RL.attention_block(p, x, jnp.asarray(pos), cfg=ref)
    got = TL.attention_block(_t(p), tx, torch.from_numpy(pos), cfg=cfg)
    assert got.dtype == tx.dtype
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_matches_reference(dtype, act):
    p = RL.init_mlp(jax.random.PRNGKey(4), 64, 160, act)
    x, tx = _x((2, 12, 64), dtype)
    got = TL.mlp(_t(p), tx, act)
    assert sorted(TL.init_mlp(torch.Generator(), 64, 160, act)) == sorted(p)
    _close(got, RL.mlp(p, x, act), TOL[dtype])


def _moe(act, n_shared):
    p = RL.init_moe(jax.random.PRNGKey(5), 32, 4, 48, n_shared, act)
    x, tx = _x((2, 16, 32), "float32", seed=6)
    return p, _t(p), x, tx


@pytest.mark.parametrize("fn", ["moe_scatter", "moe_einsum"])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("capacity_factor", [1.0, 8.0])
def test_moe_with_a_shared_expert_matches_reference(fn, act,
                                                    capacity_factor):
    p, tp, x, tx = _moe(act, n_shared=1)
    kw = dict(top_k=2, capacity_factor=capacity_factor, act=act, n_shared=1)
    y, aux = jax.jit(lambda p, x: getattr(RL, fn)(p, x, **kw))(p, x)
    ty, taux = getattr(TL, fn)(tp, tx, **kw)
    _close(ty, y, 1e-5)
    _close(taux, aux, 1e-5)
    shapes = {k: tuple(v.shape) for k, v in TL.init_moe(
        torch.Generator(), 32, 4, 48, 1, act)["shared"].items()}
    assert shapes == {k: v.shape for k, v in p["shared"].items()}


@pytest.mark.parametrize("dispatch", ["scatter", "einsum"])
def test_moe_layer_matches_reference(dispatch):
    ref = ref_get_config("deepseek-moe-16b").reduced().override(
        moe_dispatch=dispatch)
    cfg = get_config("deepseek-moe-16b").reduced().override(
        moe_dispatch=dispatch)
    p = RL.init_moe(jax.random.PRNGKey(7), ref.d_model, ref.moe_num_experts,
                    ref.moe_d_ff, ref.moe_num_shared, ref.act)
    x, tx = _x((2, 16, ref.d_model), "float32", seed=8)
    y, aux = jax.jit(lambda p, x: RL.moe_layer(p, x, ref))(p, x)
    ty, taux = TL.moe_layer(_t(p), tx, cfg)
    assert cfg.moe_num_shared == 1
    _close(ty, y, 1e-5)
    _close(taux, aux, 1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_tail", [False, True])
def test_causal_conv1d_matches_reference(dtype, with_tail):
    w, tw = _x((4, 24), "float32", seed=9, scale=0.5)
    x, tx = _x((2, 10, 24), dtype, seed=10)
    tail, ttail = _x((2, 3, 24), dtype, seed=11) if with_tail else (None,
                                                                    None)
    got = TL.causal_conv1d(tw, tx, tail=ttail)
    assert got.dtype == tx.dtype
    _close(got, RL.causal_conv1d(w, x, tail=tail), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("carry_in", [False, True])
def test_mamba2_block_with_state_matches_reference(dtype, carry_in):
    ref = ref_get_config("mamba2-780m").reduced()
    cfg = get_config("mamba2-780m").reduced()
    p = RL.init_mamba2(jax.random.PRNGKey(12), ref)
    x, tx = _x((2, 40, ref.d_model), dtype, seed=13)   # a ragged chunk
    kw, tkw = {}, {}
    if carry_in:
        rng = np.random.default_rng(14)
        state = jnp.asarray(rng.standard_normal(
            (2, ref.ssm_heads, ref.ssm_head_dim, ref.ssm_state)) * 0.1,
            jnp.float32)
        km1, gn = ref.ssm_conv - 1, ref.ssm_groups * ref.ssm_state
        tails = {k: _x((2, km1, n), dtype, seed=15 + i)[0] for i, (k, n) in
                 enumerate((("x", ref.ssm_d_inner), ("B", gn), ("C", gn)))}
        kw = {"ssm_state": state, "conv_tail": tails}
        tkw = {"ssm_state": _t(state), "conv_tail": _t(tails)}
    y, st, tail = jax.jit(lambda p, x, kw: RL.mamba2_block(
        p, x, ref, return_state=True, **kw))(p, x, kw)
    ty, tst, ttail = TL.mamba2_block(_t(p), tx, cfg, return_state=True,
                                     **tkw)
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    _close(ty, y, TOL[dtype])
    _close(tst, st, TOL[dtype])
    for k in ("x", "B", "C"):
        _close(ttail[k], tail[k], TOL[dtype])
    _close(TL.mamba2_block(_t(p), tx, cfg, **tkw),
           jax.jit(lambda p, x, kw: RL.mamba2_block(p, x, ref, **kw))(
               p, x, kw), TOL[dtype])
    shapes = {k: tuple(v.shape) for k, v in tree.leaves(
        TL.init_mamba2(torch.Generator(), cfg))}
    assert shapes == {k: v.shape for k, v in tree.leaves(_t(p))}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [0, 8, 16])
def test_chunked_loss_matches_reference(dtype, chunk):
    table, ttable = _x((200, 48), "float32", seed=20, scale=0.02)
    x, tx = _x((2, 32, 48), dtype, seed=21)
    labels = np.random.default_rng(22).integers(0, 200, (2, 32)).astype(
        np.int32)
    want = RL.chunked_loss(table, x, jnp.asarray(labels), chunk, jnp.float32)
    got = TL.chunked_loss(ttable, tx, torch.from_numpy(labels), chunk,
                          torch.float32)
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want, TOL[dtype])


def test_embed_unembed_and_cross_entropy_match_reference():
    table, ttable = _x((100, 32), "float32", seed=23, scale=0.02)
    tokens = np.random.default_rng(24).integers(0, 100, (2, 9)).astype(
        np.int32)
    e = TL.embed({"table": ttable}, torch.from_numpy(tokens), torch.bfloat16)
    want = RL.embed({"table": table}, jnp.asarray(tokens), jnp.bfloat16)
    assert e.dtype == torch.bfloat16
    _close(e, want, 0)
    logits = TL.unembed(ttable, e, torch.float32)
    ref_logits = RL.unembed(table, want, jnp.float32)
    _close(logits, ref_logits, TOL["bfloat16"])
    mask = (np.arange(9) < 6).astype(np.float32)[None].repeat(2, 0)
    for m in (None, mask):
        _close(TL.cross_entropy(logits, torch.from_numpy(tokens),
                                None if m is None else torch.from_numpy(m)),
               RL.cross_entropy(ref_logits, jnp.asarray(tokens),
                                None if m is None else jnp.asarray(m)),
               1e-5)


def test_sinusoids_match_reference():
    """At whisper-small's reduced width (the model tests' encoder)."""
    got = encdec.sinusoids(32, 128)
    want = ref_encdec.sinusoids(32, 128)
    assert got.shape == want.shape
    _close(got, want, 1e-5)


def test_sinusoids_at_full_width_against_float64():
    """At whisper-small's 1500 frames x 768 channels the two packages
    differ by up to ~1.2e-4: their float32 ``exp`` differs by one ulp on
    some channels' inverse timescale, and the angle reaches 1500 rad
    (ROADMAP queue 3).  Both are held to the float64 values within the
    bound that one ulp of the timescale gives at that angle."""
    import math
    length, channels = 1500, 768
    got = encdec.sinusoids(length, channels).double().numpy()
    ref = np.asarray(ref_encdec.sinusoids(length, channels), np.float64)
    inv = np.exp(-math.log(10000.0) / (channels // 2 - 1)
                 * np.arange(channels // 2))
    angle = np.arange(length)[:, None] * inv[None]
    exact = np.concatenate([np.sin(angle), np.cos(angle)], axis=1)
    # one float32 ulp of inv (2^-23 relative) over the angle, plus the
    # rounding of the angle and of sin/cos themselves
    bound = (length - 1) * 2.0 ** -23 + 2.0 ** -22
    assert np.abs(ref - exact).max() <= bound
    assert np.abs(got - exact).max() <= bound
    assert np.abs(got - ref).max() <= 2 * bound


@pytest.mark.parametrize("S,target", [(1500, 512), (1500, 64), (64, 64),
                                      (97, 512)])
def test_pick_chunk_matches_reference(S, target):
    assert TL.pick_chunk(S, target) == RL.pick_chunk(S, target)
