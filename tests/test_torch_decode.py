"""The port's decode path against the JAX package's, on the CPU.

The layers (``decode_attention``, ``mamba2_decode_step`` with
``_conv_decode``) and every family's ``init_cache``, ``prefill`` and
``decode_step`` (and the transformer's ``decode_step_ragged``) run on
the reference's weights, carried into the port by ``params_from_numpy``
(the two random streams differ), with inputs made by numpy from a seed.
Tolerances:

  * ``decode_attention``: float32 1e-6, bfloat16 2e-2 (the outputs
    round to bfloat16 at different points of the two einsum orders);
  * ``mamba2_decode_step``: float32 1e-5;
  * prefill plus one decode step against the port's own teacher-forced
    logits: the reference test's atol 5e-2, rtol 1e-2 (in the configs'
    bfloat16);
  * the port's prefill and decode logits against the reference's in
    float32 1e-4, and its caches 1e-5 (atol = rtol: the SSD states reach
    about 10, where float32 sums in the packages' different orders part
    by 1.6e-5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as ref_build
from repro.models import get_config as ref_get_config
from repro.models import layers as RL
from repro.models import transformer as ref_transformer
from repro_torch.core.bridge import from_numpy
from repro_torch.models import build, get_config
from repro_torch.models import layers as L
from repro_torch.models import transformer, tree
from repro_torch.models.bridge import params_from_numpy

DECODE_ARCHS = ["llama3.2-1b", "qwen3-1.7b", "deepseek-moe-16b",
                "mamba2-780m", "jamba-v0.1-52b", "whisper-small",
                "qwen2-vl-2b"]
B, S = 2, 24


def _np(tree_):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree_)


def _torch_np(t):
    return tree.map(lambda a: a.float().numpy(), t)


def _close(got, want, tol, what):
    """Every leaf of ``got`` (torch tree) against ``want`` (numpy tree of
    the same keys), with ``atol = rtol = tol`` as the kernels' checks."""
    got_np = dict(tree.leaves(_torch_np(got)))
    want_np = dict(tree.leaves(want))
    assert sorted(got_np) == sorted(want_np), what
    for k in want_np:
        np.testing.assert_allclose(got_np[k], want_np[k], atol=tol, rtol=tol,
                                   err_msg=f"{what} {'/'.join(k)}")


# ---------------------------------------------------------------------------
# decode_attention
# ---------------------------------------------------------------------------

def _attention_inputs(seed, Smax=20, H=4, K=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((3, Smax, K, D)).astype(np.float32)
    v = rng.standard_normal((3, Smax, K, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("q_dtype,cache_dtype,tol", [
    ("float32", "float32", 1e-6),
    ("bfloat16", "bfloat16", 2e-2),
    ("float32", "bfloat16", 2e-2),
])
@pytest.mark.parametrize("cache_len", [13, 20, [7, 0, 20]],
                         ids=["scalar", "full", "ragged"])
def test_decode_attention_matches_reference(q_dtype, cache_dtype, tol,
                                            cache_len):
    q, k, v = _attention_inputs(0)
    want = RL.decode_attention(
        jnp.asarray(q, q_dtype), jnp.asarray(k, cache_dtype),
        jnp.asarray(v, cache_dtype), jnp.asarray(cache_len, jnp.int32))
    got = L.decode_attention(
        torch.from_numpy(q).to(getattr(torch, q_dtype)),
        torch.from_numpy(k).to(getattr(torch, cache_dtype)),
        torch.from_numpy(v).to(getattr(torch, cache_dtype)),
        torch.tensor(cache_len, dtype=torch.int32))
    assert got.dtype == getattr(torch, q_dtype)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=tol, rtol=0)
    if isinstance(cache_len, list):          # the empty prefix: zeros
        assert not got[1].any()


def test_decode_attention_grouped_equals_repeated_heads():
    """The grouped product (q viewed [B,K,H/K,D] against K cache heads)
    is the repeat_kv form's: head h reads KV head h // (H/K)."""
    q, k, v = (torch.from_numpy(a) for a in _attention_inputs(1, H=8, K=2))
    got = L.decode_attention(q, k, v, 15)
    want = L.decode_attention(q, L.repeat_kv(k, 8), L.repeat_kv(v, 8), 15)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# mamba2_decode_step
# ---------------------------------------------------------------------------

def test_mamba2_decode_step_matches_reference():
    rcfg = ref_get_config("mamba2-780m").reduced().override(dtype="float32")
    cfg = get_config("mamba2-780m").reduced().override(dtype="float32")
    ref_p = _np(RL.init_mamba2(jax.random.PRNGKey(3), rcfg))
    rng = np.random.default_rng(4)
    km1 = cfg.ssm_conv - 1
    gn = cfg.ssm_groups * cfg.ssm_state
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    state = rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state)).astype(np.float32)
    tail = {"x": rng.standard_normal((2, km1, cfg.ssm_d_inner)),
            "B": rng.standard_normal((2, km1, gn)),
            "C": rng.standard_normal((2, km1, gn))}
    tail = {k: v.astype(np.float32) for k, v in tail.items()}
    want = RL.mamba2_decode_step(
        jax.tree_util.tree_map(jnp.asarray, ref_p), jnp.asarray(x), rcfg,
        ssm_state=jnp.asarray(state),
        conv_tail={k: jnp.asarray(v) for k, v in tail.items()})
    got = L.mamba2_decode_step(from_numpy(ref_p), torch.from_numpy(x), cfg,
                               ssm_state=torch.from_numpy(state),
                               conv_tail=from_numpy(tail))
    assert got[1].dtype == torch.float32
    _close({"y": got[0], "state": got[1], "tail": got[2]},
           _np({"y": want[0], "state": want[1], "tail": want[2]}), 1e-5,
           "mamba2_decode_step")


def test_conv_decode_matches_reference():
    rng = np.random.default_rng(5)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    tail = rng.standard_normal((2, 3, 6)).astype(np.float32)
    new = rng.standard_normal((2, 1, 6)).astype(np.float32)
    want = RL._conv_decode(jnp.asarray(w), jnp.asarray(tail),
                           jnp.asarray(new))
    got = L._conv_decode(torch.from_numpy(w), torch.from_numpy(tail),
                         torch.from_numpy(new))
    _close({"out": got[0], "tail": got[1]},
           {"out": np.asarray(want[0]), "tail": np.asarray(want[1])}, 1e-6,
           "_conv_decode")


# ---------------------------------------------------------------------------
# the families: prefill + decode_step
# ---------------------------------------------------------------------------

def make_batch(cfg, seed=2):
    """tests/test_models.py::make_batch's fields, from numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = (rng.standard_normal(
            (B, S, cfg.d_model)) * 0.02).astype(np.float32)
        mask = np.zeros((B, S), bool)
        mask[:, :4] = True
        batch["vision_mask"] = mask
    if cfg.family in ("audio", "encdec"):
        batch["frames"] = (rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def _prompt(batch):
    """The batch without its last position (the prompt to prefill)."""
    return {k: (v[:, :S - 1] if v.ndim >= 2 and v.shape[1] == S else v)
            for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_weights():
    """arch → the reference's reduced float32 weights (``PRNGKey(1)``,
    as its decode test), as numpy, made once."""
    cache = {}

    def weights(arch):
        if arch not in cache:
            cfg = ref_get_config(arch).reduced()
            cache[arch] = jax.tree_util.tree_map(
                np.asarray, ref_build(cfg).init(jax.random.PRNGKey(1)))
        return cache[arch]
    return weights


def _port_decode(cfg, params, batch, cache_dtype):
    """Port: full teacher-forced logits, prefill of S-1 tokens and one
    decode step → (full, prefill logits, decode logits, cache)."""
    api = build(cfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.inference_mode():
        full, _ = api.logits(params, tb)
        cache = api.init_cache(B, S + 4, cache_dtype)
        lp, cache = api.prefill(params, _prompt(tb), cache)
        ld, cache = api.decode_step(params, tb["tokens"][:, S - 1:S], cache)
    return full, lp, ld, cache


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_teacher_forcing(ref_weights, arch):
    """tests/test_models.py's check on the port, in the config's
    bfloat16 with a bfloat16 cache: prefill+decode reproduce the
    teacher-forced logits (capacity factor 8: no token drops)."""
    cfg = get_config(arch).reduced().override(moe_capacity_factor=8.0)
    params = params_from_numpy(cfg, ref_weights(arch))
    full, lp, ld, cache = _port_decode(cfg, params, make_batch(cfg),
                                       torch.bfloat16)
    np.testing.assert_allclose(lp[:, 0].float().numpy(),
                               full[:, S - 2].float().numpy(),
                               atol=5e-2, rtol=1e-2)
    np.testing.assert_allclose(ld[:, 0].float().numpy(),
                               full[:, S - 1].float().numpy(),
                               atol=5e-2, rtol=1e-2)
    assert int(cache["pos"]) == S


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_and_decode_match_reference(ref_weights, arch):
    """Float32 compute and cache: the port's prefill and decode logits
    within 1e-4 of the reference's, every cache leaf within 1e-5."""
    over = dict(moe_capacity_factor=8.0, dtype="float32")
    rcfg = ref_get_config(arch).reduced().override(**over)
    cfg = get_config(arch).reduced().override(**over)
    ref_api = ref_build(rcfg)
    batch = make_batch(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree_util.tree_map(jnp.asarray, ref_weights(arch))

    def ref_run(p, b):
        cache = ref_api.init_cache(B, S + 4, jnp.float32)
        lp, cache = ref_api.prefill(p, _prompt(b), cache)
        ld, cache = ref_api.decode_step(p, b["tokens"][:, S - 1:S], cache)
        return lp, ld, cache
    want_lp, want_ld, want_cache = jax.jit(ref_run)(jp, jb)
    params = params_from_numpy(cfg, ref_weights(arch))
    _, lp, ld, cache = _port_decode(cfg, params, batch, torch.float32)
    assert lp.dtype == ld.dtype == torch.float32
    np.testing.assert_allclose(lp.numpy(), np.asarray(want_lp), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(ld.numpy(), np.asarray(want_ld), atol=1e-4,
                               rtol=0)
    _close(cache, _np(want_cache), 1e-5, f"{arch} cache")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "qwen2-vl-2b"])
def test_decode_step_ragged_matches_reference(ref_weights, arch):
    """Per-row positions on a cache of random contents: rows at 5, 0
    (the new token alone), 11, and one past the cache, whose write the
    reference's scatter drops — the port's write must drop it too."""
    over = dict(moe_capacity_factor=8.0, dtype="float32")
    rcfg = ref_get_config(arch).reduced().override(**over)
    cfg = get_config(arch).reduced().override(**over)
    Smax = 12
    rng = np.random.default_rng(6)
    shape = (cfg.num_layers, 4, Smax, cfg.num_kv_heads, cfg.hd)
    cache = {"k": rng.standard_normal(shape).astype(np.float32),
             "v": rng.standard_normal(shape).astype(np.float32),
             "pos": np.array([5, 0, 11, Smax], np.int32)}
    tokens = rng.integers(0, cfg.vocab_size, (4, 1), dtype=np.int32)
    want_logits, want_cache = jax.jit(
        lambda p, t, c: ref_transformer.decode_step_ragged(rcfg, p, t, c))(
        jax.tree_util.tree_map(jnp.asarray, ref_weights(arch)),
        jnp.asarray(tokens), jax.tree_util.tree_map(jnp.asarray, cache))
    params = params_from_numpy(cfg, ref_weights(arch))
    with torch.inference_mode():
        logits, got_cache = transformer.decode_step_ragged(
            cfg, params, torch.from_numpy(tokens), from_numpy(cache))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               atol=1e-4, rtol=0)
    _close(got_cache, _np(want_cache), 1e-5, f"{arch} ragged cache")
    # the row past the cache kept its entries
    np.testing.assert_array_equal(got_cache["k"][:, 3].numpy(),
                                  cache["k"][:, 3])


def test_ragged_step_with_equal_positions_equals_uniform_step(ref_weights):
    cfg = get_config("llama3.2-1b").reduced().override(dtype="float32")
    params = params_from_numpy(cfg, ref_weights("llama3.2-1b"))
    api = build(cfg)
    tokens = torch.from_numpy(make_batch(cfg)["tokens"])
    with torch.inference_mode():
        _, c1 = api.prefill(params, {"tokens": tokens[:, :9]},
                            api.init_cache(B, 16, torch.float32))
        _, c2 = api.prefill(params, {"tokens": tokens[:, :9]},
                            api.init_cache(B, 16, torch.float32))
        c2["pos"] = c2["pos"].expand(B).clone()
        uniform, c1 = api.decode_step(params, tokens[:, 9:10], c1)
        ragged, c2 = transformer.decode_step_ragged(cfg, params,
                                                    tokens[:, 9:10], c2)
    torch.testing.assert_close(ragged, uniform, atol=1e-6, rtol=0)
    torch.testing.assert_close(c2["k"], c1["k"], atol=0, rtol=0)
