"""The port's train step (``repro_torch.train``) against the JAX
package's, on the CPU, in float32.

Both packages start from one state: the reference's ``init`` (and
``make_init_fn``) from ``PRNGKey(0)``, carried into the port by
``models/bridge.py`` (the two random streams differ, so the two inits
are never compared).  Batches are made with numpy from a seed.  The
reference's side is ``jax.value_and_grad`` of its ``api.loss`` and its
unsharded ``jax.jit(make_train_step(...))``.

Tolerances: the loss within 1e-5 and each gradient leaf within atol =
rtol = 1e-4 (the bound the flash gradients are held to in
tests/test_torch_layers.py); over three steps the loss within 1e-4,
``grad_norm`` relative 1e-4 and ``lr`` within 1e-7.  AdamW's first steps
move a parameter by about ``lr`` whatever the size of its gradient, so
an element whose gradient is near zero can step the other way in the
other package: the parameters are held to max |Δ| ≤ 6·lr (three such
flips) with at least 99.9 % of the elements within 1e-5.  The remat
policies change what the backward keeps, not what it computes: their
gradients agree within 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as ref_build
from repro.models import layers as ref_layers
from repro.models import get_config as ref_get_config
from repro.models import list_archs as ref_list_archs
from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import make_train_step as ref_make_train_step
from repro.train.step import _split_microbatches as ref_split
from repro.train.step import make_init_fn as ref_make_init_fn
from repro_torch.models import build, get_config, layers, tree
from repro_torch.models.bridge import params_from_numpy, train_state_from_numpy
from repro_torch.train import (AdamWConfig, make_eval_step, make_init_fn,
                               make_train_step)
from repro_torch.train.step import _grad_fn, _split_microbatches

ARCHS = list(ref_list_archs())
B, S = 2, 32
LR = 1e-3


def make_batch(cfg, seed=7, batch=B, seq=S):
    """tests/test_models.py::make_batch's fields, from numpy."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq),
                                  dtype=np.int32)}
    if cfg.family == "vlm":
        out["vision_embeds"] = (rng.standard_normal(
            (batch, seq, cfg.d_model)) * 0.02).astype(np.float32)
        mask = np.zeros((batch, seq), bool)
        mask[:, :4] = True
        out["vision_mask"] = mask
    if cfg.family in ("audio", "encdec"):
        out["frames"] = (rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def configs(arch, **kw):
    """(reference config, port config): reduced, float32, ``kw``."""
    kw = {"dtype": "float32", **kw}
    return (ref_get_config(arch).reduced().override(**kw),
            get_config(arch).reduced().override(**kw))


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def ref_weights():
    """arch → the reference's reduced float32 weights from
    ``PRNGKey(0)``, as numpy, made once."""
    cache = {}

    def weights(arch):
        if arch not in cache:
            cfg = ref_get_config(arch).reduced()
            cache[arch] = jax.tree_util.tree_map(
                np.asarray, ref_build(cfg).init(jax.random.PRNGKey(0)))
        return cache[arch]
    return weights


def port_grads(cfg, params, batch):
    (loss, _), grads = _grad_fn(build(cfg))(params, to_torch(batch))
    return float(loss), grads


#: The archs on the Mamba2 block, whose reference gradient goes through
#: the reference's sequential ``ssd_reference``: its chunked SSD masks
#: the intra-chunk decay after the exp, and the exp's gradient above the
#: diagonal is inf · 0 = NaN (the port masks before it).
SSD_ARCHS = ("mamba2-780m", "jamba-v0.1-52b")


def sequential_ssd(x, dt, A, B, C, D, *, chunk=None, init_state=None):
    return ref_layers.ssd_reference(x, dt, A, B, C, D, init_state=init_state)


def ref_value_and_grad(ref_cfg, params, batch):
    ref_api = ref_build(ref_cfg)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p, b: ref_api.loss(p, b)[0]))(params, to_jax(batch))
    return float(loss), dict(tree.leaves(jax.tree_util.tree_map(np.asarray,
                                                                grads)))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(ref_weights, monkeypatch, arch):
    ref_cfg, cfg = configs(arch)
    batch = make_batch(cfg)
    if arch in SSD_ARCHS:
        monkeypatch.setattr(ref_layers, "ssd_chunked", sequential_ssd)
    ref_loss, want = ref_value_and_grad(ref_cfg, ref_weights(arch), batch)
    params = params_from_numpy(cfg, ref_weights(arch))
    loss, grads = port_grads(cfg, params, batch)
    assert abs(loss - ref_loss) <= 1e-5
    got = dict(tree.leaves(grads))
    assert got.keys() == want.keys()
    for key, g in got.items():
        assert g.dtype == torch.float32
        assert np.isfinite(want[key]).all(), key
        np.testing.assert_allclose(g.numpy(), want[key], atol=1e-4,
                                   rtol=1e-4, err_msg="/".join(key))


def test_reference_chunked_ssd_gradient_is_nan(ref_weights):
    """Why the SSD archs' reference gradient takes the sequential scan:
    the reference's chunked form gives NaN where the port's is finite."""
    ref_cfg, cfg = configs("mamba2-780m")
    batch = make_batch(cfg)
    _, want = ref_value_and_grad(ref_cfg, ref_weights("mamba2-780m"), batch)
    assert np.isnan(want[("blocks", "mamba", "A_log")]).any()
    _, grads = port_grads(cfg, params_from_numpy(
        cfg, ref_weights("mamba2-780m")), batch)
    assert all(torch.isfinite(g).all() for _, g in tree.leaves(grads))


def ref_state(arch, ref_cfg, opt):
    return jax.tree_util.tree_map(np.asarray, ref_make_init_fn(
        ref_build(ref_cfg), opt)(jax.random.PRNGKey(0)))


def run_both(arch, batches, microbatches=1, **kw):
    """Three (or ``len(batches)``) steps of each package's train step
    from the reference's initial state.  Returns (reference metrics,
    port metrics, reference state, port state, lr of the last step)."""
    ref_cfg, cfg = configs(arch, **kw)
    ref_opt = RefAdamWConfig(lr=LR, total_steps=20, warmup_steps=2)
    opt = AdamWConfig(lr=LR, total_steps=20, warmup_steps=2)
    state_np = ref_state(arch, ref_cfg, ref_opt)
    ref_step = jax.jit(ref_make_train_step(ref_build(ref_cfg), ref_opt,
                                           num_microbatches=microbatches))
    step = make_train_step(build(cfg), opt, num_microbatches=microbatches)
    rs = jax.tree_util.tree_map(jnp.asarray, state_np)
    st = train_state_from_numpy(cfg, state_np)
    ref_ms, ms = [], []
    for b in batches:
        rs, rm = ref_step(rs, to_jax(b))
        st, m = step(st, to_torch(b))
        ref_ms.append({k: float(v) for k, v in rm.items()})
        ms.append({k: float(v) for k, v in m.items()})
    return ref_ms, ms, rs, st


def assert_metrics_close(ref_ms, ms, loss_tol=1e-4, norm_rtol=1e-4):
    for i, (r, m) in enumerate(zip(ref_ms, ms)):
        assert m.keys() == r.keys()
        assert abs(m["loss"] - r["loss"]) <= loss_tol, (i, m, r)
        assert abs(m["grad_norm"] - r["grad_norm"]) <= \
            norm_rtol * r["grad_norm"], (i, m, r)
        assert abs(m["lr"] - r["lr"]) <= 1e-7, (i, m, r)


def test_three_train_steps_match_reference():
    _, cfg = configs("llama3.2-1b")
    batches = [make_batch(cfg, seed=s, batch=4) for s in range(3)]
    ref_ms, ms, rs, st = run_both("llama3.2-1b", batches)
    assert_metrics_close(ref_ms, ms)
    assert int(st["step"]) == 3 and int(st["opt"]["count"]) == 3
    want = dict(tree.leaves(jax.tree_util.tree_map(np.asarray, rs)))
    got = dict(tree.leaves(st))
    assert got.keys() == want.keys()
    worst, beyond, total = 0.0, 0, 0
    for key, t in got.items():
        d = np.abs(t.numpy().astype(np.float64) - want[key])
        if key[0] == "params":
            worst = max(worst, float(d.max()))
            beyond += int((d > 1e-5).sum())
            total += d.size
    share = beyond / total
    print(f"params after 3 steps: max |d| {worst:.3g} (limit {6 * LR:.3g}), "
          f"{beyond} of {total} elements beyond 1e-5 ({share:.3g})")
    assert worst <= 6 * LR
    assert share <= 1e-3


def test_two_microbatches_match_one_and_the_reference():
    _, cfg = configs("llama3.2-1b")
    batches = [make_batch(cfg, seed=s, batch=4) for s in range(3)]
    ref_ms, ms2, _, _ = run_both("llama3.2-1b", batches, microbatches=2)
    assert_metrics_close(ref_ms, ms2)
    _, ms1, _, _ = run_both("llama3.2-1b", batches[:1], microbatches=1)
    # the first step from one state: equal-sized microbatches average to
    # the whole batch's loss and gradient
    assert abs(ms2[0]["loss"] - ms1[0]["loss"]) <= 1e-5
    assert abs(ms2[0]["grad_norm"] - ms1[0]["grad_norm"]) <= \
        1e-5 * ms1[0]["grad_norm"]
    assert ms2[0]["aux"] == 0.0 and ms2[0]["nll"] == ms2[0]["loss"]


def mrope_batch(cfg, batch=4):
    out = make_batch(cfg, batch=batch)
    rng = np.random.default_rng(3)
    out["positions"] = np.sort(rng.integers(0, 64, (3, batch, S)),
                               axis=-1).astype(np.int32)
    return out


def test_mrope_positions_split_as_the_reference():
    _, cfg = configs("qwen2-vl-2b")
    batch = mrope_batch(cfg)
    want = ref_split(to_jax(batch), 2)
    got = _split_microbatches(to_torch(batch), 2)
    assert got["positions"].shape == (2, 3, 2, S)
    for k in batch:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_mrope_microbatched_step_matches_reference():
    _, cfg = configs("qwen2-vl-2b")
    ref_ms, ms, _, _ = run_both("qwen2-vl-2b", [mrope_batch(cfg)],
                                microbatches=2)
    assert_metrics_close(ref_ms, ms)


REMAT_CASES = [("llama3.2-1b", ("full", "dots")),
               ("deepseek-moe-16b", ("full", "dots")),
               ("mamba2-780m", ("full",)),
               ("jamba-v0.1-52b", ("full",)),
               ("whisper-small", ("full",))]


@pytest.mark.parametrize("arch,modes", REMAT_CASES)
def test_remat_policies_give_the_same_gradients(ref_weights, arch, modes):
    _, cfg = configs(arch)
    params = params_from_numpy(cfg, ref_weights(arch))
    batch = make_batch(cfg)
    loss, want = port_grads(cfg, params, batch)
    assert all(torch.isfinite(w).all() for _, w in tree.leaves(want))
    for mode in modes:
        l_m, got = port_grads(cfg.override(remat=mode), params, batch)
        assert abs(l_m - loss) <= 1e-6, mode
        for (key, g), (_, w) in zip(tree.leaves(got), tree.leaves(want)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6,
                                       rtol=0, err_msg=f"{mode} {key}")


def test_remat_checkpoints_only_with_grad(monkeypatch, ref_weights):
    calls = []
    real = layers.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs.get("context_fn"))
        return real(*args, **kwargs)
    monkeypatch.setattr(layers, "checkpoint", counting)
    _, cfg = configs("llama3.2-1b", remat="full")
    params = params_from_numpy(cfg, ref_weights("llama3.2-1b"))
    batch = to_torch(make_batch(cfg))
    api = build(cfg)
    with torch.inference_mode():
        api.loss(params, batch)
    with torch.no_grad():
        api.loss(params, batch)
    assert calls == []
    port_grads(cfg, params, make_batch(cfg))
    assert len(calls) == cfg.num_layers and calls[0] is None
    calls.clear()
    port_grads(cfg.override(remat="dots"), params, make_batch(cfg))
    assert len(calls) == cfg.num_layers and calls[0] is not None
    calls.clear()
    port_grads(cfg.override(remat="none"), params, make_batch(cfg))
    assert calls == []


def test_unstack_gives_index_forward_and_one_stack_backward():
    gen = torch.Generator().manual_seed(0)
    stack = {"w": torch.randn(3, 4, 5, generator=gen),
             "b": {"s": torch.randn(3, 5, generator=gen), "none": {}}}
    for i, layer in enumerate(tree.unstack(stack)):
        ref = tree.index(stack, i)
        assert torch.equal(layer["w"], ref["w"])
        assert torch.equal(layer["b"]["s"], ref["b"]["s"])
        assert layer["b"]["none"] == {}
    w = stack["w"].clone().requires_grad_()
    x = torch.randn(2, 4, generator=gen)
    via_unstack = torch.autograd.grad(
        sum((x @ layer["w"]).sum() * (i + 1)
            for i, layer in enumerate(tree.unstack({"w": w}))), w)[0]
    via_index = torch.autograd.grad(
        sum((x @ w[i]).sum() * (i + 1) for i in range(3)), w)[0]
    assert torch.equal(via_unstack, via_index)
    assert tree.unstack({}) == []


def test_eval_step_is_the_loss_without_grad(ref_weights):
    _, cfg = configs("mamba2-780m")
    params = params_from_numpy(cfg, ref_weights("mamba2-780m"))
    batch = to_torch(make_batch(cfg))
    out = make_eval_step(build(cfg))(params, batch)
    assert set(out) == {"loss", "nll", "aux"}
    assert not out["loss"].requires_grad
    with torch.no_grad():
        assert torch.equal(out["loss"], build(cfg).loss(params, batch)[0])


def test_init_fn_and_train_state_layout():
    _, cfg = configs("llama3.2-1b")
    state = make_init_fn(build(cfg), AdamWConfig())(
        torch.Generator().manual_seed(0))
    assert set(state) == {"params", "opt", "step"}
    assert state["step"].dtype == torch.int32 and state["step"].ndim == 0
    assert state["opt"]["count"].dtype == torch.int32
    for (k, p), (_, m) in zip(tree.leaves(state["params"]),
                              tree.leaves(state["opt"]["m"])):
        assert m.shape == p.shape and m.dtype == torch.float32
        assert not p.requires_grad


def test_train_step_updates_state_in_place():
    _, cfg = configs("llama3.2-1b")
    api = build(cfg)
    state = make_init_fn(api, AdamWConfig())(torch.Generator().manual_seed(0))
    w = state["params"]["embed"]["table"]
    before = w.clone()
    new, metrics = make_train_step(api, AdamWConfig(warmup_steps=0))(
        state, to_torch(make_batch(cfg)))
    assert new["params"]["embed"]["table"] is w
    assert not torch.equal(w, before)
    assert int(new["step"]) == 1 and int(new["opt"]["count"]) == 1
    assert not w.requires_grad
    assert set(metrics) == {"loss", "grad_norm", "lr", "nll", "aux"}


def test_grad_specs_are_not_ported():
    """``grad_specs`` shard a DTensor gradient accumulator: a step given
    them refuses plain (one-device) state."""
    _, cfg = configs("llama3.2-1b")
    api = build(cfg)
    state = make_init_fn(api, AdamWConfig())(torch.Generator().manual_seed(0))
    step = make_train_step(api, AdamWConfig(), num_microbatches=2,
                           grad_specs={})
    with pytest.raises(ValueError, match="DTensors on a mesh"):
        step(state, to_torch(make_batch(cfg)))
