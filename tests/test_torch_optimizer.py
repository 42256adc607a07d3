"""The port's AdamW, schedule and clipping (``repro_torch.train``):
tests/test_optimizer.py's checks through the port, and each function
against the JAX package's on the same numpy trees within 1e-6, with the
optimizer's count carried over three steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import AdamWConfig as RefAdamWConfig
from repro.train import adamw_init as ref_adamw_init
from repro.train import adamw_update as ref_adamw_update
from repro.train import clip_by_global_norm as ref_clip
from repro.train import warmup_cosine as ref_warmup_cosine
from repro_torch.models import tree
from repro_torch.train import (AdamWConfig, adamw_init, adamw_update,
                               clip_by_global_norm, warmup_cosine)


def test_adamw_first_step_matches_reference():
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.999, eps=1e-8,
                      weight_decay=0.0, warmup_steps=0, total_steps=10,
                      min_lr_ratio=1.0)
    params = {"w": torch.tensor([[1.0, 2.0]])}
    grads = {"w": torch.tensor([[0.1, -0.2]])}
    opt = adamw_init(params)
    new_p, new_opt, lr = adamw_update(cfg, grads, opt, params)
    g = np.asarray([[0.1, -0.2]])
    expect = np.asarray([[1.0, 2.0]]) - 1e-2 * g / (np.sqrt(g ** 2) + 1e-8)
    np.testing.assert_allclose(new_p["w"].numpy(), expect, rtol=1e-5)
    assert int(new_opt["count"]) == 1
    assert new_opt["count"].dtype == torch.int32


def test_weight_decay_only_on_matrices():
    cfg = AdamWConfig(lr=1.0, weight_decay=0.5, warmup_steps=0,
                      total_steps=1, min_lr_ratio=1.0)
    params = {"w": torch.ones((2, 2)), "scale": torch.ones((2,))}
    grads = tree.map(torch.zeros_like, params)
    new_p, _, _ = adamw_update(cfg, grads, adamw_init(params), params)
    assert bool((new_p["w"] < 1.0).all())                 # decayed
    np.testing.assert_allclose(new_p["scale"].numpy(), 1.0)


@pytest.mark.parametrize("max_norm", [0.1, 0.5, 1.0, 3.0, 7.5, 10.0])
def test_clip_bound(max_norm):
    grads = {"a": torch.full((8,), 3.0), "b": torch.full((4,), -2.0)}
    clipped, gnorm = clip_by_global_norm(grads, max_norm)
    total = np.sqrt(sum(np.sum(np.square(g.numpy()))
                        for _, g in tree.leaves(clipped)))
    assert total <= max_norm * 1.001 + 1e-6
    assert float(gnorm) > 0


def test_schedule_shape():
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                      min_lr_ratio=0.1)
    sched = warmup_cosine(cfg)
    assert float(sched(torch.tensor(0))) < 0.15
    assert abs(float(sched(torch.tensor(10))) - 1.0) < 0.01
    assert float(sched(torch.tensor(100))) <= 0.11


CFG = dict(lr=3e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
           grad_clip=1.0, warmup_steps=2, total_steps=8, min_lr_ratio=0.1)


def numpy_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((5, 7)).astype(np.float32),
            "blocks": {"k": rng.standard_normal((2, 3, 4)).astype(
                np.float32) * 0.1,
                "scale": rng.standard_normal((6,)).astype(np.float32)}}


def test_schedule_matches_reference():
    ref = ref_warmup_cosine(RefAdamWConfig(**CFG))
    port = warmup_cosine(AdamWConfig(**CFG))
    for step in range(12):
        want = float(ref(jnp.asarray(step, jnp.int32)))
        got = port(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * CFG["lr"] + 1e-12, step


def test_clip_matches_reference():
    grads = numpy_tree(1)
    grads["w"] *= 10.0                    # norm well above grad_clip
    ref_out, ref_norm = ref_clip(jax.tree_util.tree_map(jnp.asarray, grads),
                                 1.0)
    out, norm = clip_by_global_norm(tree.map(torch.from_numpy, grads), 1.0)
    assert abs(float(norm) - float(ref_norm)) <= 1e-6 * float(ref_norm)
    want = dict(tree.leaves(jax.tree_util.tree_map(np.asarray, ref_out)))
    for key, g in tree.leaves(out):
        np.testing.assert_allclose(g.numpy(), want[key], atol=1e-6, rtol=0)


def test_adamw_matches_reference_over_three_steps():
    ref_cfg, cfg = RefAdamWConfig(**CFG), AdamWConfig(**CFG)
    p0 = numpy_tree(0)
    ref_p = jax.tree_util.tree_map(jnp.asarray, p0)
    ref_opt = ref_adamw_init(ref_p)
    p = tree.map(torch.from_numpy, jax.tree_util.tree_map(np.copy, p0))
    opt = adamw_init(p)
    for step in range(3):
        g = numpy_tree(10 + step)
        ref_p, ref_opt, ref_lr = ref_adamw_update(
            ref_cfg, jax.tree_util.tree_map(jnp.asarray, g), ref_opt, ref_p)
        p, opt, lr = adamw_update(cfg, tree.map(torch.from_numpy, g), opt, p)
        assert int(opt["count"]) == int(ref_opt["count"]) == step + 1
        assert abs(float(lr) - float(ref_lr)) <= 1e-9
        for name, want, got in (("params", ref_p, p),
                                ("m", ref_opt["m"], opt["m"]),
                                ("v", ref_opt["v"], opt["v"])):
            want = dict(tree.leaves(jax.tree_util.tree_map(np.asarray,
                                                           want)))
            for key, t in tree.leaves(got):
                np.testing.assert_allclose(t.numpy(), want[key], atol=1e-6,
                                           rtol=0, err_msg=f"{name} {key}")


def test_adamw_writes_in_place_and_keeps_the_device():
    p = {"w": torch.ones((3, 3)), "s": torch.ones((3,))}
    opt = adamw_init(p)
    ids = [id(t) for _, t in tree.leaves(p)] + \
        [id(t) for _, t in tree.leaves(opt["m"])]
    grads = tree.map(torch.ones_like, p)
    new_p, new_opt, lr = adamw_update(AdamWConfig(warmup_steps=0), grads,
                                      opt, p)
    assert [id(t) for _, t in tree.leaves(new_p)] + \
        [id(t) for _, t in tree.leaves(new_opt["m"])] == ids
    assert int(opt["count"]) == 0 and int(new_opt["count"]) == 1
    assert isinstance(lr, torch.Tensor) and lr.device == p["w"].device
