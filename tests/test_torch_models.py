"""The port's model zoo against the JAX package's, on the CPU.

Every arch's reduced config runs through both packages with one set of
weights: the reference's ``init(PRNGKey(0))``, carried into the port by
``params_from_numpy`` (the two random streams differ, so the two inits
are never compared).  The batch is made with numpy from a seed, with the
fields of tests/test_models.py::make_batch.  Tolerances: in float32 the
logits within 1e-4 and the loss within 1e-5 (the two packages sum in
different orders; observed errors are near 1e-6); in the configs'
default bfloat16 the loss within 5e-2 (every product rounds to
bfloat16, and the two packages round their elementwise steps at
different points).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import build as ref_build
from repro.models import get_config as ref_get_config
from repro.models import list_archs as ref_list_archs
from repro_torch.models import build, get_config, list_archs
from repro_torch.models.bridge import params_from_numpy

ARCHS = list(ref_list_archs())
SMOKE_ARCHS = ["llama3.2-1b", "mamba2-780m", "deepseek-moe-16b",
               "jamba-v0.1-52b", "whisper-small"]
B, S = 2, 32


def make_batch(cfg, seed=7):
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


@pytest.fixture(scope="module")
def ref_weights():
    """arch → the reference's reduced float32 weights (``PRNGKey(0)``;
    the config's dtype does not enter ``init``), made once."""
    cache = {}

    def weights(arch):
        if arch not in cache:
            cfg = ref_get_config(arch).reduced()
            cache[arch] = ref_build(cfg).init(jax.random.PRNGKey(0))
        return cache[arch]
    return weights


@pytest.fixture(scope="module")
def runs(ref_weights):
    """(arch, dtype) → the reference's and the port's logits and loss on
    the reference's weights, each computed once."""
    cache = {}

    def run(arch, dtype):
        if (arch, dtype) in cache:
            return cache[arch, dtype]
        ref_cfg = ref_get_config(arch).reduced().override(dtype=dtype)
        cfg = get_config(arch).reduced().override(dtype=dtype)
        ref_api, api = ref_build(ref_cfg), build(cfg)
        ref_params = ref_weights(arch)
        batch = make_batch(cfg)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        # one jit for both members: they share the forward's compile
        ref_logits, ref_loss = jax.jit(
            lambda p, b: (ref_api.logits(p, b)[0], ref_api.loss(p, b)[0]))(
                ref_params, jbatch)
        params = params_from_numpy(
            cfg, jax.tree_util.tree_map(np.asarray, ref_params))
        tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
        with torch.inference_mode():
            logits, _ = api.logits(params, tbatch)
            loss, metrics = api.loss(params, tbatch)
        cache[arch, dtype] = {
            "ref_logits": np.asarray(ref_logits, np.float32),
            "ref_loss": float(ref_loss), "logits": logits, "loss": loss,
            "metrics": metrics}
        return cache[arch, dtype]
    return run


def test_port_lists_the_reference_archs():
    assert list(list_archs()) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_float32_logits_and_loss_match_reference(runs, arch):
    r = runs(arch, "float32")
    cfg = get_config(arch).reduced()
    assert r["logits"].shape == (B, S, cfg.vocab_size)
    assert r["logits"].dtype == torch.float32
    np.testing.assert_allclose(r["logits"].numpy(), r["ref_logits"],
                               atol=1e-4, rtol=0)
    assert abs(float(r["loss"]) - r["ref_loss"]) <= 1e-5


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_bfloat16_loss_matches_reference(runs, arch):
    r = runs(arch, "bfloat16")
    assert np.isfinite(float(r["loss"]))
    assert abs(float(r["loss"]) - r["ref_loss"]) <= 5e-2
    assert torch.isfinite(r["logits"]).all()


@pytest.fixture
def ref_tree(ref_weights):
    """arch → (the port's reduced config, a fresh numpy copy of the
    reference's weights) that a test may edit."""
    def tree(arch):
        return get_config(arch).reduced(), jax.tree_util.tree_map(
            np.array, ref_weights(arch))
    return tree


def test_params_from_numpy_raises_on_missing_key(ref_tree):
    cfg, tree = ref_tree("llama3.2-1b")
    del tree["blocks"]["attn"]["wk"]
    with pytest.raises(ValueError, match="blocks/attn/wk"):
        params_from_numpy(cfg, tree)


def test_params_from_numpy_raises_on_renamed_key(ref_tree):
    cfg, tree = ref_tree("mamba2-780m")
    tree["blocks"]["mamba"]["in_proj"] = tree["blocks"]["mamba"].pop("w_z")
    with pytest.raises(ValueError, match="in_proj"):
        params_from_numpy(cfg, tree)


def test_params_from_numpy_raises_on_transposed_weight(ref_tree):
    cfg, tree = ref_tree("llama3.2-1b")
    w_up = tree["blocks"]["mlp"]["w_up"]                  # [L, d, d_ff]
    tree["blocks"]["mlp"]["w_up"] = np.swapaxes(w_up, -1, -2)
    with pytest.raises(ValueError, match="blocks/mlp/w_up"):
        params_from_numpy(cfg, tree)


def test_params_from_numpy_keeps_values_and_device(ref_tree):
    cfg, tree = ref_tree("jamba-v0.1-52b")
    params = params_from_numpy(cfg, tree)
    got = params["blocks"]["moe"]["w_up"]
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), tree["blocks"]["moe"]["w_up"])
