"""The port's arch configs (``repro_torch.configs``) against the JAX
package's: every registered arch field for field, its exact parameter
counts, and its reduced (CPU smoke) variant."""
import dataclasses

import pytest

from repro.models import get_config as ref_get_config
from repro.models import hybrid as ref_hybrid
from repro.models import list_archs as ref_list_archs
from repro_torch.models import ModelConfig, get_config, list_archs
from repro_torch.models import hybrid, register_arch

ARCHS = list(ref_list_archs())

#: Fields the port's ModelConfig has and the reference's lacks (the
#: hybrid path's Granite 4.0-H fields), each at the default that leaves
#: a registered arch's computation as the reference's.
PORT_ONLY = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
             "logits_scaling": 1.0, "attention_multiplier": 0.0,
             "moe_experts_held": 0, "ssm_conv_bias": False,
             "residual_dtype": ""}


def _shared_fields(cfg):
    """``cfg.to_dict()`` less :data:`PORT_ONLY`, which must hold their
    defaults."""
    d = cfg.to_dict()
    assert {k: d.pop(k) for k in PORT_ONLY} == PORT_ONLY
    return d


def test_the_ten_archs_are_registered():
    assert len(ARCHS) == 10
    assert list(list_archs()) == ARCHS


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch):
    cfg, ref = get_config(arch), ref_get_config(arch)
    assert _shared_fields(cfg) == ref.to_dict()
    assert cfg.param_counts() == ref.param_counts()
    assert cfg.num_params() == ref.num_params()
    assert cfg.num_active_params() == ref.num_active_params()
    assert (cfg.hd, cfg.ssm_d_inner, cfg.ssm_heads, cfg.sub_quadratic) == \
        (ref.hd, ref.ssm_d_inner, ref.ssm_heads, ref.sub_quadratic)
    layers = range(cfg.num_layers)
    assert [(cfg.is_moe_layer(i), cfg.is_attn_layer(i)) for i in layers] \
        == [(ref.is_moe_layer(i), ref.is_attn_layer(i)) for i in layers]


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_matches_reference(arch):
    cfg, ref = get_config(arch).reduced(), ref_get_config(arch).reduced()
    assert _shared_fields(cfg) == ref.to_dict()
    assert cfg.param_counts() == ref.param_counts()
    assert cfg.num_active_params() == ref.num_active_params()


def test_full_width_param_counts():
    """The two archs the card runs at full width (issue figures)."""
    assert get_config("llama3.2-1b").num_params() == 1_235_814_400
    assert get_config("mamba2-780m").num_params() == 780_062_976


def test_override_and_registry_errors():
    cfg = get_config("qwen3-1.7b")
    assert cfg.override(dtype="float32").dtype == "float32"
    assert cfg.dtype == "bfloat16"
    assert ModelConfig.__dataclass_params__.frozen
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.dtype = "float32"
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("no-such-arch")
    with pytest.raises(ValueError, match="already registered"):
        register_arch(cfg)


@pytest.mark.parametrize("reduced", [False, True])
def test_hybrid_layer_pattern_matches_reference(reduced):
    cfg, ref = get_config("jamba-v0.1-52b"), ref_get_config("jamba-v0.1-52b")
    if reduced:
        cfg, ref = cfg.reduced(), ref.reduced()
    assert hybrid._pattern(cfg) == ref_hybrid._pattern(ref)
    assert hybrid._counts(cfg) == ref_hybrid._counts(ref) == (7, 1, 4, 4)
