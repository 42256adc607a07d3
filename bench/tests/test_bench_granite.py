"""The Granite 4.0-H reference's own checks at a tiny size, on the CPU:
its weights fill the port's tree and repeat for a seed, and its
``train_flops`` is the count made by hand."""
import copy

import torch

from bench.lib import spec
from bench.reference import granite_hybrid as ref
from bench.reference.common import get_path

#: The configuration file at a tiny size: one period of ten layers,
#: every width and count cut, its shape (attention at 5, an MoE on every
#: layer, 4 of 8 experts held, conv biases, a tied table) kept.
TINY = {"family": "hybrid", "num_layers": 10, "d_model": 32,
        "num_heads": 4, "num_kv_heads": 2, "head_dim": 8, "d_ff": 0,
        "vocab_size": 128, "norm_eps": 1e-05, "tie_embeddings": True,
        "use_rope": False, "embedding_multiplier": 12.0,
        "residual_multiplier": 0.22, "attention_multiplier": 0.125,
        "logits_scaling": 16.0, "attn_every": 10, "attn_offset": 5,
        "moe_num_experts": 8, "moe_top_k": 3, "moe_num_shared": 2,
        "moe_d_ff": 16, "moe_every": 1, "moe_offset": 0,
        "moe_experts_held": 4, "ssm_state": 8, "ssm_expand": 2,
        "ssm_head_dim": 8, "ssm_conv": 4, "ssm_groups": 1,
        "ssm_conv_bias": True}


def _conf():
    conf = copy.deepcopy(spec.read_json(
        spec.BENCH / "configs" / "granite-4.0-h-small.json"))
    conf["model"] = dict(TINY)
    conf["policy"].update(loss_chunk=32, attn_chunk_q=32, attn_chunk_k=32,
                          ssm_chunk=16)
    return conf


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


def test_weights_fill_the_ports_tree():
    from repro_torch.models import build
    conf = _conf()
    port = build(spec.model_config(conf)).init(
        torch.Generator().manual_seed(0))
    ours = spec.reference(conf).make_params(conf["model"], 5, "cpu")
    assert spec.reference(conf) is ref
    assert _shapes(ours) == _shapes(port)


def test_weights_repeat_for_a_seed():
    a = ref.make_params(TINY, 2 ** 33 + 1, "cpu")
    b = ref.make_params(TINY, 2 ** 33 + 1, "cpu")
    c = ref.make_params(TINY, 2 ** 33 + 2, "cpu")
    for path in _shapes(a):
        assert torch.equal(get_path(a, path), get_path(b, path))
    for path in ("blocks.moe.w_up", "blocks.mamba.conv_x_bias"):
        assert not torch.equal(get_path(a, path), get_path(c, path))


def test_train_flops_is_the_hand_count():
    """6 × (the touched parameters) × tokens + attention + SSD, counted
    here leaf by leaf at the tiny size, B2 × S64, chunk 16."""
    m = {**TINY, "ssm_chunk": 16}
    d, V, di, H, N, P, E, k, held, ff = 32, 128, 64, 8, 8, 8, 8, 3, 4, 16
    mamba = (2 * d * di + 2 * d * N + d * H       # w_z, w_x, w_B, w_C, w_dt
             + 4 * (di + 2 * N)                   # the convolutions
             + (di + 2 * N)                       # their biases
             + 3 * H + di                         # A_log, D, dt_bias, norm
             + di * d)                            # out_proj
    attn = d * 32 + 2 * d * 16 + 32 * d           # wq, wk, wv, wo
    moe = d * E + 3 * d * ff * 2                  # router, shared expert
    touched = (V * d + d + 10 * 2 * d + 9 * mamba + attn + 10 * moe
               + 10 * (k * held / E) * 3 * d * ff)
    tokens = 2 * 64
    attention = 3 * 2 * 2 * 64 * 64 * 4 * 8
    pairs = tokens // 16 * 16 * 17 // 2
    ssd = 2 * pairs * N + 2 * pairs * H * P + 4 * tokens * H * P * N
    want = 6 * touched * tokens + attention + 9 * 3 * ssd
    assert ref.train_flops(m, 2, 64) == want
