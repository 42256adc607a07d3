"""Tiny cells for the benchmark's CPU tests.

Run from the root of the repository: ``python -m pytest bench/tests``.
The tests that need a card carry the ``cuda`` marker and skip without
one; whether there is one is decided inside a fixture.
"""
import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from bench.lib import spec  # noqa: E402

TINY_MODEL = {
    "dense": {"family": "dense", "num_layers": 2, "d_model": 64,
              "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
              "vocab_size": 256, "rope_theta": 1e6, "norm_eps": 1e-5,
              "tie_embeddings": False},
    "mamba2": {"family": "ssm", "num_layers": 2, "d_model": 64,
               "num_heads": 1, "num_kv_heads": 1, "head_dim": 16, "d_ff": 0,
               "vocab_size": 256, "tie_embeddings": True, "norm_eps": 1e-5,
               "ssm_state": 16, "ssm_expand": 2, "ssm_head_dim": 16,
               "ssm_conv": 4, "ssm_groups": 1},
}
CONFIG_FILE = {"dense": "internlm2-1.8b", "mamba2": "mamba2-780m"}


def tiny_config(ref: str, **policy):
    """A configuration file's content at a CPU test's size: the cell's
    own policy and optimizer, small widths."""
    conf = copy.deepcopy(spec.read_json(
        spec.BENCH / "configs" / f"{CONFIG_FILE[ref]}.json"))
    conf["model"] = dict(TINY_MODEL[ref])
    conf["policy"].update({"loss_chunk": 32, **policy})
    if ref == "dense":
        conf["policy"].update(attn_chunk_q=32, attn_chunk_k=32)
    else:
        conf["policy"].update(ssm_chunk=16)
    return conf


TRAIN = {"kind": "train", "batch": 2, "seq_len": 64, "mean_doc_len": 16,
         "eos_id": 0, "zipf_a": 1.3, "markov_states": 8}
SERVE = {"kind": "serve", "arrivals": "poisson", "rate": 12.0,
         "shape_seed": 0,
         "prompt": {"dist": "lognormal", "median": 20, "sigma": 0.8,
                    "min": 4, "max": 60},
         "output": {"dist": "lognormal", "median": 6, "sigma": 0.8,
                    "min": 2, "max": 24},
         "engine": {"max_batch": 4, "max_len": 96,
                    "prompt_buckets": [16, 32, 64],
                    "cache_dtype": "bfloat16"},
         "check": {"requests": 4, "min_tokens": 40}}


#: Limits of ``correct`` at the tests' size, set as the cells' are, from
#: this size's own readings on the CPU: sound runs over 8 seeds read at
#: most loss 3.5e-4, grad 5.0e-3, change 3.6e-3 (dense and mamba2) and
#: a served gap of 2.2e-3; the float8 control reads grad 0.027 and a
#: served gap of 0.08; half the batch left out reads loss 0.016-0.03,
#: grad 0.12-0.15 and change 0.057-0.18; a state left unchanged reads a
#: change of 1.  (A tiny model's leaves hold few values, so its norms
#: are noisier than the full-size cells', whose limits are in
#: ``bench/limits/``.)
TINY_LIMITS = {"train": {"loss_gap": 0.003, "grad_gap": 0.012,
                         "change_gap": 0.012},
               "serve": {"served_gap": 0.03}}


def tiny_cell(ref: str, kind: str, **policy) -> spec.Cell:
    return spec.Cell(
        name="tiny", chips=1, config=tiny_config(ref, **policy),
        traffic=dict(TRAIN if kind == "train" else SERVE),
        limits=dict(TINY_LIMITS[kind]), end_to_end=[], per_layer=[])


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
