"""The port's input shapes and stand-ins (``repro_torch.launch.inputs``)
against the JAX package's (``repro.launch.inputs``), on the CPU.

Exact equality throughout: the shape registry and its applicability
over the ten archs and four shapes; every leaf's shape and dtype of the
batch stand-ins and of the decode caches (the reference's from
``jax.eval_shape``, the port's on the ``meta`` device: neither side
allocates).
"""
import jax
import numpy as np
import pytest
import torch

from repro.launch import inputs as ref_inp
from repro.models import get_config as ref_get_config
from repro.models import list_archs as ref_list_archs
from repro_torch.distributed.partition import map_with_path
from repro_torch.launch import inputs as inp
from repro_torch.models import get_config

ARCHS = list(ref_list_archs())


def ref_leaves(tree):
    """'/'-joined path → (shape, dtype name) of a jax tree."""
    from repro.distributed.partition import _path_str
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {_path_str(p): (tuple(x.shape), np.dtype(x.dtype).name)
            for p, x in flat}


def port_leaves(tree):
    out = {}

    def put(path, t):
        assert t.device.type == "meta", path
        out["/".join(str(k) for k in path)] = (
            tuple(t.shape), str(t.dtype).replace("torch.", ""))
    map_with_path(put, tree)
    return out


def test_shapes_registry_equals_reference():
    assert list(inp.SHAPES) == list(ref_inp.SHAPES)
    for name, spec in ref_inp.SHAPES.items():
        mine = inp.SHAPES[name]
        assert (mine.name, mine.seq_len, mine.global_batch, mine.kind) == \
            (spec.name, spec.seq_len, spec.global_batch, spec.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_shape_applicable_equals_reference(arch):
    for shape in ref_inp.SHAPES:
        assert inp.shape_applicable(get_config(arch), shape) == \
            ref_inp.shape_applicable(ref_get_config(arch), shape)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        assert port_leaves(inp.input_specs(get_config(arch), shape)) == \
            ref_leaves(ref_inp.input_specs(ref_get_config(arch), shape))


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_structs_equal_reference(arch):
    mine = port_leaves(inp.cache_structs(get_config(arch), "decode_32k"))
    ref = ref_leaves(ref_inp.cache_structs(ref_get_config(arch),
                                           "decode_32k"))
    assert mine == ref


def test_concrete_batch_shapes_and_seed():
    cfg = get_config("qwen2-vl-2b").reduced()
    b = inp.concrete_batch(cfg, "train_4k", torch.Generator().manual_seed(3),
                           batch_override=2, seq_override=16)
    assert b["tokens"].shape == (2, 16) and b["tokens"].dtype == torch.int32
    assert b["positions"].shape == (3, 2, 16)
    assert torch.equal(b["positions"][1, 1], torch.arange(16,
                                                          dtype=torch.int32))
    assert b["vision_mask"].dtype == torch.bool and not b["vision_mask"].any()
    again = inp.concrete_batch(cfg, "train_4k",
                               torch.Generator().manual_seed(3),
                               batch_override=2, seq_override=16)
    assert all(torch.equal(b[k], again[k]) for k in b)
    assert int(b["tokens"].max()) < cfg.vocab_size
