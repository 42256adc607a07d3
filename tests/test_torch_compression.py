"""The port's gradient codecs (``repro_torch.distributed.compression``)
against the reference's, on the same numpy inputs made from seeds.

Every value must equal the reference's bit for bit: the bf16 casts
(round to nearest even in both), int8's ``q``, ``scale``, ``pad`` and
decoded values (``torch.round`` rounds half to even, as ``jnp.round``
does; the divisions and products are single IEEE operations), and
error feedback's packed leaves and carried residual over 50 steps.  The
reference's own properties (``tests/test_compression.py``) hold on the
port too: the bf16 round trip within 2e-2, int8's error within
max|x|/127, error feedback's accumulated bias below 0.2 and its error
state below 1.0.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as ref
from repro_torch.distributed import compression as port

SIZES = (1, 7, 255, 256, 257, 1000, 2000)
SCALES = (0.1, 1.0, 100.0)


def _equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    assert got.numpy().tobytes() == want.tobytes()


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


def test_bf16_round_trip_equals_the_reference():
    rng = np.random.default_rng(0)
    tree = {"g": np.linspace(-3, 3, 1000, dtype=np.float32),
            "h": rng.normal(0, 50, (7, 33)).astype(np.float32),
            "steps": np.arange(5, dtype=np.int32)}
    got = port.bf16_compress({k: torch.from_numpy(v)
                              for k, v in tree.items()})
    want = ref.bf16_compress({k: jnp.asarray(v) for k, v in tree.items()})
    for k in ("g", "h"):
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            _bf16_bits(got[k]), np.asarray(want[k]).view(np.int16))
    _equal(got["steps"], want["steps"])          # not float32: untouched
    back = port.bf16_decompress(got)
    for k in ("g", "h"):
        _equal(back[k], ref.bf16_decompress(want)[k])
    np.testing.assert_allclose(back["g"].numpy(), tree["g"], atol=2e-2)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("n", SIZES)
def test_int8_equals_the_reference(n, scale):
    x = np.random.default_rng(n).normal(0, scale, n).astype(np.float32)
    if n >= 1000:
        x[256:512] = 0.0                  # an all-zero block: scale 1
    got = port.int8_quantize(torch.from_numpy(x))
    want = ref.int8_quantize(jnp.asarray(x))
    for k in ("q", "scale", "pad"):
        _equal(got[k], want[k])
    assert int(got["pad"]) == (-n) % port.BLOCK
    y = port.int8_dequantize(got, x.shape)
    _equal(y, ref.int8_dequantize(want, x.shape))
    # the reference's bound: within max|x| / 127 of x
    assert np.abs(x - y.numpy()).max() <= np.abs(x).max() / 127 + 1e-6


def test_error_feedback_equals_the_reference_over_50_steps():
    rng = np.random.default_rng(0)
    shapes = {"w": (256,), "b": (3, 100)}
    got_err = want_err = None
    true_sum = np.zeros(256)
    decoded_sum = np.zeros(256)
    for _ in range(50):
        g = {k: rng.normal(0, 1, s).astype(np.float32)
             for k, s in shapes.items()}
        packed, got_err = port.ef_compress_tree(
            {k: torch.from_numpy(v) for k, v in g.items()}, got_err)
        rpacked, want_err = ref.ef_compress_tree(
            {k: jnp.asarray(v) for k, v in g.items()}, want_err)
        for k in shapes:
            for part in ("q", "scale", "pad"):
                _equal(packed[k][part], rpacked[k][part])
            _equal(got_err[k], want_err[k])
        decoded = port.ef_decompress_tree(
            packed, {k: torch.empty(s) for k, s in shapes.items()})
        rdecoded = ref.ef_decompress_tree(
            rpacked, {k: jnp.zeros(s) for k, s in shapes.items()})
        for k in shapes:
            _equal(decoded[k], rdecoded[k])
        true_sum += g["w"]
        decoded_sum += decoded["w"].numpy()
    # the reference's properties: the accumulated bias stays bounded
    assert np.abs(true_sum - decoded_sum).max() < 0.2


def test_error_state_stays_bounded():
    rng = np.random.default_rng(1)
    err = None
    for _ in range(30):
        g = {"w": torch.from_numpy(rng.normal(0, 1, 128).astype(np.float32))}
        _, err = port.ef_compress_tree(g, err)
    assert float(err["w"].abs().max()) < 1.0


def test_codecs_leave_the_tree_structure():
    tree = {"a": {"b": torch.ones(3)}, "c": (torch.zeros(2, 2),)}
    packed, err = port.ef_compress_tree(tree)
    assert set(packed["a"]["b"]) == {"q", "scale", "pad"}
    assert isinstance(packed["c"], tuple) and err["c"][0].shape == (2, 2)
    out = port.ef_decompress_tree(packed, tree)
    assert torch.equal(out["a"]["b"], tree["a"]["b"])
    assert torch.equal(out["c"][0], tree["c"][0])
