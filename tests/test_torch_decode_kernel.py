"""The decode-attention kernel's plain version and wrapper, on the CPU.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``);
here its plain counterpart (``kernels/decode_attention/ref.py``: the same
split-and-combine algorithm, tile by tile) is held to the port's plain
decode attention (``models.layers._decode_attention``, what the CPU
path runs), and the wrapper's contract, the split, the partials of a
sharded cache and the serve engine's counters are checked.  Inputs are
made from a seed with numpy.  Tolerances are the kernel's own
(``ref.TOL``, each with its reason): the plain version takes the
softmax's max per tile and per split, not once over the row, so single
weights round another way and the sums run in another order.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_partials,
                                                  decode_attention_ref)
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.models import build, get_config
from repro_torch.models import layers as L
from repro_torch.serve import ServeConfig, ServeEngine

SPLIT = 64          # two tiles a split: splits, tiles and merges all run
SMAX = 150          # a ragged last split and tile


def _close(got, want, dtype):
    atol, rtol = decode_ref.TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


def _inputs(seed, B, H, K, D, dtype, smax=SMAX, scale=1.0):
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.standard_normal((B, 1, H, D)).astype(np.float32))
    k, v = (torch.from_numpy(
        rng.standard_normal((B, smax, K, D)).astype(np.float32) * scale)
        for _ in range(2))
    return q.to(dtype), k.to(dtype), v.to(dtype)


#: Ragged lengths: empty, one, a whole split, a tile past it, the cache,
#: past the cache (a free slot's clock), and one inside the last split.
RAGGED = [0, 1, SPLIT, SPLIT + 32, SMAX, SMAX + 40, 97]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("lengths", ["ragged", "scalar", "tensor0d"])
def test_plain_split_combine_matches_decode_attention(lengths, G, D, dtype):
    K = 2
    q, k, v = _inputs(G * 10 + D, len(RAGGED), G * K, K, D, dtype)
    cache_len = {"ragged": torch.tensor(RAGGED, dtype=torch.int32),
                 "scalar": 117,
                 "tensor0d": torch.tensor(SMAX, dtype=torch.int32)}[lengths]
    want = L._decode_attention(q, k, v, cache_len)
    got = decode_attention_ref(q, k, v, cache_len, split_len=SPLIT)
    assert got.dtype == q.dtype and got.shape == want.shape
    _close(got, want, dtype)
    if lengths == "ragged":
        assert not got[0].any()                 # the empty prefix: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_plain_one_tile_is_the_plain_form(dtype):
    """One split of one tile: the same max, weights and sums as the
    plain form, so the outputs are equal but for the products' order."""
    q, k, v = _inputs(3, 4, 4, 2, 64, dtype, smax=decode_ref.TILE)
    lens = torch.tensor([0, 5, 31, 32], dtype=torch.int32)
    got = decode_attention_ref(q, k, v, lens, split_len=decode_ref.TILE)
    want = L._decode_attention(q, k, v, lens)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                               rtol=1e-6 if dtype == torch.float32 else 8e-3)


@pytest.mark.parametrize("cuts", [(75,), (50, 100), (32, 64, 96, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_partials_at_offsets_combine_to_the_whole(cuts, dtype):
    """A cache split by position over ranks: each rank's merged (m, l,
    acc) at its offset ``first``, merged over ranks as the sharded layer
    does, gives the whole cache's attention."""
    q, k, v = _inputs(7, len(RAGGED), 4, 2, 64, dtype)
    lens = torch.tensor(RAGGED, dtype=torch.int32)
    bounds = [0, *cuts, SMAX]
    parts = [decode_attention_partials(q, k[:, a:b], v[:, a:b], lens,
                                       first=a)
             for a, b in zip(bounds, bounds[1:])]
    m, l, acc = (torch.stack(x) for x in zip(*parts))
    _, L_, A = decode_ref.merge(m, l, acc)
    got = decode_ref.normalise(L_, A).to(q.dtype)
    whole = decode_attention(q, k, v, lens)
    _close(got, whole, dtype)
    _close(got, L._decode_attention(q, k, v, lens), dtype)
    # a rank past every row's prefix has nothing: (-inf, 0, 0)
    m0, l0, a0 = decode_attention_partials(q, k[:, :10], v[:, :10],
                                           torch.zeros_like(lens), first=0)
    assert torch.isneginf(m0).all() and not l0.any() and not a0.any()


def test_layer_combines_ranks_partials(monkeypatch):
    """The kernel path of the sharded layer: each rank's merged (m, l,
    acc) at its offset, combined over the ranks by ``mesh_reduce`` (max,
    then the rescaled sums).  The ranks run side by side here: the
    partials are stacked on a leading axis that the stand-in
    ``mesh_reduce`` reduces."""
    q, k, v = _inputs(11, len(RAGGED), 8, 2, 64, torch.float32)
    lens = torch.tensor(RAGGED, dtype=torch.int32)
    want = L._decode_attention_plain(q, k, v, lens)
    bounds = (0, 40, 100, SMAX)

    def ranks_partials(q_, k_, v_, cache_len, first):
        assert first == 0 and k_ is k
        parts = [decode_attention_partials(q_, k[:, a:b], v[:, a:b],
                                           cache_len, first=a)
                 for a, b in zip(bounds, bounds[1:])]
        return [torch.stack(x) for x in zip(*parts)]

    def reduce(x, op, axis):
        assert axis == "seq"
        return x.amax(dim=0) if op == "max" else x.sum(dim=0)
    monkeypatch.setattr(L.decode_kernel, "decode_attention_partials",
                        ranks_partials)
    monkeypatch.setattr(L, "mesh_reduce", reduce)
    got = L._decode_attention_kernel(q, k, v, lens, 0, "seq")
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    assert not got[0].any()


def test_wrapper_on_cpu_is_the_plain_version_and_launches_nothing():
    q, k, v = _inputs(5, 7, 4, 2, 64, torch.bfloat16)
    lens = torch.tensor(RAGGED, dtype=torch.int32)
    before = decode_ops.launches
    got = decode_attention(q, k, v, lens)
    split = decode_ops.device_split_len(q.device, 7, 2, 2, SMAX)
    assert decode_ops.launches == before
    assert torch.equal(got, decode_attention_ref(q, k, v, lens,
                                                 split_len=split))
    # q in another dtype than the caches: out in q's, rounded once
    got32 = decode_attention(q.float(), k, v, lens)
    assert got32.dtype == torch.float32
    assert torch.equal(got32, decode_attention_ref(
        q.float(), k, v, lens, split_len=split))


def test_layer_cpu_path_is_the_plain_form(monkeypatch):
    """``layers.decode_attention`` on the CPU never reaches the kernel's
    wrapper: its numerics are the plain form's, bit for bit."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path called the kernel's wrapper")
    monkeypatch.setattr(L.decode_kernel, "decode_attention", refuse)
    monkeypatch.setattr(L.decode_kernel, "decode_attention_partials", refuse)
    q, k, v = _inputs(9, 3, 4, 2, 64, torch.bfloat16)
    out = L.decode_attention(q, k, v, torch.tensor([3, 0, 150]))
    assert out.shape == q.shape


@pytest.mark.parametrize("make,err,match", [
    (lambda: _inputs(0, 2, 4, 2, 60, torch.float32), ValueError,
     "multiple of 8"),
    (lambda: _inputs(0, 2, 4, 2, 264, torch.float32), ValueError,
     "multiple of 8"),
    (lambda: _inputs(0, 2, 3, 2, 64, torch.float32), ValueError,
     "multiple of 2 kv"),
    (lambda: (torch.ones(2, 2, 4, 64), *_inputs(0, 2, 4, 2, 64,
                                               torch.float32)[1:]),
     ValueError, "want"),
    (lambda: tuple(t.double() for t in _inputs(0, 2, 4, 2, 64,
                                               torch.float32)),
     TypeError, "caches"),
    (lambda: (lambda q, k, v: (q, k, v.transpose(1, 2).contiguous()
                               .transpose(1, 2)))(
        *_inputs(0, 2, 4, 2, 64, torch.float32)), ValueError, "strides"),
])
def test_wrapper_rejects(make, err, match):
    q, k, v = make()
    with pytest.raises(err, match=match):
        decode_attention(q, k, v, 5)


def test_wrapper_rejects_lengths_of_another_batch():
    q, k, v = _inputs(0, 2, 4, 2, 64, torch.float32)
    with pytest.raises(ValueError, match="cache_len"):
        decode_attention(q, k, v, torch.tensor([1, 2, 3]))


def test_wrappers_are_custom_ops_with_the_plain_forms_flops():
    """Both entries go through the dispatcher as repro_torch:: ops with a
    fake implementation (the dry-run traces them on fake tensors), and
    the FLOP counter counts the plain form's two products."""
    from torch.utils.flop_counter import FlopCounterMode
    q, k, v = _inputs(1, 3, 4, 2, 64, torch.bfloat16)
    lens = torch.tensor([0, 7, 150], dtype=torch.int32)
    torch.library.opcheck(torch.ops.repro_torch.decode_attention.default,
                          (q, k, v, lens, 0, 0, SPLIT, False),
                          test_utils=("test_schema", "test_faketensor"))
    torch.library.opcheck(
        torch.ops.repro_torch.decode_attention_partials.default,
        (q, k, v, None, 40, 10, SPLIT),
        test_utils=("test_schema", "test_faketensor"))
    with FlopCounterMode(display=False) as counted:
        decode_attention(q, k, v, lens)
    assert counted.get_total_flops() == 4 * 3 * 4 * SMAX * 64


def test_split_starts_at_256_and_fills_the_card():
    # the chat pool: 64 rows x 8 kv heads, 2,560 positions
    assert decode_ops.split_len(64, 8, 2, 2560, 132) == 256
    # one row: halved until the grid gives every SM two blocks
    assert decode_ops.split_len(1, 8, 2, 4096, 132) == 64
    assert decode_ops.split_len(1, 1, 1, 100, 132) == decode_ref.TILE
    # a group of more than 8 q heads takes several blocks
    assert decode_ops.heads_a_block(6) == 8 and \
        decode_ops.heads_a_block(1) == 1
    assert decode_ops.split_len(1, 1, 16, 256 * 132, 132) == 256


def test_positions_read_rounds_up_to_the_split():
    # empty, one, a whole split, past it, the last split ends at smax,
    # a free slot's clock past the cache
    lens = torch.tensor([0, 1, 256, 257, 2500, 9000], dtype=torch.int32)
    want = [0, 256, 256, 512, 2560, 2560]
    assert decode_ref.positions_read(lens, 6, 0, 2560, 256).tolist() == want
    # at an offset: a rank's positions from ``first`` on
    assert decode_ref.positions_read(lens, 6, 200, 2560, 256).tolist() == \
        [0, 0, 256, 256, 2304, 2560]
    # each call reports them, and only while the log is open
    q, k, v = _inputs(4, 3, 4, 2, 64, torch.float32)
    decode_attention(q, k, v, 5)
    with decode_ops.logging_reads() as reads:
        decode_attention(q, k, v, torch.tensor([0, 70, 500]))
        decode_attention_partials(q, k, v, 100, first=40)
    split = decode_ops.device_split_len(q.device, 3, 2, 2, SMAX)
    assert [r.tolist() for r in reads] == [
        decode_ref.positions_read(n, 3, first, SMAX, split).tolist()
        for n, first in ((torch.tensor([0, 70, 500]), 0), (100, 40))]
    assert reads[0].dtype == torch.int32
    assert decode_ops._read_log is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16],
                         ids=["f32", "f16", "bf16"])
def test_tolerance_fails_a_split_left_out_or_misweighted(dtype):
    """The kernel's tolerance (``ref.TOL``) at its hardest row, 32,768
    positions whose outputs are some 0.009: the result with one of its
    128 splits left out, or with the splits merged unweighted, fails
    it."""
    smax = 32768
    q, k, v = _inputs(13, 1, 16, 8, 128, dtype, smax=smax)
    m, l, acc = decode_ref.split_partials(q, k, v, smax, split_len=256)
    good = decode_ref.normalise(*decode_ref.merge(m, l, acc)[1:]).to(dtype)
    atol, rtol = decode_ref.TOL[dtype]
    keep = torch.arange(m.shape[0]) != 64
    for l_, acc_ in (decode_ref.merge(m[keep], l[keep], acc[keep])[1:],
                     (l.sum(dim=0), acc.sum(dim=0))):
        bad = decode_ref.normalise(l_, acc_).to(dtype)
        assert not torch.allclose(bad.float(), good.float(), atol=atol,
                                  rtol=rtol)


def _engine(max_batch=3):
    cfg = get_config("llama3.2-1b").reduced().override(num_layers=2,
                                                       vocab_size=128)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    return ServeEngine(api, params, ServeConfig(
        max_batch=max_batch, max_len=64, prompt_buckets=(8, 16)))


def test_engine_clock_mirror_follows_free_slots():
    """Every slot's device clock moves on a step (``decode_step_ragged``
    returns ``pos + 1`` for every row), free ones too; the host mirror
    that ``engine.kv_read`` reads moves with it."""
    eng = _engine()
    rng = np.random.default_rng(0)
    for n, toks in ((5, 2), (9, 6), (3, 4)):
        eng.submit(rng.integers(1, 128, size=n), max_tokens=toks)
    steps = 0
    while eng.queue or any(s is not None for s in eng.slots) or steps < 12:
        eng.step()
        steps += 1
        assert eng._slot_pos == eng.cache["pos"].tolist()
    assert all(s is None for s in eng.slots)
