"""The SSD chunk kernel's host-side choices, without a card: which variant
a shape takes (``ops.variant``), how many heads a block takes
(``ops.head_group``), and why its cumsum adds in sequence.

The kernel itself runs on the card only (``tests/test_torch_cuda.py``);
its plain version is held against the Pallas kernel in
``tests/test_torch_nn_kernels.py``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ops as ssd_ops

H100_SMS = 132


@pytest.mark.parametrize("chunk,p,n,want", [
    (128, 64, 64, "tiled_n64"),     # the nn scope's ssd_scan_cuda rows
    (128, 64, 128, "tiled_n128"),   # the mamba2 family's SSD layers
    (128, 24, 40, "tiled_n64"),     # ragged widths
    (96, 64, 65, "tiled_n128"),
    (8, 8, 16, "tiled_n64"),
    (32, 8, 0, "tiled_n64"),
])
def test_variant_by_shape(chunk, p, n, want):
    assert ssd_ops.variant(chunk, p, n) == want


@pytest.mark.parametrize("chunk,p,n", [(256, 64, 128), (512, 64, 128),
                                       (128, 65, 64), (128, 64, 129)])
def test_variant_refuses_what_no_tile_holds(chunk, p, n):
    with pytest.raises(ValueError, match="shared memory"):
        ssd_ops.variant(chunk, p, n)


def test_every_shape_within_the_tiles_maps_to_the_narrowest_variant():
    sizes = sorted(ssd_ops.STATE_SIZES.items(), key=lambda kv: kv[1])
    for chunk, p, n in itertools.product((1, 8, 96, 127, 128),
                                         (0, 1, 7, 24, 63, 64),
                                         (0, 1, 13, 64, 65, 127, 128)):
        which = ssd_ops.variant(chunk, p, n)
        assert which == next(name for name, most in sizes if n <= most)
        assert which in ssd_ops.launches_by_variant


@pytest.mark.parametrize("b,l,h,want", [
    (2, 1024, 4, 1),     # nn scope, seq 1024: 16 chunks x 4 heads
    (2, 4096, 4, 1),     # nn scope, seq 4096: 64 (batch, chunk) pairs
    (1, 4096, 48, 4),    # mamba2-780m's SSD layer: 32 pairs -> 384 blocks
    (8, 512, 48, 4),     # its widths at a short length, batch 8
    (1, 512, 48, 1),     # 4 pairs: no group fills 264 blocks
    (4, 4096, 5, 2),     # 5 heads in groups of 2: a last group of one
    (64, 4096, 3, 2),    # never a group wider than the heads
    (64, 4096, 48, 8),
])
def test_head_group_at_an_h100(b, l, h, want):
    assert ssd_ops.head_group(b, l // 128, h, H100_SMS) == want


def test_head_group_is_the_largest_that_fills_the_card():
    for pairs, h, sms in itertools.product((1, 4, 32, 64, 100, 400),
                                           (1, 2, 3, 5, 8, 24, 48, 64),
                                           (1, 66, 132)):
        G = ssd_ops.head_group(1, pairs, h, sms)
        assert G in (1, 2, 4, 8) and (G == 1 or G <= h)

        def fills(g):
            return pairs * -(-h // g) >= ssd_ops.BLOCKS_PER_SM * sms
        if G > 1:
            assert fills(G)
        if 2 * G <= min(h, ssd_ops.MAX_GROUP):
            assert not fills(2 * G)


def _sequential(a):
    """The kernel's order: float32 adds in sequence (torch.cumsum's along
    a non-innermost axis on the card)."""
    out = np.empty_like(a)
    run = np.zeros(a.shape[:-1], np.float32)
    for i in range(a.shape[-1]):
        run = (run + a[..., i]).astype(np.float32)
        out[..., i] = run
    return out


def _warp_scan(a):
    """A warp scan's order: 32 lanes of Q/32 consecutive terms each, then
    a Kogge-Stone scan of the lanes' sums by shuffles."""
    lanes = a.reshape(*a.shape[:-1], 32, -1)
    local = _sequential(lanes)
    tot = local[..., -1].copy()
    d = 1
    while d < 32:
        shifted = np.zeros_like(tot)
        shifted[..., d:] = tot[..., :-d]
        tot = (tot + shifted).astype(np.float32)
        d *= 2
    before = np.zeros_like(tot)
    before[..., 1:] = tot[..., :-1]
    return (local + before[..., None]).astype(np.float32).reshape(a.shape)


def _y_intra(cs, dt, cb, x):
    Q = cs.shape[-1]
    keep = torch.tril(torch.ones(Q, Q, dtype=torch.bool))
    diff = (cs[:, None] - cs[None, :]).masked_fill(~keep, float("-inf"))
    return (cb * torch.exp(diff) * dt[None, :]) @ x


@pytest.mark.parametrize("scale,misses", [(1.0, False), (8.0, True)])
def test_a_warp_scan_would_miss_the_tolerance_at_large_decay(scale, misses):
    """Why the kernel's cumsum adds in sequence: with dt x8 (in-chunk
    cumsums near -800, float32 spacing 6e-5 there) a warp scan's
    exponent differences move y by more than atol = rtol = 3e-5 from
    the sequential order's, on chunks of mamba2-780m's widths."""
    rng = np.random.default_rng(0)
    Q, N, P, tol = 128, 128, 64, 3e-5
    worst = 0.0
    for _ in range(4):
        dt = (np.log1p(np.exp(rng.standard_normal(Q))) * scale).astype(
            np.float32)
        A = np.float32(-np.exp(rng.standard_normal() * 0.3))
        a = (dt * A).astype(np.float32)
        f = lambda v: torch.from_numpy(v.astype(np.float32))  # noqa: E731
        cb = f(rng.standard_normal((Q, N)) * 0.3) @ f(
            rng.standard_normal((Q, N)) * 0.3).T
        x = f(rng.standard_normal((Q, P)) * 0.4)
        want = _y_intra(f(_sequential(a)), f(dt), cb, x)
        got = _y_intra(f(_warp_scan(a)), f(dt), cb, x)
        worst = max(worst, ((got - want).abs()
                            / (tol + tol * want.abs())).max().item())
    assert (worst > 1.0) == misses
