"""The models' attention on the card's kernels, on the CPU.

``kernels/flash_attention/ref.py`` holds the algorithm of the bf16
forward with its log-sum-exp and of its backward, tile by tile as the
kernels take them (GQA-native, rounding P and dS to bf16 where the
kernels do); the CUDA kernels run on the card only
(``tests/test_torch_cuda.py``).  Here that algorithm is held to the
plain scans the models run on the CPU (``layers._flash_fwd_scan``,
``_flash_bwd_scan``) and to autograd through ``naive_attention`` in
float32; the dispatch predicate, the autograd function's kernel branch
(through the operators' CPU kernels) and their FLOP counts are held to
the scans' too.

Tolerances: ``ref.TOL``, one table for these tests, the card's tests
and ``chip_smoke.py``: each output's largest gap in a row (a query of a
head, or a key of a kv head) as a share of the row's size, floored at
the tensor's root mean square (``ref.row_gap``), and lse's absolute gap.
Its reasons are in ``ref.py``; a key tile left out for late rows, or a
diagonal mask one off after the first tile, fails every entry of it
(:func:`test_tolerance_fails_a_dropped_key_tile_or_a_one_off_mask`).
"""
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels.flash_attention import ops, ref
from repro_torch.models import layers as L
from repro_torch.models import tracing

TOL = ref.TOL


def operands(B, S, H, K, D, seed=0, Sk=None):
    gen = torch.Generator().manual_seed(seed)
    Sk = S if Sk is None else Sk
    return tuple(torch.randn(s, generator=gen).bfloat16()
                 for s in ((B, S, H, D), (B, Sk, K, D), (B, Sk, K, D),
                           (B, S, H, D)))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [128, 384, 1024])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2, 4])
def test_backward_algorithm_matches_scans_and_autograd(G, D, S, causal):
    """``ref.py``'s forward and backward against the scans', each side on
    its own forward's out and lse, and its gradients against float32
    autograd through ``naive_attention``."""
    K = 2
    B = 2 if S < 1024 else 1
    q, k, v, do = operands(B, S, K * G, K, D, seed=G * 100 + D + S)
    c = min(S, 512)
    got = dict(zip(("out", "lse"), ref.flash_fwd_lse_ref(q, k, v, causal)))
    got.update(zip(("dq", "dk", "dv"), ref.flash_bwd_ref(
        q, k, v, got["out"], got["lse"], do, causal)))
    out, lse = L._flash_fwd_scan(q, k, v, causal, c, c, True)
    want = {"out": out.to(q.dtype), "lse": lse}
    want.update(zip(("dq", "dk", "dv"), L._flash_bwd_scan(
        q, k, v, want["out"], lse, do, causal, c, c, True)))
    for n in ("dq", "dk", "dv"):
        assert got[n].dtype == torch.bfloat16
        assert got[n].shape == want[n].shape
    assert ref.over(ref.gaps(got, want)) == {}
    qf, kf, vf = (t.float().requires_grad_() for t in (q, k, v))
    L.naive_attention(qf, kf, vf, causal=causal).backward(do.float())
    exact = {"dq": qf.grad, "dk": kf.grad, "dv": vf.grad}
    assert ref.over(ref.gaps({n: got[n] for n in exact}, exact)) == {}


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_forward_lse_contract_matches_the_scans(G, D, causal):
    """(out in q's type, lse float32 [B, H, Sq], natural log of the
    scaled scores' sum of exps), as ``_flash_fwd_scan`` returns them."""
    B, S, K = 2, 384, 2
    q, k, v, _ = operands(B, S, K * G, K, D, seed=5)
    out, lse = ref.flash_fwd_lse_ref(q, k, v, causal)
    s_out, s_lse = L._flash_fwd_scan(q, k, v, causal, 128, 128, True)
    assert out.dtype == q.dtype and out.shape == q.shape
    assert lse.dtype == s_lse.dtype == torch.float32
    assert lse.shape == s_lse.shape == (B, K * G, S)
    assert ref.row_gap(out, s_out) <= TOL["out"]
    assert ref.lse_gap(lse, s_lse) <= TOL["lse"]
    # the definition, in float64 over repeated kv heads
    kr = L.repeat_kv(k, K * G).double()
    sc = torch.einsum("bqhd,bshd->bhqs", q.double(), kr) / math.sqrt(D)
    if causal:
        sc = sc.masked_fill(torch.ones(S, S, dtype=torch.bool).triu(1),
                            float("-inf"))
    assert ref.lse_gap(lse.double(), sc.logsumexp(-1)) <= TOL["lse"]


def test_forward_lse_of_a_row_without_keys_is_inf():
    """Queries before every key under the kernels' top-left mask: out 0,
    lse +inf, the scans' contract for an empty row."""
    q, k, v, _ = operands(1, 8, 2, 1, 64)
    out, lse = ref.flash_fwd_lse_ref(q, k[:, :0], v[:, :0], True)
    assert torch.equal(out, torch.zeros_like(q))
    assert torch.isinf(lse).all() and (lse > 0).all()


@pytest.mark.parametrize("what,want", [
    ("bf16", True), ("float32", False), ("D160", False), ("D32", False),
    ("causal Sq < Sk", False), ("causal Sq > Sk", False),
    ("full Sq != Sk", True), ("no keys", False)])
def test_dispatch_predicate(what, want):
    """``kernels_fit``: bf16 at head size 64 or 128 with queries and keys,
    and Sq == Sk under the causal mask; ``takes_kernels`` adds a CUDA
    tensor, so every CPU (or meta) call takes the scans."""
    B, H, K, D, Sq, Sk, causal = 1, 4, 2, 64, 128, 128, True
    dtype = torch.bfloat16
    if what == "float32":
        dtype = torch.float32
    elif what.startswith("D"):
        D = int(what[1:])
    elif what == "causal Sq < Sk":
        Sk = 256
    elif what == "causal Sq > Sk":
        Sq = 256
    elif what == "full Sq != Sk":
        Sk, causal = 256, False
    elif what == "no keys":
        Sk = 0
    q = torch.zeros(B, Sq, H, D, dtype=dtype)
    k = v = torch.zeros(B, Sk, K, D, dtype=dtype)
    assert ops.kernels_fit(q, k, v, causal) is want
    assert ops.takes_kernels(q, k, v, causal) is False
    meta = (t.to("meta") for t in (q, k, v))
    assert ops.takes_kernels(*meta, causal) is False


def _both_paths(monkeypatch, fn):
    """``fn()`` on the scans, then on the kernels' branch: on the CPU the
    operators' CPU kernels, ``ref.py``."""
    plain = fn()
    monkeypatch.setattr(ops, "takes_kernels", ops.kernels_fit)
    return plain, fn()


@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("G", [1, 2])
def test_autograd_kernel_branch_matches_the_scans(monkeypatch, G, D):
    """``flash_attention_xla`` forward and backward on the kernels'
    branch (the ``_FlashAttention`` function, its saved lse, the GQA
    gradients on the kv heads) against the scans; ``flash.kernel`` reads
    1 at each of the two dispatch points, 0 on the scans."""
    q, k, v, do = operands(2, 256, 2 * G, 2, D, seed=9)

    def run():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        tracing.export()
        tracing.enable()
        try:
            out = L.flash_attention_xla(*leaves, chunk_q=128, chunk_k=128)
            out.backward(do)
        finally:
            tracing.disable()
        counts = [c["value"] for c in tracing.export()["counts"]
                  if c["name"] == "flash.kernel"]
        return out, [t.grad for t in leaves], counts

    (o_s, g_s, c_s), (o_k, g_k, c_k) = _both_paths(monkeypatch, run)
    assert c_s == [0, 0] and c_k == [1, 1]
    assert ref.row_gap(o_k, o_s) <= TOL["out"]
    for n, a, b in zip(("dq", "dk", "dv"), g_k, g_s):
        assert a.shape == b.shape and ref.row_gap(a, b) <= TOL[n], n


def test_kernel_branch_writes_no_lse_without_grad(monkeypatch):
    """Under no grad (prefill) the forward asks for no lse; the
    launches counters do not move on the CPU."""
    monkeypatch.setattr(ops, "takes_kernels", ops.kernels_fit)
    q, k, v, _ = operands(1, 128, 4, 2, 128)
    launches = dict(ops.launches_by_variant)
    with torch.no_grad():
        out, lse = L._flash_fwd(q, k, v, True, 128, 128, True, False)
        assert lse is None
        assert torch.equal(L.flash_attention_xla(q, k, v, chunk_q=128,
                                                 chunk_k=128), out)
    assert ops.launches_by_variant == launches
    assert L._flash_fwd(q, k, v, True, 128, 128, True)[1].shape == \
        (1, 4, 128)


@pytest.mark.parametrize("causal,chunk", [(True, 128), (True, 256),
                                          (False, 128)])
def test_flop_counts_equal_the_scans(monkeypatch, causal, chunk):
    """The operators count their own work, whatever the scans' chunks:
    two products a kept (query, key) pair forward, five and delta's row
    sums backward.  Without the mask that equals the scans' count; under
    it the scans count the diagonal chunks' masked halves too, and the
    operators fewer."""
    B, S, H, K, D = 1, 512, 4, 2, 64
    q, k, v, do = operands(B, S, H, K, D, seed=3)

    def count():
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        with FlopCounterMode(display=False) as counter:
            L.flash_attention_xla(*leaves, causal=causal, chunk_q=chunk,
                                  chunk_k=chunk).backward(do)
        return counter.get_total_flops()

    plain, kernels = _both_paths(monkeypatch, count)
    pairs = S * (S + 1) // 2 if causal else S * S
    assert ops.kept_pairs(S, S, causal) == pairs
    assert kernels == 14 * B * H * D * pairs + 2 * B * S * H * D
    assert kernels == plain if not causal else kernels < plain


def _fake_cuda(mode, shape):
    from torch._subclasses.fake_tensor import FakeTensor
    return FakeTensor(mode, torch.empty(shape, dtype=torch.bfloat16,
                                        device="meta"),
                      torch.device("cuda", 0))


def test_fake_cuda_tensors_take_the_kernels_operators():
    """A trace's fake CUDA tensors (the dry run's) take the kernels'
    branch at both dispatch points, through the operators' Meta kernels,
    as the card does, so a traced step counts the FLOPs a real one does.
    (The autograd engine wants a card for CUDA tensors, so the backward
    is called here directly.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    B, S, H, K, D = 1, 256, 4, 2, 128
    mode = FakeTensorMode()
    q, do = (_fake_cuda(mode, (B, S, H, D)) for _ in range(2))
    k, v = (_fake_cuda(mode, (B, S, K, D)) for _ in range(2))
    assert ops.takes_kernels(q, k, v, True)
    launches = dict(ops.launches_by_variant)
    tracing.export()
    tracing.enable()
    try:
        with mode, FlopCounterMode(display=False) as counter:
            with torch.no_grad():
                out = L.flash_attention_xla(q, k, v, chunk_q=128,
                                            chunk_k=128)
            fwd = counter.get_total_flops()
            o, lse = L._flash_fwd_scan(q, k, v, True, 128, 128, True)
            grads = L._flash_bwd_scan(q, k, v, o, lse, do, True, 128, 128,
                                      True)
    finally:
        tracing.disable()
    counts = [c["value"] for c in tracing.export()["counts"]
              if c["name"] == "flash.kernel"]
    assert counts == [1, 1, 1]
    assert out.device.type == "cuda" and out.shape == q.shape
    assert lse.shape == (B, H, S)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert ops.launches_by_variant == launches
    pairs = S * (S + 1) // 2
    assert fwd == 4 * B * H * D * pairs
    assert counter.get_total_flops() == \
        2 * fwd + 10 * B * H * D * pairs + 2 * B * S * H * D


def _drop_a_key_tile(S):
    """``ref._keep`` leaving out keys 128..255 for the last quarter of
    the rows."""
    keep = ref._keep

    def mutant(q0, nq, k0, nk, causal, device):
        q_pos = torch.arange(q0, q0 + nq, device=device)[:, None]
        k_pos = torch.arange(k0, k0 + nk, device=device)[None, :]
        return keep(q0, nq, k0, nk, causal, device) & ~(
            (q_pos >= 3 * S // 4) & (k_pos >= 128) & (k_pos < 256))
    return mutant


def _one_off_after_the_first_tile(S):
    """``ref._keep`` under the causal mask keeping one key past the
    diagonal for every query after the first tile of 128."""
    def mutant(q0, nq, k0, nk, causal, device):
        q_pos = torch.arange(q0, q0 + nq, device=device)[:, None]
        k_pos = torch.arange(k0, k0 + nk, device=device)[None, :]
        return k_pos <= q_pos + (q_pos >= 128).long()
    return mutant


@pytest.mark.parametrize("fault,D,causal", [
    ("dropped key tile", 64, True), ("dropped key tile", 128, True),
    ("dropped key tile", 128, False), ("one-off mask", 64, True),
    ("one-off mask", 128, True)])
def test_tolerance_fails_a_dropped_key_tile_or_a_one_off_mask(
        monkeypatch, fault, D, causal):
    """``ref.py`` with a fault planted in its mask, forward and backward,
    against the scans: every entry of ``ref.TOL`` fails, where the
    unplanted algorithm passes them all
    (:func:`test_backward_algorithm_matches_scans_and_autograd`)."""
    B, S, H, K = 1, 1024, 4, 2
    q, k, v, do = operands(B, S, H, K, D, seed=11)
    out, lse = L._flash_fwd_scan(q, k, v, causal, 512, 512, True)
    want = {"out": out.to(q.dtype), "lse": lse}
    want.update(zip(("dq", "dk", "dv"), L._flash_bwd_scan(
        q, k, v, want["out"], lse, do, causal, 512, 512, True)))
    plant = {"dropped key tile": _drop_a_key_tile,
             "one-off mask": _one_off_after_the_first_tile}[fault]
    monkeypatch.setattr(ref, "_keep", plant(S))
    got = dict(zip(("out", "lse"), ref.flash_fwd_lse_ref(q, k, v, causal)))
    got.update(zip(("dq", "dk", "dv"), ref.flash_bwd_ref(
        q, k, v, got["out"], got["lse"], do, causal)))
    assert set(ref.over(ref.gaps(got, want))) == set(TOL)
