"""The arithmetic of float32 attention on the tensor cores, on the CPU.

A 3xTF32 split, the standard way to get float32 accuracy from TF32
tensor cores, splits each float32 operand into two TF32 parts, a = a_hi
+ a_lo, each rounded to nearest at bit 13 (``cvt.rna.tf32.f32``), and
takes a.b as a_lo.b_hi + a_hi.b_lo + a_hi.b_hi.  Here the same split is
made by masking the float32 bits, the three products of TF32 values are
exact in float32, and the attention runs in the formulation a
tensor-core body would use (log2(e) folded into the scale, exp2).  At
unit-scale inputs the split holds the reference's atol = rtol = 2e-5
where one TF32 product misses it.  With inputs x4 the scores reach tens,
and there float32 attention itself lies more than 2e-5 from the float64
attention: the split is then as far from float64 as the float32
reference is, but not within 2e-5 of the reference.  That is why float32
calls run on the CUDA cores (the ``ffma`` body of
``csrc/flash_attention.cu``: each score one fmaf chain over d, the
reference's own order; held on the card by tests/test_torch_cuda.py).
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_ref

TOL = 2e-5


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 explicit mantissa bits), to nearest with
    ties away from zero: add half of the 13 dropped bits, then mask."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _product(a, b, terms: int):
    a_hi, b_hi = _tf32(a), _tf32(b)
    if terms == 1:
        return a_hi @ b_hi
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _attention(q, k, v, causal: bool, terms: int):
    """q [B,Sq,H,D], k/v [B,Sk,K,D]; both products as ``terms`` TF32
    products (1, or 3 for the split)."""
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qh = q.transpose(1, 2)
    kh, vh = (t.repeat_interleave(H // K, 2).transpose(1, 2) for t in (k, v))
    s = _product(qh, kh.transpose(-1, -2), terms) * (math.log2(math.e)
                                                     / math.sqrt(D))
    if causal:
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool).triu(1),
                          -math.inf)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    return (_product(p, vh, terms) / p.sum(-1, keepdim=True)).transpose(1, 2)


def _attention_f64(q, k, v, causal: bool):
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    kr, vr = (t.double().repeat_interleave(H // K, 2) for t in (k, v))
    s = torch.einsum("bqhd,bshd->bhqs", q.double(), kr) / math.sqrt(D)
    if causal:
        s = s.masked_fill(torch.ones(Sq, Sk, dtype=torch.bool).triu(1),
                          -math.inf)
    return torch.einsum("bhqs,bshd->bqhd", torch.softmax(s, -1), vr)


def _units(got, want):
    """Largest |got - want| in units of atol + rtol |want| at 2e-5."""
    return ((got.double() - want.double()).abs()
            / (TOL + TOL * want.double().abs())).max().item()


def _operands(B, S, H, K, D, scale, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32)
                                  * np.float32(scale))
                 for s in ((B, S, H, D), (B, S, K, D), (B, S, K, D)))


@pytest.mark.parametrize("x,want", [
    (1.0, 1.0), (1.0 + 2 ** -10, 1.0 + 2 ** -10),
    (1.0 + 2 ** -11, 1.0 + 2 ** -10),            # a tie rounds away
    (1.0 + 2 ** -11 - 2 ** -23, 1.0),             # below the tie: down
    (-(1.0 + 3 * 2 ** -12), -(1.0 + 2 ** -10)), (0.0, 0.0)])
def test_tf32_rounding(x, want):
    got = _tf32(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("B,S,H,K,D,causal", [
    (2, 256, 4, 2, 64, True), (2, 512, 4, 2, 64, True),
    (2, 1024, 4, 2, 64, True),        # the nn scope's float32 rows
    (1, 4096, 2, 1, 128, True)])
def test_tf32x3_holds_the_float32_tolerance(B, S, H, K, D, causal):
    q, k, v = _operands(B, S, H, K, D, 1.0)
    ref = flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(_attention(q, k, v, causal, 3), ref,
                               atol=TOL, rtol=TOL)
    assert _units(_attention(q, k, v, causal, 1), ref) > 1.0


@pytest.mark.parametrize("D", [64, 128])
def test_tf32x3_at_large_scores(D):
    """Inputs x4: float32 attention is itself more than 2e-5 from
    float64; the split stays within twice the reference's distance from
    float64, one TF32 product does not, and the split is not within 2e-5
    of the reference."""
    q, k, v = _operands(1, 4096, 2, 1, D, 4.0, seed=1)
    ref = flash_attention_ref(q, k, v, causal=True)
    exact = _attention_f64(q, k, v, True)
    ref_units = _units(ref, exact)
    assert ref_units > 1.0
    split = _attention(q, k, v, True, 3)
    assert _units(split, exact) <= 2.0 * ref_units
    assert _units(split, ref) > 1.0
    assert _units(_attention(q, k, v, True, 1), exact) > 2.0 * ref_units
