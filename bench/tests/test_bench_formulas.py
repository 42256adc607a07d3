"""The FLOP and byte counts against hand counts."""
import json

from bench.lib import spec
from bench.lib.trace import gemm_least_seconds
from bench.reference import dense, mamba2

PEAKS = spec.peaks("NVIDIA H100 80GB HBM3")


def _model(name):
    c = spec.read_json(spec.BENCH / "configs" / f"{name}.json")
    return {**c["model"], **c["policy"]}


def test_internlm2_parameters_and_flops():
    m = _model("internlm2-1.8b")
    d, L, V, ff = 2048, 24, 92544, 8192
    layer = 2 * d + d * 2048 + 2 * d * 1024 + 2048 * d + 3 * d * ff
    total = 2 * V * d + L * layer + d
    assert total == 1_889_110_016
    n = total - V * d                      # the input lookup is no product
    attn = 3 * 2 * 4 * 4096 * 4096 * 16 * 128 * L
    assert dense.train_flops(m, 4, 4096) == 6 * n * 4 * 4096 + attn
    assert abs(dense.train_flops(m, 4, 4096) - 1.87e14) < 0.01e14
    assert dense.weight_bytes(m) == 2 * n
    assert dense.kv_bytes_per_token(m) == 2 * 24 * 8 * 128 * 2


def test_mamba2_parameters_and_flops():
    m = _model("mamba2-780m")
    d, L, V, di, H, N, P, Q = 1536, 48, 50288, 3072, 48, 128, 64, 128
    layer = (d + d * (2 * di + 2 * N + H) + 4 * (di + 2 * N) + 3 * H
             + di + di * d)
    n = V * d + L * layer + d              # tied: the table is the head
    assert sum(__import__("math").prod(s) for _, s, _ in
               mamba2.leaves(m)) == n
    T = 8 * 4096
    pairs = T // Q * Q * (Q + 1) // 2
    ssd = 2 * pairs * N + 2 * pairs * H * P + 4 * T * H * P * N
    assert mamba2.train_flops(m, 8, 4096) == 6 * n * T + 3 * ssd * L


def test_gemm_least_time_by_hand():
    mm = {"op": "aten::mm", "shapes": [[4096, 2048], [2048, 8192]],
          "dtypes": ["c10::BFloat16", "c10::BFloat16"], "device_s": 1.0}
    flops = 2 * 4096 * 2048 * 8192
    assert gemm_least_seconds(mm, PEAKS, False) == flops / 989e12
    small = {"op": "aten::mm", "shapes": [[64, 2048], [2048, 2048]],
             "dtypes": ["c10::BFloat16", "c10::BFloat16"], "device_s": 1.0}
    nbytes = 2 * (64 * 2048 + 2048 * 2048 + 64 * 2048)
    assert gemm_least_seconds(small, PEAKS, False) == nbytes / 3.35e12
    bmm = {"op": "aten::bmm", "shapes": [[64, 512, 128], [64, 128, 512]],
           "dtypes": ["float", "float"], "device_s": 1.0}
    f = 2 * 64 * 512 * 512 * 128
    assert gemm_least_seconds(bmm, PEAKS, False) == f / 67e12
    b = 4 * 64 * (512 * 128 * 2 + 512 * 512)
    assert gemm_least_seconds(bmm, PEAKS, True) == max(f / 495e12,
                                                       b / 3.35e12)
    addmm = {"op": "aten::addmm", "shapes": [[8], [4, 16], [16, 8], [], []],
             "dtypes": ["float", "float", "float", "Scalar", "Scalar"],
             "device_s": 1.0}
    by = 4 * (4 * 16 + 16 * 8 + 4 * 8 + 8)
    assert gemm_least_seconds(addmm, PEAKS, False) == by / 3.35e12


def test_unlisted_card_is_refused():
    import pytest
    with pytest.raises(KeyError):
        spec.peaks("NVIDIA A100-SXM4-80GB")
    assert json.dumps(PEAKS)
