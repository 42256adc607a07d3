"""The metric readers over a canned record and a canned profile."""
from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from bench.lib import spec
from bench.lib.trace import _gaps, device_profile, merge_device, read_profile

PEAKS = spec.peaks("NVIDIA H100 80GB HBM3")


class Ev:
    def __init__(self, name, start, dur, dev=False, corr=0, link=0,
                 shapes=(), dtypes=(), tid=1):
        self._n, self._s, self._d, self._dev = name, start, dur, dev
        self._c, self._l, self._sh, self._dt, self._t = (corr, link, shapes,
                                                         dtypes, tid)

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return self._l

    def shapes(self):
        return list(self._sh)

    def dtypes(self):
        return list(self._dt)

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._n.startswith("bench.")


def _prof(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def canned():
    """A 1,000 ns step: a bf16 mm whose kernel runs 100..400, an add
    whose kernel runs 500..600; the host is in the add from 450 to 700."""
    mm_shapes = ([1024, 1024], [1024, 1024])
    return _prof([
        Ev("bench.step.0", 0, 1000),
        Ev("bench.step.1", 5000, 10),               # not kept
        Ev("aten::mm", 50, 100, corr=7, shapes=mm_shapes,
           dtypes=("c10::BFloat16", "c10::BFloat16")),
        Ev("aten::add", 450, 250, corr=8),
        Ev("gemm_kernel", 100, 300, dev=True, link=7),
        Ev("add_kernel", 500, 100, dev=True, link=8),
        Ev("other_kernel", 5000, 5, dev=True, link=9),
        Ev("bench.step.0", 90, 600, dev=True),      # the range's mirror
    ])


def test_trace_reading():
    t = read_profile(canned(), lambda n: n == "bench.step.0")
    assert t["device_ops"][0] == ["aten::mm", pytest.approx(300e-9)]
    assert t["device_ops"][1] == ["aten::add", pytest.approx(100e-9)]
    assert len(t["device_ops"]) == 2          # other_kernel is outside
    assert t["gemms"] == [{"op": "aten::mm",
                           "shapes": [[1024, 1024], [1024, 1024]],
                           "dtypes": ["c10::BFloat16", "c10::BFloat16"],
                           "device_s": pytest.approx(300e-9)}]


def test_idle_gaps_are_named_by_the_host_event_at_their_middle():
    spans = [(100, 400), (500, 600)]
    cpu = [Ev("aten::mm", 50, 100), Ev("aten::add", 450, 250),
           Ev("cudaLaunchKernel", 460, 20)]
    gaps = dict(_gaps(spans, [(0, 1000)], cpu, "(outside)"))
    # 0..100 (mm at 50), 400..500 (add at 450), 600..1000 (none at 800)
    assert gaps == {"aten::mm": pytest.approx(100e-9),
                    "aten::add": pytest.approx(100e-9),
                    "(outside)": pytest.approx(400e-9)}
    # the innermost event wins: a launch inside the add at the middle
    gaps = dict(_gaps([(100, 440), (480, 600)], [(100, 600)], cpu, "-"))
    assert gaps == {"cudaLaunchKernel": pytest.approx(40e-9)}


def test_device_summaries_merge():
    a = {"wall_s": 1.0, "busy_s": 0.9, "kernels": 3,
         "idle_gaps": [["x", 0.05], ["y", 0.05]]}
    b = {"wall_s": 2.0, "busy_s": 1.5, "kernels": 4, "idle_gaps": [["x", 0.5]]}
    m = merge_device([a, b])
    assert m["window_s"] == 3.0 and m["busy_s"] == 2.4 and m["kernels"] == 7
    assert m["idle_gaps"] == [["x", 0.55], ["y", 0.05]]
    out, summary = device_profile(lambda: 41 + 1)
    assert out == 42 and summary["wall_s"] > 0


def test_trace_readers():
    t = read_profile(canned(), lambda n: n == "bench.step.0")
    t.update(window_s=1000e-9, busy_s=400e-9)
    rec = {"trace": t, "peaks": PEAKS, "tf32": False}
    least = max(2 * 1024 ** 3 / 989e12, 2 * 3 * 1024 ** 2 / 3.35e12)
    assert spec.reader("gemm_roofline.train")(rec) == pytest.approx(
        100 * least / 300e-9)
    assert spec.reader("idle_share.serve")(rec) == pytest.approx(60.0)
    assert spec.reader("idle_share.train")({"peaks": PEAKS}) is None
    assert spec.reader("gemm_roofline.serve")({"peaks": PEAKS}) is None


def test_train_readers():
    steps = [{"start": 2.0 * i, "end": 2.0 * i + 2.0, "loss": 1.0,
              "profiled": i == 2} for i in range(6)]
    rec = {"window_s": 11.0, "steps": steps, "tokens_per_step": 100,
           "model_flops_per_step": 989e12, "peaks": PEAKS,
           "window_peak_bytes": 3 * 2 ** 30, "setup_s": 7.5}
    # five steps end inside the window, the last of them at 10 s
    assert spec.reader("train_tokens_per_s")(rec) == pytest.approx(50.0)
    # four unprofiled steps of 2 s each, one peak-second of work each
    assert spec.reader("mfu.train")(rec) == pytest.approx(50.0)
    assert spec.reader("peak_mem_gib.train")(rec) == pytest.approx(3.0)
    assert spec.reader("setup_s")(rec) == 7.5


def test_serve_readers():
    reqs = [
        # first token at 1.0 (due 0.5), then tokens at 1.1, 1.2, 1.3
        {"due": 0.5, "first": 1.0, "stamps": [1.1, 1.2, 1.3]},
        # due at 9, no first token by the window's close at 10
        {"due": 9.0, "first": None, "stamps": []},
        # first token after the close
        {"due": 8.0, "first": 10.5, "stamps": [10.6]},
        # two tokens inside, one after
        {"due": 2.0, "first": 2.5, "stamps": [3.5, 10.2]},
    ]
    steps = [
        {"start": 0.0, "end": 0.1, "admitted": 0, "prefill_s": [],
         "kv_positions": 100, "profiled": False},
        {"start": 1.0, "end": 1.3, "admitted": 2, "prefill_s": [0.1, 0.2],
         "kv_positions": 0, "profiled": False},
        {"start": 2.0, "end": 2.1, "admitted": 0, "prefill_s": [],
         "kv_positions": 300, "profiled": False},
        {"start": 3.0, "end": 3.5, "admitted": 0, "prefill_s": [],
         "kv_positions": 9, "profiled": True},
    ]
    rec = {"window_s": 10.0, "requests": reqs, "steps": steps,
           "peaks": PEAKS, "weight_bytes": 1e9, "kv_bytes_per_token": 1e6,
           # requests in flight when the window opened: 3 tokens inside
           "carried": [[0.1, 0.2], [9.9, 10.1]]}
    waits = sorted([0.5, 1.0, 2.0, 0.5])      # (10 - 9), (10 - 8)
    assert spec.reader("ttft_p90_ms")(rec) == pytest.approx(
        1e3 * (waits[2] + 0.7 * (waits[3] - waits[2])))
    tp = sorted([0.1, 1.0])
    assert spec.reader("tpot_p90_ms")(rec) == pytest.approx(
        1e3 * (tp[0] + 0.9 * (tp[1] - tp[0])))
    assert spec.reader("serve_tokens_per_s")(rec) == pytest.approx(0.9)
    assert spec.reader("decode_step_ms.serve")(rec) == pytest.approx(100.0)
    assert spec.reader("decode_step_ms.overload")(rec) == pytest.approx(100.0)
    assert spec.reader("prefill_ms.serve")(rec) == pytest.approx(150.0)
    need = (2e9 + 1e6 * 400) / 3.35e12
    assert spec.reader("mfu_hbm.serve")(rec) == pytest.approx(
        100 * need / 0.2)
