"""The program's spans put down to the device's time, and their readers,
over canned spans and launches; then a tiny cell's run with the tracer
on, on the CPU."""
import time

import pytest
import torch

from conftest import tiny_cell
from test_bench_readers import Ev, _prof
from bench.lib import spans as sp
from bench.lib import spec, trace

PEAKS = spec.peaks("NVIDIA H100 80GB HBM3")


def S(id_, name, start, end, parent=None, tid=1, uid=None):
    return {"id": id_, "name": name, "start": start, "end": end,
            "parent": parent, "tid": tid, "uid": uid}


#: A step on two threads: the backward's regions run on thread 2, which
#: adopted ``backward`` (thread 1) as the parent of its first span.
STEP = [S(1, "train_step", 0, 1000),
        S(2, "forward", 0, 300, 1), S(3, "mlp", 50, 250, 2),
        S(4, "backward", 300, 800, 1),
        S(5, "mlp.bwd", 350, 600, 4, tid=2),
        S(6, "_flash_bwd_scan", 450, 550, 5, tid=2),
        S(7, "adamw_update", 800, 990, 1)]


def test_kernels_go_to_the_innermost_span_open_at_their_launch():
    launches = [(120, 220, 100),         # mlp
                (200, 260, 240),         # mlp, overlapping the first
                (410, 500, 400),         # mlp.bwd (thread 2)
                (560, 600, 500),         # _flash_bwd_scan
                (650, 700, 640),         # none open on thread 2: backward
                (820, 900, 810),         # adamw_update
                (950, 960, None)]        # no launch found
    attr = sp.attribute(STEP, [{"launches": launches, "gaps": []}])
    by = attr["by_span"]
    assert by["mlp"]["launches"] == 2 and by["mlp"]["self_s"] == 140e-9
    assert by["mlp.bwd"]["self_s"] == 90e-9
    assert by["_flash_bwd_scan"]["self_s"] == 40e-9
    assert by["backward"]["self_s"] == 50e-9
    assert by["adamw_update"]["self_s"] == 80e-9
    assert by[sp.NO_SPAN]["launches"] == 1
    # under a span: its own kernels and its descendants'
    assert by["mlp.bwd"]["device_s"] == pytest.approx(130e-9)
    assert by["backward"]["device_s"] == pytest.approx(180e-9)
    assert by["train_step"]["device_s"] == pytest.approx(400e-9)
    assert attr["busy_s"] == pytest.approx(410e-9)
    assert attr["covered_s"] == pytest.approx(400e-9)


def test_idle_goes_to_the_span_open_at_its_middle():
    gaps = [(260, 300, True),            # forward
            (610, 640, True),            # backward (thread 1), nothing on 2
            (700, 810, False),           # backward, inside a CUDA call
            (900, 950, True),            # adamw_update
            (995, 1000, True)]           # the root
    attr = sp.attribute(STEP, [{"launches": [(0, 1, 0)],
                                "gaps": gaps}])
    by = attr["by_span"]
    assert by["forward"]["idle_outside_s"] == pytest.approx(40e-9)
    assert by["backward"]["idle_s"] == pytest.approx(140e-9)
    assert by["backward"]["idle_outside_s"] == pytest.approx(30e-9)
    assert by["train_step"]["idle_s"] == pytest.approx(5e-9)
    assert attr["idle_outside_s"] == pytest.approx(125e-9)
    assert attr["idle_outside_below_root_s"] == pytest.approx(120e-9)
    # the host's own time: a span's wall less its children's
    assert by["train_step"]["host_self_s"] == pytest.approx(10e-9)
    assert by["mlp.bwd"]["host_self_s"] == pytest.approx(150e-9)


def test_overlapping_regions_give_the_latest_begun_open_span():
    spans = [S(1, "a", 0, 100), S(2, "b", 10, 50, 1), S(3, "c", 20, 80, 2),
             S(4, "d", 30, 40, 3)]
    got = sp.innermost(spans, [35, 45, 90, 60, 200])
    assert [g and g["name"] for g in got] == ["d", "c", "a", "c", None]


def test_the_profile_keeps_the_summary_and_adds_launches():
    def fn():
        return torch.ones(64, 64) @ torch.ones(64, 64)
    out, summary = sp.device_profile(fn)
    _, plain = trace.device_profile(fn)
    assert set(summary) == set(plain) | {"launches", "gaps"}
    assert out.shape == (64, 64)


def test_a_canned_profile_links_kernels_to_their_launches(monkeypatch):
    events = [Ev("cudaLaunchKernel", 100, 10, corr=7, tid=11),
              Ev("cudaLaunchKernel", 300, 50, corr=8, tid=12),
              Ev("k1", 150, 100, dev=True, corr=7),
              Ev("k2", 400, 50, dev=True, corr=8),
              Ev("k3", 500, 50, dev=True, corr=99)]
    import torch.profiler as tp

    class Profile:
        def __init__(self, **kwargs):
            self.profiler = _prof(events).profiler

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(tp, "profile", Profile)
    _, summary = sp.device_profile(lambda: None)
    assert summary["launches"] == [(150, 250, 100), (400, 450, 300),
                                   (500, 550, None)]
    # idle 100..150 and 450..500 outside any CUDA call, 250..400 with
    # the host in a launch at its middle
    assert summary["gaps"] == [(100, 150, True), (250, 400, False),
                               (450, 500, True)]


def _rec(by_span=None, busy=1.0, spans=(), counts=()):
    rec = {"spans": {"spans": list(spans), "counts": list(counts)}}
    if by_span is not None:
        rec["trace"] = {"busy_s": busy, "by_span": {
            k: {"device_s": v} for k, v in by_span.items()}}
    return rec


def test_the_device_readers():
    rec = _rec({"_flash_fwd_scan": 0.2, "_flash_bwd_scan": 0.4,
                "ssd_chunked": 0.1, "ssd_chunked.bwd": 0.3,
                "clip_by_global_norm": 0.01, "adamw_update": 0.09,
                "chunked_loss": 0.02, "chunked_loss.bwd": 0.03,
                "decode_attention": 0.8}, busy=2.0)
    assert sp.flash_scan_share(rec) == pytest.approx(30.0)
    assert sp.ssd_share(rec) == pytest.approx(20.0)
    assert sp.optimizer_ms(rec) == pytest.approx(100.0)
    assert sp.loss_ms(rec) == pytest.approx(50.0)
    assert sp.decode_attention_share(rec) == pytest.approx(40.0)
    assert sp.ssd_share(_rec({"other": 1.0})) == 0.0
    for read, _cells in sp.READERS.values():
        assert read({}) is None


def test_the_window_readers():
    ms = 1_000_000
    spans = [S(1, "engine.step", 0, 10 * ms), S(2, "bench.window", 20 * ms,
                                                 120 * ms),
             S(3, "engine.step", 20 * ms, 60 * ms),
             S(4, "engine.admit", 22 * ms, 42 * ms, 3, uid=1),
             S(5, "engine.step", 60 * ms, 100 * ms),
             S(6, "engine.queue", 5 * ms, 22 * ms, 3, uid=1)]
    spans += [S(10 + k, "engine.queue", 0, (k + 1) * ms + 60 * ms, uid=k)
              for k in range(9)]
    counts = [{"name": "engine.kv_live", "t": 5 * ms, "value": 100},
              {"name": "engine.kv_read", "t": 5 * ms, "value": 100},
              {"name": "engine.kv_live", "t": 50 * ms, "value": 30},
              {"name": "engine.kv_read", "t": 50 * ms, "value": 100},
              {"name": "engine.kv_live", "t": 90 * ms, "value": 10},
              {"name": "engine.kv_read", "t": 90 * ms, "value": 100}]
    rec = _rec(spans=spans, counts=counts)
    assert sp.decode_live_kv(rec) == pytest.approx(20.0)
    assert sp.admit_share(rec) == pytest.approx(25.0)
    # ten waits in the window: 17 ms, then 61..69 ms
    waits = [17.0] + [61.0 + k for k in range(9)]
    assert sp.queue_wait_p90_ms(rec) == pytest.approx(
        sorted(waits)[8] + 0.1 * (sorted(waits)[9] - sorted(waits)[8]))
    assert sp.decode_live_kv(_rec(spans=spans[:1])) is None


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_a_tiny_cell_runs_with_the_spans_on(kind):
    from bench.traced import traced_run
    cell = tiny_cell("dense", kind)
    out = traced_run(cell, 2 ** 31 + 5, 1.0, torch.device("cpu"),
                     time.perf_counter(), PEAKS)
    assert out["correct"], out["checks"]
    assert out["spans_recorded"] > 0
    names = {row[0] for row in out["breakdown"]["spans"]}
    assert names
    assert "device_ops" in out["breakdown"]
    from repro_torch.models import tracing
    assert not tracing.enabled()
