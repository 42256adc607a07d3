"""The port's runtime spans (``repro_torch.models.tracing``) on the CPU.

With the tracer on, a train step computes what it computes off, bit for
bit, for a dense model (the chunked attention, its recompute backward)
and for mamba2 (the chunked SSD), both under ``remat="full"``; its spans
form the tree ``train_step`` ⊃ ``forward``, ``backward``,
``clip_by_global_norm``, ``adamw_update``, and every backward span lies
under ``backward``.  Off, nothing is recorded and the clock is never
read.  The serve engine's spans account for each request's time to
first token and carry its uid; its counters never count more live
positions than decode attention reads.  Spans share the clock of
``torch.profiler``'s events.
"""
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.models import build, get_config, tracing, tree
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.train import AdamWConfig, make_init_fn, make_train_step
from repro_torch.train.step import _grad_fn

ARCHS = ["internlm2-1.8b", "mamba2-780m"]
ENGINE_SPANS = {"engine.queue", "engine.admit", "engine.row_cache",
                "engine.prefill", "engine.splice"}


@pytest.fixture(autouse=True)
def tracer_off():
    """Every test starts and ends with the tracer off and empty."""
    tracing.disable()
    tracing.export()
    yield
    tracing.disable()
    tracing.export()


def _model(arch):
    cfg = get_config(arch).reduced().override(
        dtype="float32", remat="full", loss_chunk=16, num_layers=2)
    if cfg.family == "dense":
        cfg = cfg.override(attn_chunk_q=16, attn_chunk_k=16)
    return cfg, build(cfg)


def _state(api):
    return make_init_fn(api, AdamWConfig(lr=1e-3))(
        torch.Generator().manual_seed(0))


def _batch(cfg, seed=3):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab_size, (2, 32), generator=g,
                                    dtype=torch.int32)}


def _engine(max_batch=2):
    cfg = get_config("llama3.2-1b").reduced().override(num_layers=2,
                                                       vocab_size=128)
    api = build(cfg)
    params = api.init(torch.Generator().manual_seed(0))
    return ServeEngine(api, params, ServeConfig(
        max_batch=max_batch, max_len=64, prompt_buckets=(8, 16)))


def _serve(eng, n=5):
    rng = np.random.default_rng(0)
    reqs = [eng.submit(rng.integers(1, 128, size=int(k)), max_tokens=4)
            for k in rng.integers(3, 16, size=n)]
    eng.run()
    return reqs


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _names(spans):
    return {s["name"] for s in spans}


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_is_bit_identical_with_tracing_on(arch):
    cfg, api = _model(arch)
    batch = _batch(cfg)
    grads, states = [], []
    for on in (False, True):
        if on:
            tracing.enable()
        state = _state(api)
        (loss, _m), g = _grad_fn(api)(state["params"], batch)
        grads.append((loss, g))
        step = make_train_step(api, AdamWConfig(lr=1e-3))
        outs = []
        for i in range(2):
            state, metrics = step(state, _batch(cfg, seed=i))
            outs.append(metrics)
        states.append((state, outs))
        tracing.disable()
    (l0, g0), (l1, g1) = grads
    assert torch.equal(l0, l1)
    for a, b in zip(tree.flatten(g0), tree.flatten(g1)):
        assert torch.equal(a, b)
    (s0, m0), (s1, m1) = states
    for a, b in zip(m0, m1):
        for k in ("loss", "grad_norm", "lr"):
            assert torch.equal(a[k], b[k]), k
    for part in ("params", "opt"):
        for a, b in zip(tree.flatten(s0[part]), tree.flatten(s1[part])):
            assert torch.equal(a, b)
    assert tracing.export()["spans"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_span_tree(arch):
    cfg, api = _model(arch)
    state = _state(api)
    step = make_train_step(api, AdamWConfig(lr=1e-3))
    tracing.enable()
    step(state, _batch(cfg))
    spans = tracing.export()["spans"]
    by_id = _by_id(spans)
    root = [s for s in spans if s["name"] == "train_step"]
    assert len(root) == 1 and root[0]["parent"] is None
    root = root[0]
    kids = [s for s in spans if s["parent"] == root["id"]]
    assert [s["name"] for s in sorted(kids, key=lambda s: s["start"])] == [
        "forward", "backward", "clip_by_global_norm", "adamw_update"]
    for s in spans:
        assert root["start"] <= s["start"] <= s["end"] <= root["end"]
    (bwd,) = [s for s in kids if s["name"] == "backward"]
    back = [s for s in spans if s["name"].endswith(".bwd")
            or s["name"] == "_flash_bwd_scan"]
    assert "chunked_loss.bwd" in _names(back)
    assert ("_flash_bwd_scan" if arch == "internlm2-1.8b"
            else "ssd_chunked.bwd") in _names(back)
    for s in back:
        # up through backward regions alone, to backward
        p = by_id[s["parent"]]
        while p["name"].endswith(".bwd"):
            p = by_id[p["parent"]]
        assert p["id"] == bwd["id"], s["name"]
        # a region inside a whole call's backward ends inside it (the
        # convolutions' weights are slices of stacked leaves, whose
        # node runs last: their inputs' nodes end the regions)
        p = by_id[s["parent"]]
        while p["name"] not in ("mamba2_block.bwd", "chunked_loss.bwd",
                                "backward"):
            p = by_id[p["parent"]]
        assert s["end"] <= p["end"], s["name"]
        if s["name"] in ("_flash_bwd_scan", "mlp.bwd"):
            # mlp ends in out_proj, whose backward begins at the same
            # node: the outer region opens first
            assert s["parent"] == bwd["id"], s["name"]
    fwd = [s for s in spans if s["name"] == "chunked_loss"]
    assert len(fwd) == 1 and by_id[fwd[0]["parent"]]["name"] == "forward"


def test_a_backward_on_another_thread_lies_under_the_span_that_entered_it():
    # as a CUDA backward runs on autograd's thread
    cfg, api = _model("internlm2-1.8b")
    params = tree.map(lambda p: p.requires_grad_(), _state(api)["params"])
    tracing.enable()
    loss, _ = api.loss(params, _batch(cfg))
    with tracing.span("backward"):
        worker = threading.Thread(target=lambda: torch.autograd.grad(
            loss, tree.flatten(params), allow_unused=True))
        worker.start()
        worker.join(timeout=120)
    assert not worker.is_alive()
    spans = tracing.export()["spans"]
    by_id = _by_id(spans)
    (bwd,) = [s for s in spans if s["name"] == "backward"]
    back = [s for s in spans if s["name"].endswith(".bwd")]
    assert back and all(s["tid"] != bwd["tid"] for s in back)
    for s in back:
        p = by_id[s["parent"]]
        while p["name"].endswith(".bwd"):
            p = by_id[p["parent"]]
        assert p["id"] == bwd["id"], s["name"]
        assert bwd["start"] <= s["start"] <= s["end"] <= bwd["end"]


def test_tracer_off_records_nothing_and_reads_no_clock(monkeypatch):
    cfg, api = _model("internlm2-1.8b")
    state = _state(api)
    step = make_train_step(api, AdamWConfig(lr=1e-3))
    eng = _engine()

    def no_clock():
        raise AssertionError("the tracer read the clock while off")
    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    step(state, _batch(cfg))
    _serve(eng)
    with tracing.span("off"):
        tracing.count("off", 1)
        tracing.record("off", time.perf_counter())
    monkeypatch.undo()
    assert tracing.export() == {"spans": [], "counts": []}


def test_engine_spans_account_for_time_to_first_token():
    eng = _engine(max_batch=2)
    tracing.enable()
    reqs = _serve(eng, n=5)                  # more than the slots: a queue
    spans = tracing.export()["spans"]
    assert {"engine.step", "engine.decode", "engine.sample"} <= _names(spans)
    queued = []
    for r in reqs:
        mine = [s for s in spans if s["uid"] == r.uid]
        assert sorted(s["name"] for s in mine) == sorted(ENGINE_SPANS)
        dur = {s["name"]: (s["end"] - s["start"]) / 1e9 for s in mine}
        waited = dur["engine.queue"] + dur["engine.row_cache"] + \
            dur["engine.prefill"]
        assert abs(waited - (r.first_token_at - r.submitted_at)) < 1e-3
        queued.append(dur["engine.queue"])
        admit = [s for s in mine if s["name"] == "engine.admit"][0]
        for s in mine:
            if s["name"] in ("engine.row_cache", "engine.prefill",
                             "engine.splice"):
                assert s["parent"] == admit["id"]
    # the last requests waited for a slot: a step or more
    assert max(queued) > min(queued) + 1e-4


def test_engine_counts_no_more_live_positions_than_it_reads():
    eng = _engine(max_batch=2)
    tracing.enable()
    reqs = _serve(eng, n=5)
    counts = tracing.export()["counts"]
    live = [c["value"] for c in counts if c["name"] == "engine.kv_live"]
    read = [c["value"] for c in counts if c["name"] == "engine.kv_read"]
    assert len(live) == len(read) > 0
    assert all(0 < a <= b for a, b in zip(live, read))
    assert set(read) == {2 * 64}
    # the first decode: the two prompts admitted, and a token each
    assert live[0] == reqs[0].prompt_len + reqs[1].prompt_len + 2


def test_queue_depth_log_keeps_the_latest_steps():
    eng = _engine()
    for _ in range(5000):
        eng.step()
    assert len(eng.queue_depth_log) == 4096
    assert eng.queue_depth_log[-1] == 0


def test_spans_share_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(64, 64)
    tracing.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("clock"):
            t0 = time.perf_counter_ns()
            time.sleep(0.01)
            t1 = time.perf_counter_ns()
            torch.mm(a, a)
            time.sleep(0.01)
    (s,) = tracing.export()["spans"]
    assert s["end"] - s["start"] >= 20e6
    (op,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    start, end = op.start_ns(), op.start_ns() + op.duration_ns()
    assert s["start"] - 1e6 <= start and end <= s["end"] + 1e6
    assert abs((start - s["start"]) - (t1 - t0)) <= 1e6
