"""The port's serve engine and serve scope against the JAX package's.

The reference's tests/test_serve.py cases run on the port's engine, on
the reference's weights (``init(PRNGKey(0))`` carried over by
``params_from_numpy``): in the reference's bfloat16 config the engine's
greedy tokens must equal the port's own per-request generation
(prefill plus uniform ``decode_step``), exactly; in float32 they must
equal the reference engine's tokens on the same weights and prompts.
The reference's fenced-TTFT timing test becomes a count: on the CPU
every op returns when its result is computed, so the two stamps it
compares would differ by noise alone.  Here an injected fence records
each call, and every stamp must follow its own fence.  The timing
comparison runs on the card (tests/test_torch_cuda.py).
"""
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flags import FlagRegistry as RefFlagRegistry
from repro.core.hooks import HookChain as RefHookChain
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.scope import ScopeManager as RefScopeManager
from repro.models import build as ref_build
from repro.models import get_config as ref_get_config
from repro.serve import ServeConfig as RefServeConfig
from repro.serve import ServeEngine as RefServeEngine
from repro.serve.engine import _splice_row as ref_splice_row
from repro_torch.core.bridge import from_numpy
from repro_torch.core.flags import FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.scope import ScopeManager
from repro_torch.models import build, get_config, tree
from repro_torch.models.bridge import params_from_numpy
from repro_torch.serve import ServeConfig, ServeEngine
from repro_torch.serve import engine as engine_mod
from repro_torch.serve.engine import Request, _splice_row

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _small_cfg(get, dtype="bfloat16"):
    return get("llama3.2-1b").reduced().override(num_layers=2, vocab_size=128,
                                                  dtype=dtype)


@pytest.fixture(scope="module")
def ref_weights():
    """The reference test's weights, as numpy."""
    return jax.tree_util.tree_map(
        np.asarray, ref_build(_small_cfg(ref_get_config)).init(
            jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def small(ref_weights):
    cfg = _small_cfg(get_config)
    api = build(cfg)
    return cfg, api, params_from_numpy(cfg, ref_weights)


def greedy_reference(api, params, prompt, n_tokens, cache_dtype=torch.bfloat16):
    """Uniform-batch reference generation (prefill + scalar-pos decode),
    on a fresh cache."""
    toks = torch.from_numpy(np.asarray(prompt, np.int32))[None]
    with torch.inference_mode():
        cache = api.init_cache(1, 256, cache_dtype)
        logits, cache = api.prefill(params, {"tokens": toks}, cache)
        out = [int(logits[0, -1].argmax())]
        for _ in range(n_tokens - 1):
            logits, cache = api.decode_step(
                params, torch.tensor([[out[-1]]], dtype=torch.int32), cache)
            out.append(int(logits[0, 0].argmax()))
    return out


def test_engine_matches_reference_single(small):
    cfg, api, params = small
    prompt = np.arange(1, 11)
    ref = greedy_reference(api, params, prompt, 6)
    eng = ServeEngine(api, params, ServeConfig(max_batch=2, max_len=256,
                                               prompt_buckets=(16,)))
    eng.submit(prompt, max_tokens=6)
    done = eng.run()
    assert len(done) == 1
    assert done[0].output == ref


def test_engine_mixed_lengths_match_reference(small):
    """Continuous batching with heterogeneous prompts must equal per-
    request generation — the per-slot position clock correctness check."""
    cfg, api, params = small
    prompts = [np.arange(1, 6), np.arange(20, 34), np.arange(3, 12)]
    refs = [greedy_reference(api, params, p, 5) for p in prompts]
    eng = ServeEngine(api, params, ServeConfig(max_batch=2, max_len=256,
                                               prompt_buckets=(16,)))
    reqs = [eng.submit(p, max_tokens=5) for p in prompts]
    done = eng.run()
    assert len(done) == 3
    by_uid = {r.uid: r.output for r in done}
    for req, ref in zip(reqs, refs):
        assert by_uid[req.uid] == ref, req.uid


def test_engine_throughput_summary(small):
    cfg, api, params = small
    eng = ServeEngine(api, params, ServeConfig(max_batch=2, max_len=256,
                                               prompt_buckets=(16,)))
    for _ in range(4):
        eng.submit(np.arange(1, 8), max_tokens=3)
    done = eng.run()
    stats = ServeEngine.summarize(done)
    assert stats["requests"] == 4
    assert stats["tokens"] == 12
    assert stats["throughput_tok_s"] > 0


def test_queue_deeper_than_max_batch_refills_slots(small):
    """5 requests through a 2-slot pool: freed slots must refill from
    the queue until everything drains (no head-of-line blocking)."""
    cfg, api, params = small
    eng = ServeEngine(api, params, ServeConfig(max_batch=2, max_len=256,
                                               prompt_buckets=(16,)))
    reqs = [eng.submit(np.arange(1, 6 + i), max_tokens=3) for i in range(5)]
    done = eng.run()
    assert sorted(r.uid for r in done) == sorted(r.uid for r in reqs)
    assert all(len(r.output) == 3 for r in done)
    assert all(r.done_at is not None for r in done)
    assert eng.queue_depth_log[0] == 5
    assert max(eng.queue_depth_log) == 5
    assert min(eng.queue_depth_log) >= 1


def test_eos_frees_slot_midrun(small):
    """An EOS hit mid-generation must finish the request early AND free
    its slot for the queued request behind it."""
    cfg, api, params = small
    prompt = np.arange(1, 11)
    ref = greedy_reference(api, params, prompt, 8)
    eos = ref[3]
    # the engine checks EOS only on decode-produced tokens (ref[1:])
    stop = next(i for i in range(1, len(ref)) if ref[i] == eos)
    eng = ServeEngine(api, params, ServeConfig(max_batch=1, max_len=256,
                                               prompt_buckets=(16,)))
    first = eng.submit(prompt, max_tokens=50, eos_id=int(eos))
    second = eng.submit(np.arange(30, 37), max_tokens=3)
    done = eng.run()
    assert [r.uid for r in done] == [first.uid, second.uid]
    assert first.output == ref[:stop + 1]
    assert len(first.output) < 50
    assert len(second.output) == 3
    assert first.done_at <= second.done_at


def test_oversize_prompt_raises_actionably(small):
    cfg, api, params = small
    eng = ServeEngine(api, params, ServeConfig(max_batch=1, max_len=256,
                                               prompt_buckets=(16,)))
    with pytest.raises(ValueError, match="prompt_buckets"):
        eng.submit(np.arange(1, 30))
    assert not eng.queue


def test_prompt_exceeding_max_len_raises(small):
    cfg, api, params = small
    eng = ServeEngine(api, params, ServeConfig(max_batch=1, max_len=16,
                                               prompt_buckets=(32,)))
    with pytest.raises(ValueError, match="max_len"):
        eng.submit(np.arange(1, 21))
    assert not eng.queue


def test_max_len_exhaustion_truncates_and_terminates(small):
    cfg, api, params = small
    eng = ServeEngine(api, params, ServeConfig(max_batch=1, max_len=16,
                                               prompt_buckets=(16,)))
    req = eng.submit(np.arange(1, 9), max_tokens=100)     # 8-token prompt
    done = eng.run()
    assert [r.uid for r in done] == [req.uid]
    assert req.truncated
    assert req.done_at is not None
    assert len(req.output) == 16 - 8               # filled the cache exactly


def test_summarize_empty_and_all_failed_batches():
    assert ServeEngine.summarize([]) == {}
    dead = [Request(uid=i, prompt=np.arange(3), submitted_at=float(i))
            for i in (1, 2)]
    stats = ServeEngine.summarize(dead)
    assert stats["requests"] == 2
    assert stats["ttft_mean_s"] == 0.0
    assert stats["latency_mean_s"] == 0.0
    assert stats["throughput_tok_s"] == 0.0


def test_single_slot_engine_matches_reference(small):
    """max_batch=1: the splice must handle a pool whose batch dim equals
    the row's; a single-slot engine must not decode over a zero cache."""
    cfg, api, params = small
    prompt = np.arange(1, 11)
    ref = greedy_reference(api, params, prompt, 6)
    eng = ServeEngine(api, params, ServeConfig(max_batch=1, max_len=256,
                                               prompt_buckets=(16,)))
    eng.submit(prompt, max_tokens=6)
    done = eng.run()
    assert done[0].output == ref


@pytest.mark.parametrize("fenced", [True, False])
def test_fence_runs_before_each_stamp(small, monkeypatch, fenced):
    """The fence waits for the logits before ``first_token_at`` and
    ``done_at`` are stamped: an injected fence records each call (what
    it was given and when it returned), and every stamp must follow its
    own fence — a prefill's for the first token, a decode step's for the
    last.  With ``fence_timestamps`` off the fence is never called."""
    cfg, api, params = small
    calls = []

    def fence(t):
        time.sleep(0.005)                    # a device still computing
        calls.append(("prefill" if t.shape[0] == 1 else "decode",
                      time.perf_counter()))
    monkeypatch.setattr(engine_mod, "fence", fence)
    eng = ServeEngine(api, params, ServeConfig(
        max_batch=2, max_len=256, prompt_buckets=(16,),
        fence_timestamps=fenced))
    reqs = [eng.submit(np.arange(1, 6 + i), max_tokens=3) for i in range(3)]
    eng.run()
    if not fenced:
        assert calls == []
        return
    steps = sum(1 for d in eng.queue_depth_log if d > 0)
    assert [k for k, _ in calls].count("prefill") == len(reqs)
    assert [k for k, _ in calls].count("decode") == steps

    def last_fence_before(stamp):
        return [k for k, t in calls if t <= stamp][-1]
    for r in reqs:
        assert last_fence_before(r.first_token_at) == "prefill"
        assert last_fence_before(r.done_at) == "decode"


def test_engine_refuses_a_non_decoder_family(ref_weights):
    cfg = get_config("mamba2-780m").reduced()
    api = build(cfg)
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(api, api.init(torch.Generator().manual_seed(0)),
                    ServeConfig(max_batch=1, max_len=16, prompt_buckets=(8,)))


def test_engine_tokens_equal_reference_engine_in_float32(ref_weights):
    """Cross-package: the same prompts through both engines, in float32
    with a float32 cache on the same weights, give the same tokens."""
    prompts = [np.arange(1, 6), np.arange(20, 34), np.arange(3, 12),
               np.arange(40, 47)]
    rcfg = _small_cfg(ref_get_config, "float32")
    ref_eng = RefServeEngine(
        ref_build(rcfg), jax.tree_util.tree_map(jnp.asarray, ref_weights),
        RefServeConfig(max_batch=2, max_len=64, prompt_buckets=(8, 16),
                       cache_dtype=jnp.float32))
    cfg = _small_cfg(get_config, "float32")
    eng = ServeEngine(build(cfg), params_from_numpy(cfg, ref_weights),
                      ServeConfig(max_batch=2, max_len=64,
                                  prompt_buckets=(8, 16),
                                  cache_dtype=torch.float32))
    ref_reqs = [ref_eng.submit(p, max_tokens=8) for p in prompts]
    reqs = [eng.submit(p, max_tokens=8) for p in prompts]
    ref_eng.run()
    eng.run()
    assert [r.output for r in reqs] == [r.output for r in ref_reqs]
    assert list(eng.queue_depth_log) == ref_eng.queue_depth_log


@pytest.mark.parametrize("max_batch", [1, 3])
def test_splice_row_matches_reference(max_batch):
    """The splice on the transformer's pool (k/v [L,B,...], per-slot pos)
    and on the hybrid's shapes (batch at axis 2) against the
    reference's, slot by slot."""
    rng = np.random.default_rng(7)

    def cache(b):
        return {"k": rng.standard_normal((2, b, 5, 2, 4)).astype(np.float32),
                "state": rng.standard_normal((2, 3, b, 4)).astype(np.float32),
                "pos": (np.arange(b) + 3).astype(np.int32)}
    pool, row = cache(max_batch), cache(1)
    for slot in range(max_batch):
        want = ref_splice_row(jax.tree_util.tree_map(jnp.asarray, pool),
                              jax.tree_util.tree_map(jnp.asarray, row), slot)
        got = _splice_row(from_numpy(pool), from_numpy(row), slot)
        for k, v in tree.leaves(got):
            np.testing.assert_array_equal(
                v.numpy(), np.asarray(want[k[0]]), err_msg=f"{k} {slot}")


# ---------------------------------------------------------------------------
# the serve scope
# ---------------------------------------------------------------------------

def _instance_names(mgr_cls, registry, flags, hooks):
    mgr = mgr_cls(registry=registry, flags=flags, hooks=hooks)
    mgr.load()
    mgr.configure(enable=["serve"])
    mgr.register_all()
    return [n for b in registry.all() for n, _ in b.instances()]


def test_serve_scope_registers_the_reference_instances():
    ref = _instance_names(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                          RefHookChain())
    port = _instance_names(ScopeManager, BenchmarkRegistry(), FlagRegistry(),
                           HookChain())
    assert len(ref) == 6 and port == ref
    assert all(n.startswith("serve/under_load/") for n in port)


def test_serve_scope_cpu_run_writes_latency_counters(tmp_path):
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)
    out = tmp_path / "serve.json"
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "run", "--device", "cpu",
         "--enable-scope", "serve", "--meters", "wall,cpu,latency",
         "--slo-ms", "200", "--benchmark_min_time", "0.01",
         "--serve.requests", "6", "--serve.tokens", "4",
         "--results-dir", "", "--benchmark_out", str(out)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    doc = json.loads(out.read_text())
    assert doc["context"]["scopes"]["serve"] == "enabled"
    assert len(doc["benchmarks"]) == 6
    for rec in doc["benchmarks"]:
        assert not rec.get("error_occurred"), rec
        for key in ("latency_p99_s", "ttft_p99_s", "queue_depth_mean",
                    "slo_attainment", "goodput_rps"):
            assert np.isfinite(rec[key]), (rec["name"], key)
        assert rec["requests_completed"] == 6
        assert 0.0 <= rec["slo_attainment"] <= 1.0
