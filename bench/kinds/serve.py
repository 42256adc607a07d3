"""A serving cell: the port's ``ServeEngine`` under open-loop traffic.

Set-up makes the weights from the seed, builds the engine with the
traffic file's ``engine`` settings, warms every prompt bucket and the
decode step and times them, then admits the requests that the mix keeps
in flight at steady state (``fill``), so that the window opens on the
pool as the traffic keeps it, not on an empty one.  The window submits
each request of the schedule when it is due (``submitted_at`` its
scheduled arrival, so its latency counts any wait the engine imposed)
and calls ``engine.step()`` while there is work; it ends at the
window's close without draining.  After each step the benchmark stamps
the tokens each live request gained; a request's first token is the
engine's fenced ``first_token_at``.  The tails are of the requests due
in the window; the tokens delivered count those of the requests carried
into it too.

``correct``: once the window has closed and the engine is freed, a
sample of the finished requests (carried ones too, their prompt the
tokens they were admitted with), drawn from the seed with the longest
of them in it, goes through the float32 reference, prompt and served
tokens together; the widest gap by which a served token's logit lies
below the reference's best at its position is compared.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bench.lib import traffic
from bench.lib.trace import device_profile, merge_device, read_profile
from bench.reference.common import Numerics, strict_float32


def engine_config(tr: Dict[str, Any]):
    from repro_torch.serve import ServeConfig
    e = tr["engine"]
    return ServeConfig(max_batch=e["max_batch"], max_len=e["max_len"],
                       prompt_buckets=tuple(e["prompt_buckets"]),
                       cache_dtype=getattr(torch, e["cache_dtype"]))


def make_engine(cell, seed: int, device):
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    from bench.lib.spec import model_config, reference
    config = cell.config
    params = reference(config).make_params(config["model"], seed, device)
    return ServeEngine(build(model_config(config)), params,
                       engine_config(cell.traffic))


def warm(engine, vocab: int) -> Dict[str, Any]:
    """One short request for each prompt bucket, run to completion;
    then, every shape warm, one more a bucket, each admitted alone.
    Returns the latter's prefills (``prefill_s``, by bucket) and the
    median of the last three decode steps (``step_s``)."""
    rng = np.random.default_rng(0)
    buckets = engine.cfg.prompt_buckets

    def prompt(b):
        return rng.integers(1, vocab, size=b - 1, dtype=np.int32)
    for b in buckets:
        engine.submit(prompt(b), max_tokens=3)
    engine.run()
    prefill, walls = {}, []
    for b in buckets:
        r = engine.submit(prompt(b), max_tokens=8)
        a = time.perf_counter()
        engine.step()
        prefill[b] = r.first_token_at - a
    while engine.queue or any(s is not None for s in engine.slots):
        a = time.perf_counter()
        engine.step()
        walls.append(time.perf_counter() - a)
    engine.queue_depth_log.clear()
    return {"prefill_s": prefill, "step_s": float(np.median(walls[-3:]))}


def steady_count(engine, plan: List[traffic.Planned],
                 timing: Dict[str, Any], rate: float) -> int:
    """How many requests the stream that ``plan`` is a window of keeps in
    the pool, by Little's law over this engine's own times: the rate
    times the mean steps a request stays in its slot (its output less
    the prefill's token) times the time a step takes once the prefills
    that the rate brings are shared over it; the pool's size where that
    time has no bound."""
    pre = float(np.mean([timing["prefill_s"][engine._bucket(len(p.prompt))]
                         for p in plan]))
    stays = float(np.mean([p.max_tokens for p in plan])) - 1.0
    full = engine.cfg.max_batch
    if rate * pre >= 1.0:
        return full
    per_token = timing["step_s"] / (1.0 - rate * pre)
    return min(full, int(round(rate * stays * per_token)))


def fill(engine, tr: Dict[str, Any], plan: List[traffic.Planned], seed: int,
         vocab: int, timing: Dict[str, Any], rate: float) -> List[Any]:
    """Admit the requests in flight at steady state
    (:func:`steady_count` of them, sized by :func:`traffic.in_flight`)
    with one engine step, so that the window opens on the pool as its
    traffic keeps it and not on an empty one.  Returns them."""
    k = steady_count(engine, plan, timing, rate)
    reqs = [engine.submit(p.prompt, p.max_tokens) for p in traffic.in_flight(
        tr, plan, k, seed, vocab, max(engine.cfg.prompt_buckets))]
    if reqs:
        engine.step()
    engine.queue_depth_log.clear()
    return reqs


def window(engine, plan: List[traffic.Planned], seconds: float,
           carried: List[Any]) -> Dict[str, Any]:
    """Drive the engine for ``seconds`` from now.  Returns the requests,
    the token stamps and a log of the steps; ``carried`` are requests
    already in the engine when the window opens, whose tokens in the
    window are stamped too."""
    t0 = time.perf_counter()
    end = t0 + seconds
    due = [t0 + p.due for p in plan]
    reqs: List[Any] = [None] * len(plan)
    stamps: List[List[float]] = [[] for _ in plan]   # tokens 2, 3, ...
    index: Dict[int, int] = {}                       # uid → plan index
    base = {r.uid: len(r.output) for r in carried}   # tokens before t0
    late: Dict[int, List[float]] = {r.uid: [] for r in carried}
    steps: List[Dict[str, Any]] = []
    nxt = 0
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        while nxt < len(plan) and due[nxt] <= now:
            r = engine.submit(plan[nxt].prompt, plan[nxt].max_tokens,
                              submitted_at=due[nxt])
            reqs[nxt], index[r.uid] = r, nxt
            nxt += 1
        live = [s for s in engine.slots if s is not None]
        if not engine.queue and not live:
            time.sleep(max(min(due[nxt] if nxt < len(plan) else end, end)
                           - now, 0.0))
            continue
        free = len(engine.slots) - len(live)
        admitting = list(engine.queue)[:free]
        kv = sum(r.prompt_len + len(r.output) for r in live)
        a = time.perf_counter()
        done = engine.step()
        b = time.perf_counter()
        prefill, last = [], a
        for r in admitting:
            prefill.append(r.first_token_at - last)
            last = r.first_token_at
        steps.append({"start": a - t0, "end": b - t0,
                      "admitted": len(admitting), "prefill_s": prefill,
                      "kv_positions": kv, "queued": len(engine.queue),
                      "live": sum(s is not None for s in engine.slots)})
        for r in [s for s in engine.slots if s is not None] + done:
            if r.uid in late:
                got = late[r.uid]
                got += [b - t0] * (len(r.output) - base[r.uid] - len(got))
            else:
                k = index[r.uid]
                stamps[k] += [b] * (len(r.output) - 1 - len(stamps[k]))
    requests = []
    for k, p in enumerate(plan):
        r = reqs[k]
        first = None if r is None or r.first_token_at is None \
            else r.first_token_at - t0
        requests.append({
            "due": p.due, "prompt_len": len(p.prompt),
            "max_tokens": p.max_tokens, "first": first,
            "stamps": [s - t0 for s in stamps[k]],
            "done": r is not None and r.done_at is not None})
    return {"requests": requests, "carried": list(late.values()),
            "steps": steps,
            "engine_requests": [r for r in reqs if r is not None]
            + list(carried)}


def trace_decode(engine, prompt: np.ndarray, device_steps: int = 8,
                 ops_steps: int = 3) -> Dict[str, Any]:
    """Once the window has closed: the queue is dropped, so that every
    step decodes the live slots and admits nothing, and ``device_steps``
    steps run each under the device's profile, then ``ops_steps`` under
    the operations' profile, each in a range ``bench.step.<k>``.  A
    pool with nothing live first admits ``prompt`` (unprofiled)."""
    from torch.profiler import record_function
    engine.queue.clear()

    def ready():
        if not any(s is not None for s in engine.slots):
            engine.submit(prompt, device_steps + ops_steps + 2)
            engine.step()
    summaries = []
    for _ in range(device_steps):
        ready()
        summaries.append(device_profile(engine.step)[1])
    trace = merge_device(summaries)
    prof = _profiler()
    with prof:
        for k in range(ops_steps):
            ready()
            with record_function(f"bench.step.{k}"):
                engine.step()
    trace.update(read_profile(prof, lambda n: n.startswith("bench.step.")))
    return trace


def _profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts, record_shapes=True)


def sample(reqs, seed: int, n: int, min_tokens: int) -> List[Any]:
    """Finished requests for the check: the one that served the most
    tokens, then others in an order drawn from the seed, until ``n`` of
    them or ``min_tokens`` served tokens."""
    done = [r for r in reqs if r is not None and r.done_at is not None]
    if not done:
        return []
    longest = max(done, key=lambda r: (len(r.output), -r.uid))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng(int(seed)).permutation(len(rest))
    out, tokens = [longest], len(longest.output)
    for i in order:
        if len(out) >= n or tokens >= min_tokens:
            break
        out.append(rest[i])
        tokens += len(rest[i].output)
    return out


def served(reqs) -> List[Dict[str, np.ndarray]]:
    return [{"prompt": np.asarray(r.prompt, np.int64),
             "output": np.asarray(r.output, np.int64)} for r in reqs]


def token_gaps(cell, seed: int, device, seqs, numerics: Optional[str] = None
               ) -> Dict[str, float]:
    """Over every served token of ``seqs``: the widest gap by which its
    float32 reference logit lies below the reference's best
    (``served_gap``).  With ``numerics``, the same for the token that
    the reference computed in that precision puts first
    (``control_gap``), which reads the float32 logits too."""
    from bench.lib.spec import reference
    config = cell.config
    m, ref = config["model"], reference(config)
    with strict_float32(), torch.no_grad():
        params = ref.make_params(m, seed, device)
        served_gap, control_gap, n = 0.0, 0.0, 0
        for s in seqs:
            toks = np.concatenate([s["prompt"], s["output"][:-1]])
            pos = torch.arange(len(s["prompt"]) - 1, len(toks),
                               device=device)
            toks_t = torch.as_tensor(toks, device=device)
            lg = ref.logits(m, params, toks_t, Numerics("float32"), pos)
            best = lg.max(-1).values
            out = torch.as_tensor(s["output"], device=device)
            served_gap = max(served_gap, float(
                (best - lg.gather(1, out[:, None])[:, 0]).max()))
            n += len(out)
            if numerics is not None:
                lq = ref.logits(m, params, toks_t, Numerics(numerics), pos)
                pick = lq.argmax(-1)
                control_gap = max(control_gap, float(
                    (best - lg.gather(1, pick[:, None])[:, 0]).max()))
                del lq
            del lg
    res = {"served_gap": served_gap, "tokens": n}
    if numerics is not None:
        res["control_gap"] = control_gap
    return res


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict[str, Any]:
    """One run: set-up, the window, then the reference over a sample of
    what the window served."""
    from bench.lib.spec import reference
    tr, m = cell.traffic, cell.config["model"]
    ref = reference(cell.config)
    t0 = time.perf_counter()
    engine = make_engine(cell, seed, device)
    t1 = time.perf_counter()
    timing = warm(engine, m["vocab_size"])
    t2 = time.perf_counter()
    plan = traffic.serve_schedule(tr, seed, seconds, m["vocab_size"])
    carried = fill(engine, tr, plan, seed, m["vocab_size"], timing,
                   tr["rate"])
    t3 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.perf_counter() - t_start
    phases = {"before_run": t0 - t_start, "engine": t1 - t0,
              "warm": t2 - t1, "schedule_fill": t3 - t2}
    w = window(engine, plan, seconds, carried)
    chk = tr["check"]
    seqs = served(sample(w.pop("engine_requests"), seed, chk["requests"],
                         chk["min_tokens"]))
    trace_rec = trace_decode(engine, plan[0].prompt) if trace else None
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    rec: Dict[str, Any] = {
        "kind": "serve", "setup_s": setup_s, "setup_phases": phases,
        "window_s": seconds, "memory_peak_bytes": peak,
        "attempted": len(plan), "failed": 0, "in_flight": len(carried),
        "timing": timing, **w,
        "weight_bytes": ref.weight_bytes(m),
        "kv_bytes_per_token": ref.kv_bytes_per_token(m),
    }
    if trace_rec is not None:
        rec["trace"] = trace_rec
    del engine
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if not seqs:
        raise RuntimeError("no request finished in the window: nothing to "
                           "check")
    t = time.perf_counter()
    gaps = token_gaps(cell, seed, device, seqs)
    rec["reference_s"] = time.perf_counter() - t
    rec["checked_tokens"] = gaps["tokens"]
    rec["checks"] = {"served_gap": gaps["served_gap"]}
    return rec

