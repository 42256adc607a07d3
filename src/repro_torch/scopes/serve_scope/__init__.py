"""Serve|Scope — tail latency of the serving engine under open-loop load.

The port of the JAX package's serve scope.  Drives
:class:`repro_torch.serve.ServeEngine` (slot-based continuous batching)
with **open-loop** arrival traces from :mod:`repro_torch.core.arrivals`:
requests arrive on a seeded schedule that does not slow down when the
server does, so queueing under overload is actually exercised — the
regime where p99/p999 and goodput against an SLO carry information
(closed-loop drivers hide exactly this).

The parameter space crosses the load shape with the engine
configuration:

  * ``arrival`` — poisson | bursty | diurnal (the generator kind);
  * ``rate``    — mean offered load in requests/second;
  * ``max_batch`` — the engine's slot-pool size (admission capacity);
  * ``mix``     — prompt-length mix: ``short`` (uniform tiny prompts)
    or ``mixed`` (alternating short/long, stressing prefill buckets
    and head-of-line effects).

The model and the engine go on the run's ``--device``, with weights
from the port's ``init`` and a seeded ``torch.Generator``.  The body
paces submissions with ``State.now()`` (the sanctioned clock for
*scheduling*, not timing), stamps each request with its scheduled
arrival instant so latency includes queueing, and delivers one
``state.observe(...)`` sample per completed request (``ttft_s``,
``latency_s``) plus one per engine step (``queue_depth``).  Run with
``--meters wall,cpu,latency [--slo-ms N]`` to turn those samples into
``latency_p50_s``…``latency_p999_s``, ``ttft_p50_s``/``ttft_p99_s``,
``queue_depth_mean`` and ``goodput_rps`` counters on every record.
"""
import numpy as np
import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.arrivals import ARRIVAL_KINDS, generate
from repro_torch.core.registry import BenchmarkRegistry

NAME = "serve"

#: Prompt-length mixes (token counts, cycled over the request count).
#: ``mixed`` alternates across prefill buckets so admissions exercise
#: more than one prompt bucket.
_MIXES = {"short": (4,), "mixed": (4, 24)}


def _declare_flags(flags) -> None:
    flags.declare(f"{NAME}/requests", owner=NAME, type=int, default=12,
                  help="requests per measured batch (the trace length)")
    flags.declare(f"{NAME}/tokens", owner=NAME, type=int, default=8,
                  help="tokens decoded per request")
    flags.declare(f"{NAME}/seed", owner=NAME, type=int, default=0,
                  help="seed for the arrival trace and prompt contents "
                       "(same seed → byte-identical trace everywhere)")


def _register(registry: BenchmarkRegistry) -> None:
    from repro_torch.models import build, get_config
    from repro_torch.serve import ServeConfig, ServeEngine

    def under_load_setup(params):
        """Tiny decoder + engine + a seeded arrival trace, all untimed."""
        device = torch.device(FLAGS.get("device"))
        cfg = get_config("llama3.2-1b").reduced().override(
            num_layers=2, vocab_size=128)
        api = build(cfg)
        weights = api.init(torch.Generator(device=device).manual_seed(0))
        n = int(FLAGS.get(f"{NAME}/requests", 12))
        seed = int(FLAGS.get(f"{NAME}/seed", 0))
        lens = _MIXES[params.mix]
        rng = np.random.RandomState(seed)
        prompts = [rng.randint(1, cfg.vocab_size,
                               size=lens[i % len(lens)]).astype(np.int32)
                   for i in range(n)]
        offsets = generate(params.arrival, params.rate, n, seed)
        engine = ServeEngine(api, weights, ServeConfig(
            max_batch=params.max_batch, max_len=128,
            prompt_buckets=(16, 32)))
        return engine, prompts, offsets

    @benchmark(scope=NAME, registry=registry)
    def under_load(state: State):
        """Open-loop serving: replay the instance's seeded arrival trace
        through the engine and observe per-request TTFT/latency and
        per-step queue depth.  The engine fences every step's logits
        and reads its tokens on the host, so the family is
        host-synchronous — the no-op sync fence is correct, and the
        latency samples are delivery-timed by construction."""
        engine, prompts, offsets = state.fixture
        max_tokens = int(FLAGS.get(f"{NAME}/tokens", 8))
        while state.keep_running():
            t0 = State.now()
            idx = 0
            while (idx < len(prompts) or engine.queue
                   or any(s is not None for s in engine.slots)):
                now = State.now() - t0
                while idx < len(prompts) and offsets[idx] <= now:
                    engine.submit(prompts[idx], max_tokens=max_tokens,
                                  submitted_at=t0 + offsets[idx])
                    idx += 1
                if not (engine.queue
                        or any(s is not None for s in engine.slots)):
                    continue          # idle: spin until the next arrival
                for req in engine.step():
                    state.observe({
                        "latency_s": req.done_at - req.submitted_at,
                        "ttft_s": req.first_token_at - req.submitted_at,
                    })
                state.observe({"queue_depth": engine.queue_depth_log[-1]})
        state.set_items_processed(len(prompts))
    under_load.param_space(ParamSpace.product(
        arrival=list(ARRIVAL_KINDS), rate=[32.0], max_batch=[4],
        mix=list(_MIXES)))
    under_load.set_fixture(under_load_setup)
    # every step round-trips tokens to the host: host-synchronous
    under_load.set_sync(lambda ctx: None)
    # one trace replay per batch — the trace *is* the workload; wall
    # time is dominated by the arrival horizon, not iteration count
    under_load.set_iterations(1)


SCOPE = Scope(name=NAME, version="1.0.0",
              description="tail latency of the serving engine under "
                          "open-loop load (docs/serving.md)",
              register=_register, declare_flags=_declare_flags)
