"""Model|Scope — end-to-end characterization of the 10 assigned archs.

The port of the JAX package's model scope.  Two measurement modes:
  * measured — the loss step (forward and cross-entropy) of REDUCED
    configs on the run's device, over the smoke set of archs;
  * modeled  — the dry-run roofline records (``results/dryrun/*.json``)
    are surfaced as benchmark records, so roofline data flows through the
    same JSON pipeline as every other measurement.

The loss step runs under ``torch.inference_mode()`` (no autograd
graph: the reference's jitted loss builds none either) and delivers the
loss tensor, which the wall meter fences on.  Weights come from the
port's own ``init`` with a seeded generator on the run's device.
"""
import glob
import json
import os

import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry

NAME = "model"
_SMOKE_ARCHS = ["llama3.2-1b", "mamba2-780m", "deepseek-moe-16b",
                "jamba-v0.1-52b", "whisper-small"]


def _declare_flags(flags):
    flags.declare(f"{NAME}/dryrun_dir", owner=NAME, default="results/dryrun",
                  help="directory of dry-run cell JSONs to surface")


def _register(registry: BenchmarkRegistry) -> None:
    from repro_torch.models import build, get_config

    def loss_step_setup(params):
        device = torch.device(FLAGS.get("device"))
        cfg = get_config(params.arch).reduced()
        api = build(cfg)
        weights = api.init(torch.Generator(device=device).manual_seed(0))
        batch = {"tokens": torch.ones((2, 64), dtype=torch.int32,
                                      device=device)}
        if cfg.family in ("audio", "encdec"):
            batch["frames"] = torch.ones((2, cfg.enc_seq, cfg.d_model),
                                         device=device)

        def fn(p, b):
            with torch.inference_mode():
                return api.loss(p, b)[0]
        return fn, weights, batch

    @benchmark(scope=NAME, registry=registry)
    def loss_step_reduced(state: State):
        """Reduced-config loss step; the ``arch`` axis sweeps the smoke
        set of assigned architectures (one family, not a per-arch
        clone).  Model build + init happen in the fixture, untimed; the
        warm phase reports the first step as ``compile_time_s``; the
        loss value is the sync deliverable the wall meter fences on."""
        fn, weights, batch = state.fixture
        while state.keep_running():
            state.deliver(fn(weights, batch))
        state.set_items_processed(2 * 64)
    loss_step_reduced.param_space(ParamSpace.product(arch=_SMOKE_ARCHS))
    loss_step_reduced.set_fixture(loss_step_setup)

    @benchmark(scope=NAME, registry=registry)
    def dryrun_rooflines(state: State):
        """Surface dry-run roofline terms as counters (modeled, 1 iter)."""
        d = FLAGS.get(f"{NAME}/dryrun_dir", "results/dryrun")
        files = sorted(glob.glob(os.path.join(d, "*.json")))
        if not files:
            state.skip_with_message(f"no dry-run results under {d}")
            return
        n = 0
        bound = 0.0
        while state.keep_running():
            for f in files:
                with open(f) as fh:
                    rec = json.load(fh)
                if rec.get("status") != "ok":
                    continue
                r = rec["roofline"]
                n += 1
                bound += max(r["compute_s"], r["memory_s"],
                             r["collective_s"])
        state.counters["cells"] = n
        state.counters["sum_bound_s"] = bound
    dryrun_rooflines.set_iterations(1)
    # pure host-side JSON aggregation — nothing async to fence
    dryrun_rooflines.set_sync(lambda ctx: None)


SCOPE = Scope(name=NAME, version="2.0.0",
              description="end-to-end arch characterization + rooflines",
              register=_register, declare_flags=_declare_flags)
