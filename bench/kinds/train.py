"""A training cell: the port's one-card train step over packed documents.

Set-up makes the weights from the seed (the configuration's reference
module draws them, in the port's tree), builds one train state around
them with the port's ``adamw_init`` and one step with
``make_train_step``, and drives that state through the first steps of
the feed; the window then goes on with the same state and the same
step.  Each step ends on a fenced read of its loss.

``correct`` compares what those first steps produced with the float32
reference following the same three steps from the same weights and
rows (:func:`compare`): each step's loss, the first gradient as the
optimizer holds it after step one (``m / (1 - b1)``), and each leaf's
change after three steps.
"""
from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, List

import torch

from bench.lib import traffic
from bench.lib.trace import device_profile, merge_device, read_profile
from bench.reference.common import (Numerics, adamw_step, get_path,
                                    make_leaf, strict_float32)

#: The steps the set-up drives and the reference follows.
CHECKED_STEPS = 3


def _leaf_paths(params, prefix=""):
    for k, v in params.items():
        if isinstance(v, dict):
            yield from _leaf_paths(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _norms(tree) -> Dict[str, float]:
    return {p: float(torch.linalg.vector_norm(t.float()))
            for p, t in _leaf_paths(tree)}


def change_norms(params, ref, m, seed: int, device) -> Dict[str, float]:
    """Each leaf's ‖p - p0‖, p0 drawn again from the seed a leaf at a
    time."""
    out = {}
    for i, spec in enumerate(ref.leaves(m)):
        p0 = make_leaf(spec, seed, i, device)
        if ref.post_init is not None:
            p0 = ref.post_init(spec[0], p0)
        out[spec[0]] = float(torch.linalg.vector_norm(
            get_path(params, spec[0]).float() - p0))
        del p0
    return out


def program_steps(cell, seed: int, device, api=None):
    """Set-up: the state, the step, the feed and the readings of the
    checked steps.  Returns ``(state, step_fn, feed, readings)``."""
    from repro_torch.models import build
    from repro_torch.train import AdamWConfig, adamw_init, make_train_step
    from bench.lib.spec import model_config, reference
    config, tr = cell.config, cell.traffic
    m, ref = config["model"], reference(config)
    api = api or build(model_config(config))
    opt = config["optimizer"]
    marks = [("start", time.perf_counter())]
    params = ref.make_params(m, seed, device)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    step_fn = make_train_step(api, AdamWConfig(**opt))
    feed = traffic.train_feed(tr, m["vocab_size"], seed, device)
    _sync(device)
    marks.append(("weights", time.perf_counter()))
    losses, grads = [], None
    for i in range(CHECKED_STEPS):
        state, metrics = step_fn(state, feed(i))
        losses.append(float(metrics["loss"]))
        marks.append((f"step{i + 1}", time.perf_counter()))
        if i == 0:
            grads = {p: n / (1 - opt["b1"])
                     for p, n in _norms(state["opt"]["m"]).items()}
    changes = change_norms(state["params"], ref, m, seed, device)
    marks.append(("change_norms", time.perf_counter()))
    phases = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    return state, step_fn, feed, {"loss": losses, "grad": grads,
                                  "change": changes, "phases": phases}


def reference_steps(cell, seed: int, device, numerics: str = "float32",
                    steps: int = CHECKED_STEPS) -> Dict[str, Any]:
    """The plain reference through the checked steps, from the same
    weights and rows: its losses, its first clipped gradient's leaf
    norms and its leaves' change after the steps."""
    from bench.lib.spec import reference
    config, tr = cell.config, cell.traffic
    m, ref = config["model"], reference(config)
    opt = config["optimizer"]
    nm = Numerics(numerics)
    feed = traffic.train_feed(tr, m["vocab_size"], seed, device)
    with strict_float32():
        params = ref.make_params(m, seed, device)
        paths = [p for p, _ in _leaf_paths(params)]
        leaves = [get_path(params, p) for p in paths]
        mom = [torch.zeros_like(t) for t in leaves]
        vel = [torch.zeros_like(t) for t in leaves]
        losses, grads = [], None
        for t in range(1, steps + 1):
            batch = feed(t - 1)
            for x in leaves:
                x.requires_grad_(True)
            with torch.enable_grad():
                loss = ref.loss(m, params, batch["tokens"], batch["labels"],
                                nm)
                g = torch.autograd.grad(loss, leaves)
            for x in leaves:
                x.requires_grad_(False)
            losses.append(float(loss.detach()))
            clipped, _norm = adamw_step(opt, t, leaves, list(g), mom, vel)
            if t == 1:
                grads = {p: float(torch.linalg.vector_norm(c))
                         for p, c in zip(paths, clipped)}
            del g, clipped, loss
        changes = change_norms(params, ref, m, seed, device)
    return {"loss": losses, "grad": grads, "change": changes}


def compare(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, float]:
    """The numbers ``correct`` judges: the largest gap of a step's loss
    (nats), and for the first gradient and the change after the steps,
    the worst leaf's gap of norms over the larger of that leaf's
    reference norm and the median leaf's.  Leaves whose reference
    gradient is under a thousandth of the median leaf's (nought to
    rounding) are left out of the change."""
    steps = min(len(prog["loss"]), len(ref["loss"]))
    loss_gap = max(abs(prog["loss"][i] - ref["loss"][i]) for i in range(steps))
    g_med = _median(ref["grad"].values())
    moving = [p for p, n in ref["grad"].items() if n >= 1e-3 * g_med]
    return {"loss_gap": loss_gap,
            "grad_gap": _worst(prog["grad"], ref["grad"], list(ref["grad"])),
            "change_gap": _worst(prog["change"], ref["change"], moving)}


def _median(xs) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


def _worst(prog, ref, paths) -> float:
    med = _median(ref[p] for p in paths)
    return max(abs(prog[p] - ref[p]) / max(ref[p], med, 1e-30)
               for p in paths)


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> Dict[str, Any]:
    """One run: set-up, the window, and (after the window, once the
    program's state is freed) the reference.  Returns the run's record."""
    from bench.lib.spec import reference
    config, tr = cell.config, cell.traffic
    t_run = time.perf_counter()
    state, step_fn, feed, prog = program_steps(cell, seed, device)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    prog["phases"]["before_run"] = t_run - t_start
    tokens = tr["batch"] * tr["seq_len"]
    steps: List[Dict[str, Any]] = []
    device_trace, ops_prof = None, None
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def one_step(state, i):
        state, metrics = step_fn(state, feed(i))
        return state, float(metrics["loss"])
    i = CHECKED_STEPS
    t0 = time.perf_counter()
    end = t0 + seconds
    while time.perf_counter() < end:
        # a traced run: from mid-window, one step under the device's
        # profile, the next under the operations'
        mode = None
        if trace and time.perf_counter() - t0 >= seconds / 2:
            mode = "device" if device_trace is None else \
                "ops" if ops_prof is None else None
        a = time.perf_counter()
        if mode == "device":
            (state, loss), device_trace = device_profile(
                lambda: one_step(state, i))
        elif mode == "ops":
            ops_prof, state, loss = _profiled_step(one_step, state, i)
        else:
            state, loss = one_step(state, i)
        b = time.perf_counter()
        steps.append({"start": a - t0, "end": b - t0, "loss": loss,
                      "profiled": mode is not None})
        i += 1
    window_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    # a window too short for both profiles: the next steps take them
    if trace and device_trace is None:
        (state, _), device_trace = device_profile(lambda: one_step(state, i))
        i += 1
    if trace and ops_prof is None:
        ops_prof, state, _ = _profiled_step(one_step, state, i)
    del state
    _free(device)
    rec: Dict[str, Any] = {
        "kind": "train", "setup_s": setup_s, "window_s": seconds,
        "tokens_per_step": tokens, "steps": steps,
        "model_flops_per_step": reference(config).train_flops(
            {**config["model"], **config["policy"]}, tr["batch"],
            tr["seq_len"]),
        "window_peak_bytes": window_peak,
        "memory_peak_bytes": max(setup_peak, window_peak),
        "attempted": len(steps),
        "failed": sum(not math.isfinite(s["loss"]) for s in steps),
        "program": prog,
    }
    if device_trace is not None:
        rec["trace"] = merge_device([device_trace])
    if ops_prof is not None:
        rec.setdefault("trace", {}).update(read_profile(
            ops_prof, lambda n: n.startswith("bench.step.")))
        del ops_prof
    t = time.perf_counter()
    rec["reference"] = reference_steps(cell, seed, device)
    rec["reference_s"] = time.perf_counter() - t
    rec["checks"] = compare(prog, rec["reference"])
    return rec


def _profiled_step(one_step: Callable, state, i: int):
    """One step under the operations' profile, read after the window."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, record_shapes=True) as prof:
        with record_function(f"bench.step.{i}"):
            state, loss = one_step(state, i)
    return prof, state, loss


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _free(device) -> None:
    import gc
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
