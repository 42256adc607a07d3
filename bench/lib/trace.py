"""Reading ``torch.profiler``'s trace into the numbers the metrics use.

A traced run takes two kinds of profile over whole steps of its window;
nothing is written to disk.

* The device's own (:func:`device_profile`): CUDA activity alone, over
  one step at a time, so that the host runs as fast as it does unseen.
  The device's busy time is the union of its kernel, copy and set spans
  (as ``chip_smoke.py``'s ``profile_step`` takes it) over the step's
  wall; each idle gap between those spans is named by the host's CUDA
  call running at its middle, or "(host outside any CUDA call)".
* The operations' (:func:`read_profile`): host operations with their
  shapes, and the device, over the next steps, each inside a
  ``record_function`` range ``bench.step.<k>``.  Recording every host
  operation slows the host several-fold, so this one gives only device
  times: each aten operation's, from the kernels it launched (a
  kernel's ``linked_correlation_id`` names the innermost operation that
  launched it), with its shapes and dtypes.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Callable, Dict, List, Optional, Tuple

GEMM_OPS = ("aten::mm", "aten::addmm", "aten::bmm")


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _clip(spans, lo, hi):  # spans inside [lo, hi)
    return [(max(a, lo), min(b, hi)) for a, b in spans if b > lo and a < hi]


def _cuda_events(prof):
    """The device's spans, less the device-side mirrors of host ranges."""
    from torch.autograd import DeviceType
    dev, cpu = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append(e)
        else:
            cpu.append(e)
    return dev, cpu


def device_profile(fn: Callable[[], Any]):
    """``fn()`` under a profiler of the CUDA activity alone, the device
    synchronised before and after.  Returns ``(fn's result, summary)``:
    the step's wall, the device's busy seconds in it, its kernels, and
    its idle gaps by the host's CUDA call."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    sync()
    with profile(activities=[ProfilerActivity.CUDA if cuda
                             else ProfilerActivity.CPU]) as prof:
        t = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t
    dev, cpu = _cuda_events(prof)
    spans = _union([(e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in dev])
    busy = sum(b - a for a, b in spans)
    ends = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in dev + cpu]
    extent = [(min(a for a, _ in ends), max(b for _, b in ends))] \
        if ends else []
    gaps = _gaps(spans, extent, cpu, "(host outside any CUDA call)")
    return out, {"wall_s": wall, "busy_s": busy / 1e9, "kernels": len(dev),
                 "idle_gaps": gaps}


def merge_device(summaries: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Several steps' :func:`device_profile` summaries as one window."""
    gaps: Dict[str, float] = defaultdict(float)
    for s in summaries:
        for name, sec in s["idle_gaps"]:
            gaps[name] += sec
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": sum(s["wall_s"] for s in summaries),
            "busy_s": sum(s["busy_s"] for s in summaries),
            "kernels": sum(s["kernels"] for s in summaries),
            "idle_gaps": [[k, v] for k, v in top]}


def read_profile(prof, keep: Callable[[str], bool]) -> Dict[str, Any]:
    """Over the ``bench.*`` ranges whose name ``keep`` accepts: the top
    aten operations by the device time of the kernels they launched,
    and every GEMM call's shapes, dtypes and device seconds."""
    dev, cpu = _cuda_events(prof)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in cpu if e.name().startswith("bench.")
                    and keep(e.name()))
    in_ranges = [e for e in dev
                 if any(lo <= e.start_ns() < hi for lo, hi in ranges)]
    by_corr: Dict[int, int] = defaultdict(int)
    for e in in_ranges:
        by_corr[e.linked_correlation_id()] += e.duration_ns()
    ops = {e.correlation_id(): e for e in cpu}
    by_name: Dict[str, int] = defaultdict(int)
    gemms = []
    for corr, ns in by_corr.items():
        op = ops.get(corr)
        name = op.name() if op is not None else "(no host op)"
        by_name[name] += ns
        if op is not None and name in GEMM_OPS:
            gemms.append({"op": name, "shapes": [list(s) for s in op.shapes()],
                          "dtypes": list(op.dtypes()), "device_s": ns / 1e9})
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v / 1e9] for k, v in top], "gemms": gemms}


def _gaps(spans, ranges, cpu, outside: str) -> List[List[Any]]:
    """Idle time inside the ranges, summed by the innermost host event
    running at each gap's middle (``outside`` where none is); the ten
    largest."""
    gaps = []
    for lo, hi in ranges:
        inside = _clip(spans, lo, hi)
        edges = [lo] + [x for ab in inside for x in ab] + [hi]
        gaps += [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    mids = sorted(((a + b) // 2, b - a) for a, b in gaps)
    best: List[Tuple[int, str]] = [(-1, outside)] * len(mids)
    threads: Dict[int, list] = defaultdict(list)
    for e in cpu:
        if e.duration_ns() > 0:
            threads[e.start_thread_id()].append(
                (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
    for ivs in threads.values():
        # on one thread the ranges nest: a stack of open ones, swept in
        # time order, holds exactly those that contain the time reached
        ivs.sort()
        stack: List[Tuple[int, int, str]] = []
        j = 0
        for i, (t, _w) in enumerate(mids):
            while j < len(ivs) and ivs[j][0] <= t:
                while stack and stack[-1][1] < ivs[j][0]:
                    stack.pop()
                stack.append(ivs[j])
                j += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            if stack and stack[-1][0] > best[i][0]:
                best[i] = (stack[-1][0], stack[-1][2])
    total: Dict[str, int] = defaultdict(int)
    for (_t, w), (_s, name) in zip(mids, best):
        total[name] += w
    top = sorted(total.items(), key=lambda kv: -kv[1])[:10]
    return [[k, v / 1e9] for k, v in top]


def gemm_least_seconds(call: Dict[str, Any], peaks: Dict[str, float],
                       tf32: bool) -> Optional[float]:
    """The least time a GEMM call could take on the card: the larger of
    its FLOPs over the dtype's peak and its operands and result, each
    byte read or written once, over the memory bandwidth.  None for a
    call whose shapes cannot be read."""
    shapes, dtypes, op = call["shapes"], call["dtypes"], call["op"]
    try:
        if op == "aten::mm":
            (m, k), (_k, n) = shapes[0], shapes[1]
            b, extra = 1, 0
            dt = dtypes[0]
        elif op == "aten::bmm":
            (b, m, k), (_b, _k, n) = shapes[0], shapes[1]
            extra = 0
            dt = dtypes[0]
        else:                                   # addmm(bias, a, b)
            (m, k), (_k, n) = shapes[1], shapes[2]
            b = 1
            extra = 1
            for s in shapes[0]:
                extra *= s
            dt = dtypes[1]
    except (IndexError, TypeError, ValueError):
        return None
    size, peak = _dtype(dt, peaks, tf32)
    if size is None:
        return None
    flops = 2.0 * b * m * n * k
    nbytes = size * (b * (m * k + k * n + m * n) + extra)
    return max(flops / peak, nbytes / peaks["hbm_bytes_per_s"])


def _dtype(name: str, peaks: Dict[str, float], tf32: bool):
    name = name.lower()
    if "bfloat16" in name:
        return 2, peaks["bfloat16_flops"]
    if "half" in name or "float16" in name:
        return 2, peaks["float16_flops"]
    if "float8" in name:
        return 1, peaks["float8_flops"]
    if name == "float":
        return 4, peaks["tf32_flops" if tf32 else "float32_flops"]
    return None, None
