"""Putting a traced run's device time down to the program's spans.

With the program's tracer on (``repro_torch.models.tracing``), the train
step, the models' layers and the serve engine record spans on the clock
of ``torch.profiler``'s events.  :func:`device_profile` is
:func:`bench.lib.trace.device_profile` (the same summary, key for key)
plus what attribution needs, as plain numbers: each device span with the
time of the CUDA call that launched it (the runtime event of the same
correlation id), and each idle gap with whether the host was inside a
CUDA call at its middle.  :func:`attribute` puts each device span down
to the innermost program span open at its launch, and each idle gap to
the innermost span open at its middle; the readers below turn that, and
the spans and counts themselves, into per-layer numbers.  A record
without spans reads None.

The innermost span is the latest begun of those open, on any thread: a
CUDA-only profile's runtime events carry no usable thread (on the H100
with torch 2.11 every one reads thread 1, autograd's included), and the
program's threads take turns: the thread that enters a backward waits
in ``backward`` while autograd's thread runs it.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from . import trace
from .readers import percentile

Record = Dict[str, Any]
NO_SPAN = "(no span)"

#: The spans whose device time each share or time reads, with what is
#: under them.
FLASH = ("_flash_fwd_scan", "_flash_bwd_scan")
SSD = ("ssd_chunked", "ssd_chunked.bwd")
OPTIMIZER = ("clip_by_global_norm", "adamw_update")
LOSS = ("chunked_loss", "chunked_loss.bwd")
DECODE_ATTENTION = ("decode_attention",)
WINDOW = "bench.window"


def device_profile(fn: Callable[[], Any]):
    """:func:`bench.lib.trace.device_profile`, whose summary this
    returns unchanged, with ``launches`` (each device span's start and
    end, and the time of the CUDA call that launched it, None where none
    is found) and ``gaps`` (each idle gap's ends and whether the host was
    outside any CUDA call at its middle) added."""
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
    dev, cpu = trace._cuda_events(prof)
    spans = trace._union([(e.start_ns(), e.start_ns() + e.duration_ns())
                          for e in dev])
    busy = sum(b - a for a, b in spans)
    ends = [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in dev + cpu]
    extent = [(min(a for a, _ in ends), max(b for _, b in ends))] \
        if ends else []
    gaps = trace._gaps(spans, extent, cpu, "(host outside any CUDA call)")
    summary = {"wall_s": wall, "busy_s": busy / 1e9, "kernels": len(dev),
               "idle_gaps": gaps}
    calls = {e.correlation_id(): e.start_ns() for e in cpu}
    summary["launches"] = [
        (e.start_ns(), e.start_ns() + e.duration_ns(),
         calls.get(e.correlation_id(), calls.get(e.linked_correlation_id())))
        for e in dev]
    host = trace._union([(e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in cpu if e.duration_ns() > 0])
    summary["gaps"] = [(a, b, not _inside(host, (a + b) // 2))
                       for a, b in idle(spans, extent)]
    return out, summary


def idle(busy: List[Tuple[int, int]], extent) -> List[Tuple[int, int]]:
    """The gaps between the device's busy spans inside the extent."""
    out = []
    for lo, hi in extent:
        inside = trace._clip(busy, lo, hi)
        edges = [lo] + [x for ab in inside for x in ab] + [hi]
        out += [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    return out


def _inside(union: List[Tuple[int, int]], t: int) -> bool:
    i = bisect.bisect_right(union, (t, float("inf"))) - 1
    return i >= 0 and union[i][0] <= t <= union[i][1]


def innermost(spans: List[Dict[str, Any]], times: List[int]
              ) -> List[Optional[Dict[str, Any]]]:
    """For each time, the span with the latest start among those open
    then (None where none is): one sweep in time order, an ended span
    dropped once it is the latest begun."""
    order = sorted(spans, key=lambda s: (s["start"], -s["end"]))
    out: List[Optional[Dict[str, Any]]] = [None] * len(times)
    active: List[Dict[str, Any]] = []
    j = 0
    for t, k in sorted((t, k) for k, t in enumerate(times)):
        while j < len(order) and order[j]["start"] <= t:
            active.append(order[j])
            j += 1
        while active and active[-1]["end"] < t:
            active.pop()
        # a span under the top may have ended: it is dropped when it
        # surfaces, since no later query can fall inside it either
        out[k] = active[-1] if active else None
    return out


def attribute(spans: List[Dict[str, Any]],
              profiles: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """Put the profiles' device spans and idle gaps down to ``spans``
    (``repro_torch.models.tracing.export()["spans"]``).  A device span
    goes to the innermost span open at its launch, an idle gap to the
    innermost span open at its middle.  Returns ``by_span`` (a name's
    ``device_s`` under it, its descendants' included, as the union of
    those device spans; ``self_s`` and ``launches`` its own;
    ``host_self_s`` its wall less its children's; ``idle_s`` and
    ``idle_outside_s``, the idle at whose middle it was innermost, all
    of it and that with the host outside any CUDA call), ``busy_s``,
    ``covered_s`` (busy time under some span), ``idle_outside_s`` and
    ``idle_outside_below_root_s`` (the part of it under a span with a
    parent)."""
    by_id = {s["id"]: s for s in spans}
    kernels, gaps, walls = [], [], []
    for p in profiles:
        kernels += p.get("launches", [])
        gaps += p.get("gaps", [])
        ends = [x for k in p.get("launches", []) for x in k[:2]] + \
            [x for g in p.get("gaps", []) for x in g[:2]]
        if ends:
            walls.append((min(ends), max(ends)))
    launched = [i for i, k in enumerate(kernels) if k[2] is not None]
    owner: List[Optional[Dict[str, Any]]] = [None] * len(kernels)
    for i, s in zip(launched, innermost(spans,
                                        [kernels[i][2] for i in launched])):
        owner[i] = s
    per_name: Dict[str, Dict[str, Any]] = defaultdict(lambda: {
        "ivs": [], "self": [], "launches": 0, "host_self_s": 0.0,
        "idle_s": 0.0, "idle_outside_s": 0.0})
    covered = []
    for (a, b, _t), s in zip(kernels, owner):
        if s is None:
            per_name[NO_SPAN]["self"].append((a, b))
            per_name[NO_SPAN]["launches"] += 1
            continue
        covered.append((a, b))
        per_name[s["name"]]["self"].append((a, b))
        per_name[s["name"]]["launches"] += 1
        for name in _lineage(s, by_id):
            per_name[name]["ivs"].append((a, b))
    mids = [(a + b) // 2 for a, b, _o in gaps]
    outside = below = 0.0
    for (a, b, out), s in zip(gaps, innermost(spans, mids)):
        sec = (b - a) / 1e9
        entry = per_name[NO_SPAN if s is None else s["name"]]
        entry["idle_s"] += sec
        if out:
            entry["idle_outside_s"] += sec
            outside += sec
            below += sec if s is not None and s["parent"] is not None \
                else 0.0
    children: Dict[Any, int] = defaultdict(int)
    for s in spans:
        if s["parent"] is not None and _within(s, walls):
            children[s["parent"]] += s["end"] - s["start"]
    for s in spans:
        if _within(s, walls):
            per_name[s["name"]]["host_self_s"] += max(
                s["end"] - s["start"] - children[s["id"]], 0) / 1e9
    busy = sum(b - a for a, b in trace._union(
        [(a, b) for a, b, _t in kernels]))
    by_span = {name: {"device_s": _seconds(e["ivs"]),
                      "self_s": _seconds(e["self"]),
                      "launches": e["launches"],
                      "host_self_s": e["host_self_s"],
                      "idle_s": e["idle_s"],
                      "idle_outside_s": e["idle_outside_s"]}
               for name, e in per_name.items()}
    return {"by_span": by_span, "busy_s": busy / 1e9,
            "covered_s": _seconds(covered),
            "idle_outside_s": outside, "idle_outside_below_root_s": below}


def _lineage(s, by_id) -> List[str]:
    """The names of a span and its ancestors, each once."""
    names: List[str] = []
    while s is not None:
        if s["name"] not in names:
            names.append(s["name"])
        s = by_id.get(s["parent"])
    return names


def _within(s, walls) -> bool:
    return any(s["start"] < hi and s["end"] > lo for lo, hi in walls)


def _seconds(ivs) -> float:
    return sum(b - a for a, b in trace._union(ivs)) / 1e9


def top_spans(attr: Dict[str, Any], n: int = 15) -> List[List[Any]]:
    """``breakdown.spans``: the spans with the most device time of their
    own, each ``[name, device_s (under it), self_s, launches,
    host_self_s, idle_s]``."""
    rows = sorted(attr["by_span"].items(), key=lambda kv: -kv[1]["self_s"])
    return [[k, v["device_s"], v["self_s"], v["launches"], v["host_self_s"],
             v["idle_s"]] for k, v in rows[:n]]


# ---------------------------------------------------------------------------
# readers: a record with ``spans`` (the tracer's export) and, for the
# device's numbers, ``trace["by_span"]`` and ``trace["busy_s"]``
# ---------------------------------------------------------------------------


def _device_s(rec: Record, names) -> Optional[float]:
    t = rec.get("trace") or {}
    if "by_span" not in t:
        return None
    return sum(t["by_span"].get(n, {}).get("device_s", 0.0) for n in names)


def _share(rec: Record, names) -> Optional[float]:
    dev = _device_s(rec, names)
    busy = (rec.get("trace") or {}).get("busy_s", 0.0)
    return None if dev is None or busy <= 0 else 100.0 * dev / busy


def _ms(rec: Record, names) -> Optional[float]:
    dev = _device_s(rec, names)
    return None if dev is None else 1e3 * dev


def flash_scan_share(rec: Record) -> Optional[float]:
    """``flash_scan_share.train``: device time under the chunked
    attention's scans over the traced step's busy time, %."""
    return _share(rec, FLASH)


def ssd_share(rec: Record) -> Optional[float]:
    """``ssd_share.train``: the same under ``ssd_chunked`` and its
    backward, %."""
    return _share(rec, SSD)


def optimizer_ms(rec: Record) -> Optional[float]:
    """``optimizer_ms.train``: device ms under clipping and AdamW in the
    traced step."""
    return _ms(rec, OPTIMIZER)


def loss_ms(rec: Record) -> Optional[float]:
    """``loss_ms.train``: device ms under ``chunked_loss`` and its
    backward in the traced step."""
    return _ms(rec, LOSS)


def decode_attention_share(rec: Record) -> Optional[float]:
    """``decode_attention_share.serve``: device time under
    ``decode_attention`` over the busy time of the traced decode steps,
    %."""
    return _share(rec, DECODE_ATTENTION)


def _window(rec: Record):
    spans = (rec.get("spans") or {}).get("spans") or []
    w = [s for s in spans if s["name"] == WINDOW]
    return (w[0]["start"], w[0]["end"], spans) if w else None


def decode_live_kv(rec: Record) -> Optional[float]:
    """``decode_live_kv.serve``: Σ ``engine.kv_live`` over Σ
    ``engine.kv_read`` over the window's decode steps, %."""
    w = _window(rec)
    if w is None:
        return None
    lo, hi, _ = w
    tot = defaultdict(float)
    for c in rec["spans"]["counts"]:
        if lo <= c["t"] <= hi:
            tot[c["name"]] += c["value"]
    if tot["engine.kv_read"] <= 0:
        return None
    return 100.0 * tot["engine.kv_live"] / tot["engine.kv_read"]


def queue_wait_p90_ms(rec: Record) -> Optional[float]:
    """``queue_wait_p90_ms.serve``: p90 of ``engine.queue`` over the
    requests admitted in the window, ms."""
    w = _window(rec)
    if w is None:
        return None
    lo, hi, spans = w
    waits = [(s["end"] - s["start"]) / 1e6 for s in spans
             if s["name"] == "engine.queue" and lo <= s["end"] <= hi]
    return percentile(waits, 0.9) if waits else None


def admit_share(rec: Record) -> Optional[float]:
    """``admit_share.overload``: Σ ``engine.admit`` over Σ
    ``engine.step`` in the window, %."""
    w = _window(rec)
    if w is None:
        return None
    lo, hi, spans = w
    tot = defaultdict(int)
    for s in spans:
        if s["name"] in ("engine.admit", "engine.step") and \
                lo <= s["start"] and s["end"] <= hi:
            tot[s["name"]] += s["end"] - s["start"]
    if tot["engine.step"] <= 0:
        return None
    return 100.0 * tot["engine.admit"] / tot["engine.step"]


#: The per-layer numbers the spans and counts give, by the metric's
#: name, and the cells each reads something in.
READERS = {
    "flash_scan_share.train": (flash_scan_share,
                               ["train-internlm2-1.8b-s4096"]),
    "ssd_share.train": (ssd_share, ["train-mamba2-780m-s4096"]),
    "optimizer_ms.train": (optimizer_ms, ["train-internlm2-1.8b-s4096",
                                          "train-mamba2-780m-s4096"]),
    "loss_ms.train": (loss_ms, ["train-internlm2-1.8b-s4096",
                                "train-mamba2-780m-s4096"]),
    "decode_attention_share.serve": (decode_attention_share,
                                     ["serve-internlm2-1.8b-chat"]),
    "decode_live_kv.serve": (decode_live_kv, ["serve-internlm2-1.8b-chat"]),
    "queue_wait_p90_ms.serve": (queue_wait_p90_ms,
                                ["serve-internlm2-1.8b-chat"]),
    "admit_share.overload": (admit_share, ["serve-internlm2-1.8b-overload"]),
}
