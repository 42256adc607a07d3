"""One run of one cell: its kind's module, the metric readers, ``correct``.

The traffic file's ``kind`` picks the module (``bench/kinds/<kind>.py``)
which sets up, measures the window and checks what it produced against
the plain reference.  The cell's end-to-end metrics (``--trace 0``) or
its per-layer metrics (``--trace 1``) are then read from the run's
record by their readers, and each number ``correct`` compares is judged
against its limit in ``bench/limits/<cell>.json``.
"""
from __future__ import annotations

import importlib
import sys
from typing import Any, Dict

import torch

from . import spec

#: Top-level modules the process may not hold once the window has
#: closed: JAX, and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (the part before the first
    dot) is one of :data:`FORBIDDEN`, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             peaks: Dict[str, float]) -> Dict[str, Any]:
    kind = importlib.import_module(f"bench.kinds.{cell.traffic['kind']}")
    rec = kind.run(cell, seed, seconds, trace, device, t_start)
    rec["peaks"] = peaks
    rec["tf32"] = bool(torch.backends.cuda.matmul.allow_tf32)
    metrics = {}
    wanted = cell.per_layer if trace else cell.end_to_end
    for m in wanted:
        value = spec.reader(m["name"])(rec)
        if value is None:
            if not trace:
                raise RuntimeError(f"the run holds nothing for the "
                                   f"end-to-end metric {m['name']!r}")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in rec["checks"].items()}
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": (torch.cuda.get_device_name(device)
                            if device.type == "cuda" else "cpu"),
                   "count": cell.chips,
                   "memory_peak_bytes": rec["memory_peak_bytes"]}
    out: Dict[str, Any] = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": rec["attempted"], "failed": rec["failed"],
        "metrics": metrics, "device": device_info}
    t = rec.get("trace") or {}
    if trace and "busy_s" in t:
        device_info["busy_s"] = t["busy_s"]
        device_info["window_s"] = t["window_s"]
    if trace and t:
        out["breakdown"] = {"device_ops": t.get("device_ops", []),
                            "idle_gaps": t.get("idle_gaps", [])}
    out["checks"] = checks
    out["_record"] = rec
    return out


def summary_line(rec: Dict[str, Any]) -> str:
    """What a run did, for the log: set-up, the window's work, the
    reference's time, the peak; for a serving run also its tails and
    rate, which only some cells judge."""
    line = (f"set-up {rec['setup_s']:.3f} s, {rec['attempted']} attempted "
            f"in the window, reference {rec.get('reference_s', 0.0):.3f} s, "
            f"peak {rec['memory_peak_bytes']:,} B")
    if rec["kind"] == "serve":
        tails = {n: spec.reader(n)(rec) for n in
                 ("ttft_p90_ms", "tpot_p90_ms", "serve_tokens_per_s")}
        line += f", {rec['in_flight']} in flight at the start, " + \
            ", ".join(f"{k} {v!r}" for k, v in tails.items())
    return line


def check_lines(result: Dict[str, Any]) -> list:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r}) "
            f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}"
            for k, c in result["checks"].items()]
