"""Markdown report generation from dry-run cell JSONs.

The port of ``repro.roofline.report``, line for line: the tables and
their headings are the reference's, so one set of cells gives the same
text from either package.  The port's cells carry ``peak_bytes`` (the
traced graph's static peak) and no ``tpu_peak_bytes``, which the
"peak GiB" column falls back to.

``python -m repro_torch.roofline.report [--dir results/dryrun] [--mesh pod16x16]``
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Any, Dict, List, Optional

ARCH_ORDER = ["llama3.2-1b", "qwen3-1.7b", "internlm2-1.8b", "stablelm-12b",
              "qwen2-vl-2b", "moonshot-v1-16b-a3b", "deepseek-moe-16b",
              "mamba2-780m", "jamba-v0.1-52b", "whisper-small"]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load_cells(directory: str, mesh: Optional[str] = None,
               tag: str = "") -> List[Dict[str, Any]]:
    cells = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        base = os.path.basename(f)[:-5]
        parts = base.split("--")
        cell_tag = parts[3] if len(parts) > 3 else ""
        if cell_tag != tag:
            continue
        d = json.load(open(f))
        if mesh and d.get("mesh") != mesh:
            continue
        cells.append(d)
    key = lambda d: (ARCH_ORDER.index(d["arch"])
                     if d["arch"] in ARCH_ORDER else 99,
                     SHAPE_ORDER.index(d["shape"])
                     if d["shape"] in SHAPE_ORDER else 99)
    return sorted(cells, key=key)


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.0f}µs"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def roofline_table(cells: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | status | compute | memory | collective | "
           "dominant | bound | useful (6ND/HLO) | peak GiB (TPU-corr) | "
           "mode/mb |\n"
           "|---|---|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for d in cells:
        if d["status"] == "skip":
            rows.append(f"| {d['arch']} | {d['shape']} | SKIP | - | - | - "
                        f"| - | - | - | - | - |")
            continue
        if d["status"] != "ok":
            rows.append(f"| {d['arch']} | {d['shape']} | FAIL | - | - | - "
                        f"| - | - | - | - | - |")
            continue
        r = d["roofline"]
        m = d["memory"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        peak = m.get("tpu_peak_bytes", m["peak_bytes"]) / 2 ** 30
        mode = d.get("param_mode", "-")
        mb = d.get("microbatches", "")
        rows.append(
            f"| {d['arch']} | {d['shape']} | ok | {fmt_s(r['compute_s'])} "
            f"| {fmt_s(r['memory_s'])} | {fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {fmt_s(bound)} "
            f"| {r['useful_ratio']:.2f} | {peak:.1f} "
            f"| {mode}{'/' + str(mb) if mb else ''} |")
    return hdr + "\n".join(rows)


def dryrun_table(cells: List[Dict[str, Any]]) -> str:
    hdr = ("| arch | shape | mesh | compile s | args GiB | temp GiB | "
           "coll/dev GB | collective mix |\n"
           "|---|---|---|---|---|---|---|---|\n")
    rows = []
    for d in cells:
        if d["status"] != "ok":
            continue
        r = d["roofline"]
        m = d["memory"]
        mix = ", ".join(f"{k.replace('all-', 'a')}:{v / 1e9:.1f}"
                        for k, v in r.get("per_kind", {}).items() if v)
        rows.append(
            f"| {d['arch']} | {d['shape']} | {d['mesh']} "
            f"| {d['compile_s']} | {m['argument_bytes'] / 2**30:.2f} "
            f"| {m['temp_bytes'] / 2**30:.2f} "
            f"| {r['collective_bytes_'] / 1e9:.2f} | {mix} |")
    return hdr + "\n".join(rows)


def pick_hillclimb(cells: List[Dict[str, Any]]) -> Dict[str, str]:
    """worst roofline fraction / most collective-bound / most
    representative (full measurement stack: hybrid+MoE+SSM train)."""
    ok = [d for d in cells if d["status"] == "ok"]
    def frac(d):
        r = d["roofline"]
        bound = max(r["compute_s"], r["memory_s"], r["collective_s"])
        return r["compute_s"] / bound if bound else 0
    worst = min(ok, key=frac)
    coll = max(ok, key=lambda d: d["roofline"]["collective_s"] /
               max(d["roofline"]["compute_s"], 1e-12))
    return {
        "worst_fraction": f"{worst['arch']} × {worst['shape']}",
        "most_collective": f"{coll['arch']} × {coll['shape']}",
        "most_representative": "jamba-v0.1-52b × train_4k",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="pod16x16")
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    cells = load_cells(args.dir, args.mesh, args.tag)
    print("## Roofline table (%s)\n" % args.mesh)
    print(roofline_table(cells))
    print("\n## Dry-run details\n")
    print(dryrun_table(cells))
    print("\n## Hillclimb candidates\n")
    for k, v in pick_hillclimb(cells).items():
        print(f"* {k}: {v}")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
