"""Static profiler: top HBM-traffic / FLOPs contributors of a dry-run cell.

The torch port of ``repro.roofline.profile``.  The performance loop's
"profile" without a card: it ranks the traced per-rank graph's nodes by
bytes and by FLOPs (``roofline.graph``'s per-node counts), each with its
aten op and the model-code function it was traced from, so a hypothesis
targets the dominant op, not a guess.  The reference weights HLO
instructions by their loops' trip counts; the traced graph is unrolled,
so each node counts once and the rows are summed by (op, function).

``python -m repro_torch.roofline.profile --arch X --shape Y [--override k=v]``
"""
from __future__ import annotations

import argparse
from collections import defaultdict
from typing import List, Tuple

Row = Tuple[float, str, str, int]      # (value, op, function, nodes)


def top_contributors(stats, n: int = 15) -> Tuple[List[Row], List[Row]]:
    """(bytes rows, FLOPs rows): the ``n`` largest (op, function) sums
    of a cell's ``GraphStats``, largest first."""
    nbytes, flops, count = (defaultdict(float), defaultdict(float),
                            defaultdict(int))
    for c in stats.per_node:
        key = (c.op, c.source or "-")
        nbytes[key] += c.nbytes
        flops[key] += c.flops
        count[key] += 1

    def rows(table) -> List[Row]:
        out = [(v, op, fn, count[(op, fn)])
               for (op, fn), v in table.items() if v]
        return sorted(out, reverse=True)[:n]
    return rows(nbytes), rows(flops)


def profile_cell(arch: str, shape: str, overrides=None, multi_pod=False,
                 n: int = 15, device: str = "cuda"):
    from repro_torch.launch.dryrun import lower_cell
    traced, meta = lower_cell(arch, shape, multi_pod=multi_pod,
                              overrides=overrides or {}, device=device)
    if traced is None:
        return meta, [], []
    byte_rows, flop_rows = top_contributors(traced.stats(), n)
    return meta, byte_rows, flop_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the fake tensors (default: the "
                         "card's)")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.launch.dryrun import parse_overrides
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device is available: pass --device cpu to profile "
              "the cell on the CPU")
        return 2
    meta, byte_rows, flop_rows = profile_cell(
        args.arch, args.shape, parse_overrides(args.override), n=args.top,
        device=args.device)
    if meta["status"] != "ok":
        print(f"{meta['status']}: {meta.get('reason', '')}")
        return 0
    r = meta["roofline"]
    print(f"terms: compute={r['compute_s']:.3f}s memory={r['memory_s']:.3f}s"
          f" collective={r['collective_s']:.3f}s dominant={r['dominant']}")
    print("\ntop HBM-traffic contributors (per device):")
    for b, op, fn, k in byte_rows:
        print(f"  {b/1e9:9.1f} GB  {op:40s} {fn[:30]:30s} {k:7d} nodes")
    print("\ntop FLOPs contributors (per device):")
    for f, op, fn, k in flop_rows:
        print(f"  {f/1e12:9.2f} TF  {op:40s} {fn[:30]:30s} {k:7d} nodes")
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
