"""Find a serving cell's knee: one sweep over fixed rates, on the card.

    python bench/sweep.py --workload <serve cell> --rates 1,2,3 \\
        --seconds 40 --seed <n> [--out sweep.jsonl]

For each rate, in one process, a fresh engine over the same weights is
set up as a run sets it up (warmed, then filled with the requests the
mix keeps in flight at that rate) and takes the cell's mix at that rate
for one window (no drain).  Each line gives the backlog (queued + live
requests after each step) averaged over the window's first and last
fifth, the queue alone likewise, the tails and the tokens delivered.
The knee is the highest rate at which the backlog of the last fifth is
no larger than that of the first fifth, within the noise of one window,
and nothing queues; the cells' rates are then written into their
traffic files by hand.  The benchmark's own runs do
not run this.
"""
import argparse
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _fifths(steps, seconds, key):
    first = [s[key] for s in steps if s["end"] <= seconds / 5]
    last = [s[key] for s in steps if s["end"] >= seconds * 4 / 5]
    avg = (lambda xs: sum(xs) / len(xs) if xs else 0.0)
    return avg(first), avg(last)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from repro_torch.models import build
    from repro_torch.serve import ServeEngine
    from bench.kinds import serve as drv
    from bench.lib import spec, traffic
    from bench.lib.readers import percentile
    cell = spec.load_cell(args.workload, ROOT)
    device = torch.device("cuda", 0)
    m = cell.config["model"]
    api = build(spec.model_config(cell.config))
    params = spec.reference(cell.config).make_params(m, args.seed, device)
    rec = {"window_s": args.seconds}
    out = []
    for rate in [float(r) for r in args.rates.split(",")]:
        engine = ServeEngine(api, params, drv.engine_config(cell.traffic))
        timing = drv.warm(engine, m["vocab_size"])
        plan = traffic.serve_schedule(cell.traffic, args.seed, args.seconds,
                                      m["vocab_size"], rate=rate)
        carried = drv.fill(engine, cell.traffic, plan, args.seed,
                           m["vocab_size"], timing, rate)
        w = drv.window(engine, plan, args.seconds, carried)
        steps = w["steps"]
        for s in steps:
            s["backlog"] = s["queued"] + s["live"]
        rec.update(requests=w["requests"], carried=w["carried"], steps=steps)
        first, last = _fifths(steps, args.seconds, "backlog")
        q_first, q_last = _fifths(steps, args.seconds, "queued")
        line = {"rate": rate, "requests": len(plan),
                "in_flight": len(carried), "step_ms": 1e3 * timing["step_s"],
                "backlog_first_fifth": first, "backlog_last_fifth": last,
                "queued_first_fifth": q_first, "queued_last_fifth": q_last,
                "finished": sum(r["done"] for r in w["requests"]),
                "steps": len(steps)}
        for name in ("ttft_p90_ms", "tpot_p90_ms", "serve_tokens_per_s"):
            line[name] = spec.reader(name)(rec)
        dec = [1e3 * (s["end"] - s["start"]) for s in steps
               if s["admitted"] == 0]
        line["decode_step_ms_p50"] = percentile(dec, 0.5) if dec else None
        pre = [1e3 * p for s in steps for p in s["prefill_s"]]
        line["prefill_ms_p50"] = percentile(pre, 0.5) if pre else None
        print(json.dumps(line), flush=True)
        out.append(line)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("\n".join(json.dumps(x) for x in out))
        del engine, w, carried
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
