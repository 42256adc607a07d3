"""The readings that the limits of ``correct`` are set from, on the card.

    python bench/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--seconds 20] \\
        [--out readings.json]

In one process, for each seed: the program's readings at the cell's own
size against the float32 reference (a training cell: its checked steps;
a serving cell: a window of ``--seconds`` at the cell's load, then the
sample the run would check).  For ``--control-seeds``, the control: the
reference computed with its products' operands rounded to float8 (e4m3,
a scale a tensor), the step below the bfloat16 the configurations state,
in the program's place.  For ``--fault-seeds`` of a training cell, the
program with half of each batch left out (the loss the mean over the
rest).  Prints one JSON line a reading; the benchmark's own runs do not
run this.
"""
import argparse
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CONTROL = "float8_e4m3"


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def half_batch(api):
    """The program's model with half of every batch left out of its
    loss."""
    def loss(params, batch):
        return api.loss(params, {k: v[: v.shape[0] // 2]
                                 for k, v in batch.items()})
    return dataclasses.replace(api, loss=loss)


def worst_leaves(prog, ref):
    """The leaf behind each of ``compare``'s worst-leaf numbers."""
    out = {}
    for key in ("grad", "change"):
        med = sorted(ref[key].values())[len(ref[key]) // 2]
        out[f"{key}_worst_leaf"] = max(
            ref[key], key=lambda p: abs(prog[key][p] - ref[key][p])
            / max(ref[key][p], med, 1e-30))
    return out


def _free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def train_readings(cell, args, device, emit):
    from repro_torch.models import build
    from bench.kinds import train as drv
    from bench.lib.spec import model_config
    api = build(model_config(cell.config))
    refs = {}
    for seed in args.seeds:
        t = time.perf_counter()
        state, _step, _feed, prog = drv.program_steps(cell, seed, device, api)
        del state
        _free()
        refs[seed] = drv.reference_steps(cell, seed, device)
        emit({"what": "program", "seed": seed,
              **drv.compare(prog, refs[seed]),
              **worst_leaves(prog, refs[seed]), "prog": prog,
              "ref": refs[seed], "s": time.perf_counter() - t})
    for seed in args.control_seeds:
        ref = refs.get(seed) or drv.reference_steps(cell, seed, device)
        ctl = drv.reference_steps(cell, seed, device, numerics=CONTROL)
        emit({"what": "control", "seed": seed, **drv.compare(ctl, ref),
              **worst_leaves(ctl, ref), "ctl": ctl})
    for seed in args.fault_seeds:
        ref = refs.get(seed) or drv.reference_steps(cell, seed, device)
        state, _step, _feed, prog = drv.program_steps(
            cell, seed, device, half_batch(api))
        del state
        _free()
        emit({"what": "fault_half_batch", "seed": seed,
              **drv.compare(prog, ref), **worst_leaves(prog, ref),
              "prog": prog})


def serve_readings(cell, args, device, emit):
    from bench.kinds import serve as drv
    from bench.lib import traffic
    tr, m = cell.traffic, cell.config["model"]
    for seed in args.seeds:
        t = time.perf_counter()
        engine = drv.make_engine(cell, seed, device)
        timing = drv.warm(engine, m["vocab_size"])
        plan = traffic.serve_schedule(tr, seed, args.seconds,
                                      m["vocab_size"])
        carried = drv.fill(engine, tr, plan, seed, m["vocab_size"], timing,
                           tr["rate"])
        w = drv.window(engine, plan, args.seconds, carried)
        chk = tr["check"]
        seqs = drv.served(drv.sample(w["engine_requests"], seed,
                                     chk["requests"], chk["min_tokens"]))
        del engine, w, carried
        _free()
        gaps = drv.token_gaps(cell, seed, device, seqs,
                              CONTROL if seed in args.control_seeds else None)
        emit({"what": "program", "seed": seed, **gaps,
              "requests": len(seqs), "s": time.perf_counter() - t})
        _free()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--fault-seeds", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.lib import spec
    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    lines = []

    def emit(d):
        d = {"workload": args.workload, **d}
        lines.append(d)
        brief = {k: v for k, v in d.items()
                 if not isinstance(v, (dict, list))}
        print(json.dumps(brief), flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text("\n".join(json.dumps(x) for x in lines))
    if cell.traffic["kind"] == "train":
        train_readings(cell, args, device, emit)
    else:
        serve_readings(cell, args, device, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
