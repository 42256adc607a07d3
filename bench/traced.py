"""Run one cell with the program's spans on, and print what they read.

    python3 bench/traced.py --workload <name> --seed <n> --seconds <s> \\
        [--off]

The run is ``bench/run.py --trace 1``'s (the same set-up, window,
profiles and ``correct``), with ``repro_torch``'s tracer
(``repro_torch.models.tracing``) switched on around it: the train step,
the models' layers and the serve engine record spans and counts, the
serve window runs inside a span ``bench.window``, and each of the
device's profiles keeps its kernels' launches.  Those are put down to
the spans (:mod:`bench.lib.spans`).  With ``--off`` the tracer stays off
and the run is ``--trace 1``'s alone, to read what tracing costs against.

The last line of standard output is one JSON object: ``correct``,
``checks``, ``device``, every metric of the cell that its record gives
(end-to-end and per-layer, under ``metrics``), ``step_ms`` (the mean
wall of the window's unprofiled train steps), the span readers'
numbers (``spans_metrics``), ``attribution`` (the busy time put down
to some span, the idle time with the host outside any CUDA call and the
part of it under a span below the root) and ``breakdown`` (the profiles'
``device_ops`` and ``idle_gaps``, and ``spans``: the spans with the
most device time of their own, each ``[name, device_s under it, self_s,
launches, host_self_s, idle_s]``).  Exits 3 without enough CUDA cards.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def traced_run(cell, seed: int, seconds: float, device, t_start: float,
               peaks, on: bool = True):
    """One ``--trace 1`` run of ``cell`` with the tracer on (``on``);
    returns the result line's object."""
    from bench.kinds import serve as serve_kind
    from bench.kinds import train as train_kind
    from bench.lib import harness, readers, spans, spec
    from repro_torch.models import tracing

    profiles = []

    def device_profile(fn):
        out, summary = spans.device_profile(fn)
        profiles.append(summary)
        return out, summary

    window = serve_kind.window

    def traced_window(*args, **kwargs):
        with tracing.span(spans.WINDOW):
            return window(*args, **kwargs)

    saved = (train_kind.device_profile, serve_kind.device_profile)
    train_kind.device_profile = serve_kind.device_profile = device_profile
    serve_kind.window = traced_window
    if on:
        tracing.enable()
    try:
        result = harness.run_cell(cell, seed, seconds, True, device,
                                  t_start, peaks)
    finally:
        tracing.disable()
        train_kind.device_profile, serve_kind.device_profile = saved
        serve_kind.window = window
    rec = result.pop("_record")
    rec["spans"] = tracing.export()
    attr = spans.attribute(rec["spans"]["spans"], profiles)
    rec.setdefault("trace", {}).update(by_span=attr["by_span"])
    for m in cell.end_to_end:
        value = spec.reader(m["name"])(rec)
        if value is not None:
            result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
    if rec["kind"] == "train":
        result["step_ms"] = readers.mean(
            [1e3 * (s["end"] - s["start"]) for s in readers.unprofiled(rec)])
    result["spans_metrics"] = {
        name: read(rec) for name, (read, cells) in spans.READERS.items()
        if cell.name in cells}
    result["attribution"] = {
        k: attr[k] for k in ("busy_s", "covered_s", "idle_outside_s",
                             "idle_outside_below_root_s")}
    result["spans_recorded"] = len(rec["spans"]["spans"])
    result.setdefault("breakdown", {})["spans"] = spans.top_spans(attr)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--off", action="store_true",
                    help="leave the tracer off: --trace 1's run alone")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    cache = ROOT / "bench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")

    import torch
    from bench.lib import spec

    cell = spec.load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"bench: {args.workload} needs {cell.chips} CUDA card(s)",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    peaks = spec.peaks(torch.cuda.get_device_name(device))
    result = traced_run(cell, args.seed, args.seconds, device, T_START,
                        peaks, on=not args.off)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
