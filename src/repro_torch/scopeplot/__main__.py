"""scope_plot CLI — ``python -m repro_torch.scopeplot <subcommand>``
(paper §V-A), the port of ``python -m repro.scopeplot``.

Subcommands: ``spec`` (render one YAML spec), ``batch`` (render a spec
directory, rebuilding only stale plots — paper §V-A.2's make deps,
applied directly), ``deps``, ``bar``, ``cat``, ``filter_name``, and
``report`` (auto-generated run report; ``--report <run>`` is an alias).
Plots are written as SVG (``x.png`` in a spec or ``--output`` becomes
``x.svg``); no subcommand needs matplotlib or PyYAML.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Optional

from .model import cat, load
from .plot import (SpecError, load_spec, quick_bar, render_spec,
                   render_spec_dir, spec_dependencies, svg_output)

_EPILOG = """examples:
  $ python -m repro_torch.scopeplot spec saxpy.yaml
  $ python -m repro_torch.scopeplot batch results/20260731T120000-42/report/specs
  $ python -m repro_torch.scopeplot report 20260731T120000-42 --results-dir results
  $ python -m repro_torch.scopeplot bar merged.json --x-field name --y-field real_time
"""


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "--report":
        # alias: python -m repro_torch.scopeplot --report <run> [...]
        from .report import report_main
        return report_main(argv[1:])

    p = argparse.ArgumentParser(
        prog="scope_plot", epilog=_EPILOG,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("spec", help="render a plot from a YAML spec file")
    sp.add_argument("spec_file")
    sp.add_argument("--output", default=None)

    bt = sub.add_parser("batch",
                        help="render every spec in a directory, "
                             "rebuilding only stale outputs")
    bt.add_argument("spec_dir")
    bt.add_argument("--force", action="store_true",
                    help="re-render even up-to-date outputs")

    sub.add_parser("report",
                   help="auto-generated run report (see python -m "
                        "repro_torch report --help)", add_help=False)

    dp = sub.add_parser("deps", help="emit make-format deps of a spec file")
    dp.add_argument("spec_file")
    dp.add_argument("--target", default=None,
                    help="make target name (default: the SVG the spec's "
                         "output names)")

    bp = sub.add_parser("bar", help="one-shot bar plot from a JSON file")
    bp.add_argument("json_file")
    bp.add_argument("--x-field", required=True)
    bp.add_argument("--y-field", required=True)
    bp.add_argument("--title", default="")
    bp.add_argument("--output", default="bar.svg")
    bp.add_argument("--filter", default=".*")

    cp = sub.add_parser("cat", help="structure-preserving concatenation")
    cp.add_argument("json_files", nargs="+")

    fp = sub.add_parser("filter_name",
                        help="keep benchmarks matching a regex")
    fp.add_argument("json_file")
    fp.add_argument("regex")

    if argv and argv[0] == "report":
        # forwarded wholesale so report's own flags (--results-dir,
        # --window, ...) don't need re-declaring here
        from .report import report_main
        return report_main(argv[1:])

    args = p.parse_args(argv)

    if args.cmd == "spec":
        try:
            spec = load_spec(args.spec_file)
        except SpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        out = render_spec(spec, output=args.output)
        print(out)
    elif args.cmd == "batch":
        try:
            results = render_spec_dir(args.spec_dir, force=args.force)
        except OSError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        if not results:
            print(f"error: no spec files (*.yaml/*.yml) in "
                  f"{args.spec_dir}", file=sys.stderr)
            return 2
        failures = 0
        for spec_path, out, status in results:
            print(f"{spec_path}: {status}" + (f" -> {out}" if out else ""))
            if status.startswith("error"):
                failures += 1
        return 1 if failures else 0
    elif args.cmd == "deps":
        try:
            spec = load_spec(args.spec_file)
        except SpecError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        deps = spec_dependencies(spec)
        target = args.target or svg_output(spec.get("output", "plot.png"))
        print(f"{target}: " + " ".join(deps))
    elif args.cmd == "bar":
        out = quick_bar(args.json_file, args.x_field, args.y_field,
                        title=args.title, output=args.output,
                        regex=args.filter)
        print(out)
    elif args.cmd == "cat":
        merged = cat([load(f) for f in args.json_files])
        json.dump(merged.to_dict(), sys.stdout, indent=2)
        print()
    elif args.cmd == "filter_name":
        bf = load(args.json_file).filter_name(args.regex)
        json.dump(bf.to_dict(), sys.stdout, indent=2)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
