"""Command-line flag registration — the clara::Opts analogue (paper §III-G),
copied from ``repro.core.flags``; the port adds the core ``--device`` flag.

Scopes declare new flags at import/registration time; the core binary parses
them all in one pass.  Mirrors SCOPE's two-phase startup:

    register flags  →  (pre-parse hooks)  →  parse  →  (post-parse hooks)  →  run

Flags are namespaced per scope for collision freedom, but short names are
allowed when unique (matching clara's permissiveness).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass
class FlagSpec:
    name: str                      # e.g. "example/seconds" or "min_time"
    help: str
    default: Any = None
    type: Callable[[str], Any] = str
    choices: Optional[List[Any]] = None
    is_bool: bool = False
    owner: str = "core"            # which scope declared it


class FlagRegistry:
    """Holds declared flags and parsed values."""

    def __init__(self) -> None:
        self._specs: Dict[str, FlagSpec] = {}
        self._values: Dict[str, Any] = {}
        self._parsed = False

    # -- declaration ------------------------------------------------------
    def declare(
        self,
        name: str,
        help: str = "",
        default: Any = None,
        type: Callable[[str], Any] = str,
        choices: Optional[List[Any]] = None,
        is_bool: bool = False,
        owner: str = "core",
    ) -> None:
        if name in self._specs:
            raise ValueError(f"flag {name!r} already declared by "
                             f"{self._specs[name].owner!r}")
        self._specs[name] = FlagSpec(name, help, default, type, choices,
                                     is_bool, owner)
        self._values[name] = default

    # -- parsing ----------------------------------------------------------
    def build_parser(self, parser: Optional[argparse.ArgumentParser] = None
                     ) -> argparse.ArgumentParser:
        parser = parser or argparse.ArgumentParser(prog="scope")
        for spec in self._specs.values():
            arg = "--" + spec.name.replace("/", ".")
            kwargs: Dict[str, Any] = dict(help=f"[{spec.owner}] {spec.help}",
                                          dest=spec.name, default=spec.default)
            if spec.is_bool:
                kwargs["action"] = "store_true"
                if spec.default:
                    kwargs["action"] = "store_false"
            else:
                kwargs["type"] = spec.type
                if spec.choices:
                    kwargs["choices"] = spec.choices
            parser.add_argument(arg, **kwargs)
        return parser

    def parse(self, argv: Optional[List[str]] = None,
              parser: Optional[argparse.ArgumentParser] = None,
              known_only: bool = True) -> argparse.Namespace:
        parser = self.build_parser(parser)
        if known_only:
            ns, _ = parser.parse_known_args(argv)
        else:
            ns = parser.parse_args(argv)
        for name in self._specs:
            self._values[name] = getattr(ns, name)
        self._parsed = True
        return ns

    # -- access -----------------------------------------------------------
    def get(self, name: str, default: Any = None) -> Any:
        if name in self._values:
            return self._values[name]
        return default

    def set(self, name: str, value: Any) -> None:
        self._values[name] = value

    def declared(self) -> List[FlagSpec]:
        return list(self._specs.values())

    def reset(self) -> None:
        self._specs.clear()
        self._values.clear()
        self._parsed = False


FLAGS = FlagRegistry()

# Core flags (the SCOPE binary's own options).
FLAGS.declare("benchmark_filter", help="regex selecting benchmarks to run",
              default=".*")
FLAGS.declare("benchmark_min_time", help="min seconds per benchmark timing",
              default=0.05, type=float)
FLAGS.declare("benchmark_repetitions", help="timing repetitions",
              default=1, type=int)
FLAGS.declare("benchmark_out", help="output JSON path", default=None)
FLAGS.declare("benchmark_list_tests", help="list benchmarks and exit",
              is_bool=True, default=False)
FLAGS.declare("log_level", help="log level", default="INFO")
FLAGS.declare("device", help="device the scopes run on; the run refuses "
              "to start on cuda when no CUDA device is present",
              default="cuda", choices=["cuda", "cpu"])
