"""Leveled, scope-tagged logging — the spdlog analogue from paper §III-E
(a copy of ``repro.core.logging``).

Every scope gets a named logger so output is attributable ("consistent output
mechanism").  Kept deliberately tiny: stdlib logging with one shared handler,
a compact format, and an env/flag-controlled level.
"""
from __future__ import annotations

import logging as _pylogging
import os
import sys
import time

_FORMAT = "[%(asctime)s.%(msecs)03d] [%(name)s] [%(levelname)s] %(message)s"
_DATEFMT = "%H:%M:%S"

_configured = False


def _configure() -> None:
    global _configured
    if _configured:
        return
    handler = _pylogging.StreamHandler(sys.stderr)
    handler.setFormatter(_pylogging.Formatter(_FORMAT, datefmt=_DATEFMT))
    root = _pylogging.getLogger("scope")
    root.addHandler(handler)
    root.propagate = False
    level = os.environ.get("SCOPE_LOG_LEVEL", "INFO").upper()
    root.setLevel(getattr(_pylogging, level, _pylogging.INFO))
    _configured = True


def get_logger(name: str) -> _pylogging.Logger:
    """Return a logger tagged ``scope/<name>`` (one per scope, typically)."""
    _configure()
    return _pylogging.getLogger(f"scope.{name}")


def set_level(level: str) -> None:
    _configure()
    _pylogging.getLogger("scope").setLevel(
        getattr(_pylogging, level.upper(), _pylogging.INFO)
    )


class Timer:
    """Context manager used by benchmark bodies for coarse phase timing."""

    def __init__(self) -> None:
        self.elapsed = 0.0

    def __enter__(self) -> "Timer":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.elapsed = time.perf_counter() - self._t0
