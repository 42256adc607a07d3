"""Scope plugin abstraction — paper §IV (Design of Scope Submodules).

A *scope* is an independently-developed group of benchmarks.  In the paper,
scopes are Git submodules exporting CMake object libraries, conditionally
compiled into the SCOPE binary (``-DENABLE_EXAMPLE=ON``).  Here, a scope is a
subpackage exporting a :class:`Scope` object; discovery imports are lazy and
failure-isolated, and enable/disable happens at run-configure time —
preserving the three design goals:

  * extensibility — new scopes need only define a Scope and call
    ``register_benchmark``; nothing in core enumerates them by name
    (external packages can register via ``add_scope``);
  * portability — a scope whose imports fail (missing optional dependency)
    is marked unavailable rather than breaking the binary;
  * development silos — scopes never import each other; shared code lives
    only in ``repro_torch.core``.

The manager stops at configuration: it loads, enables/disables, and
registers scopes, then hands off to the runner.  A scope whose import
fails is marked unavailable and the run goes on without it, so a caller
that needs a scope checks :meth:`ScopeManager.status`.
"""
from __future__ import annotations

import importlib
import traceback
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from .flags import FLAGS, FlagRegistry
from .hooks import HOOKS, HookChain
from .logging import get_logger
from .registry import REGISTRY, BenchmarkRegistry

log = get_logger("scope")

# Scopes bundled with the binary — the Table IV analogue, holding the
# scopes ported so far.  External scopes are added with add_scope();
# nothing else in core knows this list.
BUILTIN_SCOPES = [
    "repro_torch.scopes.example_scope",
    "repro_torch.scopes.mxu_scope",
    "repro_torch.scopes.comm_scope",
    "repro_torch.scopes.nn_scope",
    "repro_torch.scopes.instr_scope",
    "repro_torch.scopes.histo_scope",
    "repro_torch.scopes.linalg_scope",
    "repro_torch.scopes.io_scope",
]


@dataclass
class Scope:
    """One benchmark group: metadata + registration/initialization hooks."""

    name: str
    version: str = "1.0.0"
    description: str = ""
    # register(registry): add Benchmark objects.  Called when enabled.
    register: Optional[Callable[[BenchmarkRegistry], None]] = None
    # declare_flags(flags): add CLI options (clara::Opts analogue).
    declare_flags: Optional[Callable[[FlagRegistry], None]] = None
    # init hooks (paper §III-G), run before benchmarks execute.
    pre_parse: Optional[Callable[[], Optional[int]]] = None
    post_parse: Optional[Callable[[], Optional[int]]] = None
    required: List[str] = field(default_factory=list)   # python deps


@dataclass
class _LoadedScope:
    scope: Scope
    module: str
    enabled: bool = True
    available: bool = True
    error: str = ""


class ScopeManager:
    """Configure stage (paper Fig. 2(b)): load, enable/disable, register."""

    def __init__(self, registry: BenchmarkRegistry = REGISTRY,
                 flags: FlagRegistry = FLAGS, hooks: HookChain = HOOKS):
        self.registry = registry
        self.flags = flags
        self.hooks = hooks
        self._scopes: Dict[str, _LoadedScope] = {}

    # -- discovery ------------------------------------------------------
    def load(self, modules: Optional[List[str]] = None) -> None:
        """Import scope modules; each must export ``SCOPE: Scope``."""
        for modname in modules if modules is not None else BUILTIN_SCOPES:
            if modname in {s.module for s in self._scopes.values()}:
                continue
            try:
                mod = importlib.import_module(modname)
                scope: Scope = getattr(mod, "SCOPE")
                self.add_scope(scope, module=modname)
            except Exception:  # noqa: BLE001 - isolation requirement
                short = modname.rsplit(".", 1)[-1]
                self._scopes[short] = _LoadedScope(
                    scope=Scope(name=short), module=modname,
                    enabled=False, available=False,
                    error=traceback.format_exc(limit=2),
                )
                log.warning("scope %s unavailable (import failed)", short)

    def add_scope(self, scope: Scope, module: str = "<external>") -> None:
        """Register an externally-constructed scope (no central list)."""
        if scope.name in self._scopes:
            raise ValueError(f"scope {scope.name!r} already loaded")
        self._scopes[scope.name] = _LoadedScope(scope=scope, module=module)
        if scope.declare_flags:
            scope.declare_flags(self.flags)
        if scope.pre_parse:
            self.hooks.register_pre_parse(scope.pre_parse, owner=scope.name)
        if scope.post_parse:
            self.hooks.register_post_parse(scope.post_parse, owner=scope.name)

    # -- enable/disable (the -DENABLE_X=ON analogue) --------------------
    def set_enabled(self, name: str, enabled: bool) -> None:
        if name not in self._scopes:
            raise KeyError(f"unknown scope {name!r}; have "
                           f"{sorted(self._scopes)}")
        self._scopes[name].enabled = enabled

    def configure(self, enable: Optional[List[str]] = None,
                  disable: Optional[List[str]] = None) -> None:
        if enable:
            only = set(enable)
            known = only & set(self._scopes)
            unknown = only - known
            if unknown:
                log.warning("--enable-scope names no loaded scope: %s "
                            "(have %s)", sorted(unknown),
                            sorted(self._scopes))
            if known:
                for s in self._scopes.values():
                    s.enabled = s.scope.name in known
            else:
                # every name was unknown — a typo must not silently
                # disable the whole binary; leave the selection unchanged
                log.warning("--enable-scope selected nothing; scope "
                            "enablement left unchanged")
        for name in disable or []:
            self.set_enabled(name, False)

    # -- build stage: register enabled scopes' benchmarks ----------------
    def register_all(self) -> None:
        for s in self._scopes.values():
            if not (s.enabled and s.available and s.scope.register):
                continue
            try:
                s.scope.register(self.registry)
            except Exception:  # noqa: BLE001
                s.available = False
                s.error = traceback.format_exc(limit=2)
                self.registry.remove_scope(s.scope.name)
                log.warning("scope %s registration failed", s.scope.name)

    # -- introspection ------------------------------------------------
    def scopes(self) -> List[_LoadedScope]:
        return list(self._scopes.values())

    def status(self) -> Dict[str, str]:
        return {
            s.scope.name: ("enabled" if s.enabled and s.available else
                           "disabled" if s.available else "unavailable")
            for s in self._scopes.values()
        }
