"""Initialization hooks — paper §III-G (a copy of ``repro.core.hooks``).

Scopes may register arbitrary code to run (a) before CLI args are parsed,
(b) after args are parsed but before any benchmark executes.  Hooks run in
registration order; a hook returning a non-None int requests early exit with
that status (Example|Scope uses this to exit during initialization).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

Hook = Callable[[], Optional[int]]


class HookChain:
    def __init__(self) -> None:
        self._pre_parse: List[Tuple[str, Hook]] = []
        self._post_parse: List[Tuple[str, Hook]] = []

    def register_pre_parse(self, fn: Hook, owner: str = "core") -> None:
        self._pre_parse.append((owner, fn))

    def register_post_parse(self, fn: Hook, owner: str = "core") -> None:
        self._post_parse.append((owner, fn))

    def run_pre_parse(self) -> Optional[int]:
        return self._run(self._pre_parse)

    def run_post_parse(self) -> Optional[int]:
        return self._run(self._post_parse)

    @staticmethod
    def _run(chain: List[Tuple[str, Hook]]) -> Optional[int]:
        for _owner, fn in chain:
            rc = fn()
            if rc is not None:
                return rc
        return None

    def reset(self) -> None:
        self._pre_parse.clear()
        self._post_parse.clear()


HOOKS = HookChain()
