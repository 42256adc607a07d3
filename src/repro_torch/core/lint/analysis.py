"""AST-tier analysis of one benchmark family's body and fixture (a copy
of ``repro.core.lint.analysis``).

Works entirely from the source captured at registration time
(``Benchmark.source`` / ``fixture_source``, falling back to
``inspect.getsource``): nothing is imported, called, traced or timed.

The central objects:

  * :func:`parse_function` — source text → the ``ast.FunctionDef`` of
    the body/fixture (decorators and nesting indentation handled);
  * :class:`FamilyAnalysis` — every per-family fact the AST rules
    consume: the timed loops (``while state.keep_running():`` /
    ``for _ in state:``), the calls made inside them, whether the body
    declares deliverables or counters, and which parameter axes the
    body + fixture actually *read*;
  * :class:`AxisReads` — the read-set with an honesty bit: any dynamic
    access the analyzer cannot resolve (``state.params`` passed whole
    to a helper, a non-constant subscript) flips ``known`` off, and
    rules that depend on the read-set skip the family instead of
    guessing (a linter that cries wolf gets turned off).
"""
from __future__ import annotations

import ast
import inspect
import textwrap
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain; None for anything else."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else None
    return None


def parse_function(source: Optional[str]) -> Optional[ast.FunctionDef]:
    """The first function definition in ``source`` (None if unparseable
    — e.g. a lambda registered imperatively, or source lost)."""
    if not source:
        return None
    try:
        tree = ast.parse(textwrap.dedent(source))
    except (SyntaxError, ValueError):
        return None
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return node
    return None


def _get_source(obj: Any) -> Optional[str]:
    try:
        return inspect.getsource(obj)
    except (OSError, TypeError):
        return None


@dataclass
class AxisReads:
    """Which parameter axes a function reads — and whether the analyzer
    could actually tell (``known=False`` → treat every axis as read)."""

    names: Set[str] = field(default_factory=set)
    known: bool = True


@dataclass
class CallSite:
    """One call made somewhere in the body, as a dotted name."""

    name: str
    line: int


def int_axis_names(bench) -> List[str]:
    """Axis names that ``state.range(i)`` indexes, in order (the
    int-valued axes of the first point for typed families, the declared
    arg names for legacy families)."""
    if bench.space is not None:
        pts = bench.space.points()
        if not pts:
            return []
        return [k for k, v in pts[0].items()
                if isinstance(v, int) and not isinstance(v, bool)]
    return list(bench.arg_names)


def declared_axes(bench) -> List[str]:
    """The axes an author *declared*: the typed space's axes, or a legacy
    family's named args.  Unnamed legacy sweeps declare nothing
    addressable, so dead-axis analysis skips them."""
    if bench.space is not None:
        return bench.space.axes()
    if bench.arg_names and bench.arg_sets \
            and len(bench.arg_names) == len(bench.arg_sets[0]):
        return list(bench.arg_names)
    return []


class FamilyAnalysis:
    """Lazily-computed AST facts about one family (body + fixture)."""

    def __init__(self, bench):
        self.bench = bench
        self.body = parse_function(bench.source or _get_source(bench.fn))
        fixture_src = bench.fixture_source
        if fixture_src is None and bench.fixture is not None:
            fixture_src = _get_source(bench.fixture)
        self.fixture = parse_function(fixture_src)
        self.state_arg: Optional[str] = None
        if self.body is not None and self.body.args.args:
            self.state_arg = self.body.args.args[0].arg
        self.timed_loops: List[ast.AST] = []
        if self.body is not None and self.state_arg:
            self.timed_loops = [n for n in ast.walk(self.body)
                                if self._is_timed_loop(n)]

    # -- structure -----------------------------------------------------
    def _is_timed_loop(self, node: ast.AST) -> bool:
        state = self.state_arg
        if isinstance(node, ast.While):
            for sub in ast.walk(node.test):
                if isinstance(sub, ast.Call) and \
                        dotted_name(sub.func) == f"{state}.keep_running":
                    return True
        if isinstance(node, ast.For):
            it = node.iter
            if dotted_name(it) == state:
                return True
            if isinstance(it, ast.Call) and dotted_name(it.func) == "iter" \
                    and it.args and dotted_name(it.args[0]) == state:
                return True
        return False

    def analyzable(self) -> bool:
        """Could the body be parsed into something rule-worthy?"""
        return self.body is not None and self.state_arg is not None

    # -- calls ---------------------------------------------------------
    def _calls_in(self, nodes) -> Iterator[ast.Call]:
        for root in nodes:
            for sub in ast.walk(root):
                if isinstance(sub, ast.Call):
                    yield sub

    def body_calls(self) -> List[CallSite]:
        """Every dotted-name call anywhere in the body."""
        if self.body is None:
            return []
        return [CallSite(name, c.lineno)
                for c in self._calls_in([self.body])
                if (name := dotted_name(c.func))]

    def timed_region_calls(self) -> List[CallSite]:
        """Every dotted-name call inside a timed loop's body — the code
        that runs with the clock running."""
        stmts: List[ast.AST] = []
        for loop in self.timed_loops:
            stmts.extend(loop.body)
        return [CallSite(name, c.lineno) for c in self._calls_in(stmts)
                if (name := dotted_name(c.func))]

    def calls_state_method(self, method: str) -> bool:
        """Does the body call ``state.<method>(...)`` anywhere?"""
        if not self.state_arg:
            return False
        target = f"{self.state_arg}.{method}"
        return any(c.name == target for c in self.body_calls())

    def sets_counters(self) -> bool:
        """Does the body assign into ``state.counters[...]``?"""
        if self.body is None or not self.state_arg:
            return False
        target = f"{self.state_arg}.counters"
        for node in ast.walk(self.body):
            if isinstance(node, ast.Subscript) \
                    and isinstance(node.ctx, ast.Store) \
                    and dotted_name(node.value) == target:
                return True
        return False

    # -- parameter-axis reads -------------------------------------------
    def _reads(self, func: ast.FunctionDef, roots: Set[str],
               bench) -> AxisReads:
        """Axes read through any expression in ``roots`` (dotted names
        that evaluate to the family's ``Params``), following simple
        ``alias = state.params`` assignments."""
        reads = AxisReads()
        parents: Dict[ast.AST, ast.AST] = {
            child: parent for parent in ast.walk(func)
            for child in ast.iter_child_nodes(parent)}
        roots = set(roots)
        # alias fixpoint: p = state.params; q = p; ...
        changed = True
        while changed:
            changed = False
            for node in ast.walk(func):
                if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                        and isinstance(node.targets[0], ast.Name) \
                        and dotted_name(node.value) in roots \
                        and node.targets[0].id not in roots:
                    roots.add(node.targets[0].id)
                    changed = True
        ints = int_axis_names(bench)
        state = self.state_arg
        for node in ast.walk(func):
            # state.range(i) / state.ranges read the int-valued axes
            if state is not None and isinstance(node, ast.Call):
                if dotted_name(node.func) == f"{state}.range":
                    idx = node.args[0] if node.args else ast.Constant(0)
                    if isinstance(idx, ast.Constant) \
                            and isinstance(idx.value, int) \
                            and 0 <= idx.value < len(ints):
                        reads.names.add(ints[idx.value])
                    else:
                        reads.known = False
                    continue
            if state is not None and isinstance(node, ast.Attribute) \
                    and node.attr == "ranges" \
                    and dotted_name(node.value) == state:
                reads.names.update(ints)
                continue
            if not isinstance(node, (ast.Name, ast.Attribute)):
                continue
            if isinstance(node.ctx, ast.Store):
                continue
            if dotted_name(node) not in roots:
                continue
            parent = parents.get(node)
            if isinstance(parent, ast.Attribute) and parent.value is node:
                reads.names.add(parent.attr)
            elif isinstance(parent, ast.Subscript) and parent.value is node:
                key = parent.slice
                if isinstance(key, ast.Constant) and isinstance(key.value, str):
                    reads.names.add(key.value)
                else:
                    reads.known = False
            elif isinstance(parent, ast.Assign) and node is parent.value \
                    and len(parent.targets) == 1 \
                    and isinstance(parent.targets[0], ast.Name):
                pass  # simple alias, already folded into roots
            else:
                # params escapes (helper call, iteration, f-string...):
                # the analyzer cannot see which axes that code reads
                reads.known = False
        return reads

    def axis_reads(self) -> AxisReads:
        """Union of the axes the body and the fixture read.  ``known``
        is False as soon as either side does something the analyzer
        cannot resolve — or when either source was unavailable."""
        out = AxisReads()
        if self.body is None or self.state_arg is None:
            out.known = False
            return out
        body = self._reads(self.body, {f"{self.state_arg}.params"},
                           self.bench)
        out.names |= body.names
        out.known &= body.known
        if self.bench.fixture is not None:
            if self.fixture is None or not self.fixture.args.args:
                out.known = False
                return out
            fixture = self._reads(self.fixture,
                                  {self.fixture.args.args[0].arg},
                                  self.bench)
            out.names |= fixture.names
            out.known &= fixture.known
        return out

    def dead_axes(self) -> Optional[List[str]]:
        """Declared-but-never-read axes (None = analysis inconclusive,
        rules must stay quiet)."""
        declared = declared_axes(self.bench)
        if not declared:
            return []
        reads = self.axis_reads()
        if not reads.known:
            return None
        return [a for a in declared if a not in reads.names]

    def live_projection_duplicates(self) -> List[Tuple[str, str]]:
        """Instance-name pairs that collapse onto the same point once
        dead axes are projected out — i.e. instances that measure the
        identical workload twice."""
        dead = self.dead_axes()
        if not dead:
            return []
        seen: Dict[Tuple, str] = {}
        dupes: List[Tuple[str, str]] = []
        for name, params in self.bench.instances():
            key = tuple((k, v) for k, v in params.items() if k not in dead)
            if key in seen:
                dupes.append((seen[key], name))
            else:
                seen[key] = name
        return dupes
