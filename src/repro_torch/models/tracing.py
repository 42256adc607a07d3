"""Trace annotations carried by the model and train code, and the
runtime spans they open.

:func:`traced_source` tags the graph nodes a function traces with its
name; :func:`repeated` marks a loop whose iterations all do the same
work, which :func:`fold_loops` has traced once with its trip count.
Both act only while a trace preserves node metadata
(``torch.fx.traceback.preserve_node_meta``), as the dry-run's does
(``repro_torch.launch.dryrun.trace_step``); otherwise the code runs as
it is.  :func:`trips` and :func:`source_of` read the tags back from a
node (``repro_torch.roofline.graph``).

Between :func:`enable` and :func:`disable` the same names are runtime
spans: each :func:`traced_source` call opens one under its function's
name, and under grad a ``<name>.bwd`` span covers its backward;
:func:`span`, :func:`record` and :func:`count` mark the train step's
and the serve engine's own boundaries.  Spans are stamped in
nanoseconds on the clock of ``torch.profiler``'s events (Unix time),
so a profile's kernels can be put down to the span that launched them;
:func:`export` hands them out.  Off, a span site costs one flag test:
no allocation, no clock read, no call into torch.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence

import torch
from torch.fx import traceback as fx_traceback

#: Whether loops fold (process-wide: a CUDA backward runs on an autograd
#: worker thread, which must see the forward's setting).
_folding = {"on": False}

#: Whether spans are recorded (process-wide, for the same reason).
_tracing = {"on": False}


@contextlib.contextmanager
def fold_loops():
    """Within the ``with`` body, loops written with :func:`repeated` are
    traced once per body with their trip count (see :func:`repeated`)."""
    prev = _folding["on"]
    _folding["on"] = True
    try:
        yield
    finally:
        _folding["on"] = prev


def repeated(items: Sequence[Any]) -> Iterator[Any]:
    """Iterate ``items``, the iterations of a loop whose bodies all do
    the same work on tensors of the same shapes (the chunked attention's
    chunk pairs, the train step's microbatches).  Under
    :func:`fold_loops`, while node metadata is preserved (a dry-run
    trace), only the first item is given, and the nodes of its body
    carry ``trips`` = ``len(items)`` (times an enclosing folded loop's),
    by which the analysis weighs them: the reference's ``while`` loop
    with its trip count.  Otherwise every item, as a plain loop."""
    if not (_folding["on"] and len(items) > 1
            and fx_traceback.has_preserved_node_meta()):
        yield from items
        return
    outer = (fx_traceback.current_meta.get("custom") or {}).get("trips", 1)
    with fx_traceback.annotate({"trips": outer * len(items)}):
        yield items[0]


def traced_source(fn):
    """Decorator: the graph nodes traced inside ``fn`` carry its name
    (``node.meta["custom"]["source"]``, the innermost such function
    winning) when the trace preserves node metadata; otherwise ``fn``
    runs as it is.  While spans are on (:func:`enable`), each call is
    also a span under ``fn``'s name, and under grad its backward is a
    span ``<name>.bwd``: from the first of its outputs' ``grad_fn`` to
    run to the first of its inputs' (a node runs once every gradient
    into it is done), each marked by a pre-hook, so the autograd graph
    gains no node."""
    name = fn.__name__
    tag = {"source": name}
    bwd = name + ".bwd"

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        if _tracing["on"]:
            return _spanned(fn, name, bwd, tag, args, kwargs)
        if not fx_traceback.has_preserved_node_meta():
            return fn(*args, **kwargs)
        with fx_traceback.annotate(tag):
            return fn(*args, **kwargs)
    return wrapped


def trips(node) -> int:
    """How many times a node's loop body runs (1 outside a folded loop,
    :func:`repeated`)."""
    return int((node.meta.get("custom") or {}).get("trips", 1))


def source_of(node) -> str:
    """The model-code function a node was traced from (its
    :func:`traced_source` tag), else ''."""
    return (node.meta.get("custom") or {}).get("source") or ""


# ---------------------------------------------------------------------------
# runtime spans
# ---------------------------------------------------------------------------


class _Open:
    """A span that has started and not yet ended."""
    __slots__ = ("id", "name", "start", "parent", "tid", "uid", "stack")

    def __init__(self, id_, name, start, parent, tid, uid, stack):
        self.id, self.name, self.start = id_, name, start
        self.parent, self.tid, self.uid, self.stack = parent, tid, uid, stack


class _Store:
    """What the spans share: the clock's offset, the finished spans and
    counts, and each thread's stack of open spans."""

    def __init__(self):
        self.lock = threading.Lock()
        self.offset = 0              # Unix ns − perf_counter ns
        self.ids = itertools.count(1)
        self.spans: List[tuple] = []
        self.counts: List[tuple] = []
        self.stacks: Dict[int, List[_Open]] = {}
        self.native: Dict[int, int] = {}    # thread ident → native id


_store = _Store()


def enable() -> None:
    """Record spans and counts from now on, in every thread.  The clock
    is ``time.perf_counter_ns()`` plus one offset to ``time.time_ns()``
    taken here, so that a step of the wall clock cannot tear a span."""
    _store.offset = time.time_ns() - time.perf_counter_ns()
    _tracing["on"] = True


def disable() -> None:
    """Stop recording; what was recorded waits for :func:`export`."""
    _tracing["on"] = False


def enabled() -> bool:
    return _tracing["on"]


def _now() -> int:
    return time.perf_counter_ns() + _store.offset


def _thread() -> int:
    """This thread's native id, read once a thread: it is a system
    call."""
    ident = threading.get_ident()
    tid = _store.native.get(ident)
    if tid is None:
        tid = _store.native[ident] = threading.get_native_id()
    return tid


def _parent(tid: int, stack: List[_Open]) -> Optional[int]:
    """The innermost span open on this thread; on a thread with none
    (autograd's, in a CUDA backward), the latest-started span open on
    another thread: the one that entered the backward."""
    if stack:
        return stack[-1].id
    tops = [s[-1] for t, s in _store.stacks.items() if t != tid and s]
    return max(tops, key=lambda o: o.start).id if tops else None


def _open(name: str, uid=None, start: Optional[int] = None) -> _Open:
    tid = _thread()
    with _store.lock:
        stack = _store.stacks.setdefault(tid, [])
        s = _Open(next(_store.ids), name, _now() if start is None else start,
                  _parent(tid, stack), tid, uid, stack)
        stack.append(s)
    return s


def _close(s: _Open, end: Optional[int] = None, nested: bool = True
           ) -> None:
    """End ``s``.  A span with a ``with`` body (``nested``) ends after
    everything opened inside it: a backward region still open above it
    on its thread, or on a thread whose first open span it adopted
    (autograd's), ends with it; its closing node never ran.  A
    backward region ends alone, since regions may overlap."""
    with _store.lock:
        end = _now() if end is None else end
        if nested:
            for stack in _store.stacks.values():
                if stack is s.stack:
                    while stack and stack[-1] is not s:
                        _end(stack[-1], end)
                elif stack and stack[0].parent == s.id:
                    while stack:
                        _end(stack[-1], end)
        _end(s, end)


def _end(s: _Open, end: int) -> None:
    if s.stack and s.stack[-1] is s:
        s.stack.pop()
    elif s in s.stack:
        s.stack.remove(s)
    else:                                        # ended already
        return
    _store.spans.append((s.id, s.name, s.start, end, s.parent, s.tid,
                         s.uid))


class _Span:
    __slots__ = ("name", "uid", "open")

    def __init__(self, name: str, uid):
        self.name, self.uid = name, uid

    def __enter__(self):
        self.open = _open(self.name, self.uid)
        return self

    def __exit__(self, *exc):
        _close(self.open)
        return False


_OFF = contextlib.nullcontext()


def span(name: str, uid=None):
    """A context manager: the ``with`` body is a span ``name`` (``uid``:
    the request it serves, if any).  Off, a shared no-op."""
    return _Span(name, uid) if _tracing["on"] else _OFF


def record(name: str, since: float, uid=None) -> None:
    """A span ``name`` that began at ``since`` (a ``time.perf_counter()``
    reading) and ends now."""
    if _tracing["on"]:
        _close(_open(name, uid, int(since * 1e9) + _store.offset))


def count(name: str, value) -> None:
    """A counter's reading, stamped now under the innermost open span."""
    if not _tracing["on"]:
        return
    tid = _thread()
    with _store.lock:
        parent = _parent(tid, _store.stacks.setdefault(tid, []))
        _store.counts.append((name, _now(), value, parent, tid))


def export() -> Dict[str, List[Dict[str, Any]]]:
    """The spans ended and the counts taken since the last export, and
    forget them.  A span: ``id``, ``name``, ``start`` and ``end`` (ns),
    ``parent`` (an id or None), ``tid`` (the thread's native id),
    ``uid``.  A count: ``name``, ``t``, ``value``, ``parent``, ``tid``."""
    with _store.lock:
        spans, counts = _store.spans, _store.counts
        _store.spans, _store.counts = [], []
    return {"spans": [dict(zip(_SPAN, s)) for s in spans],
            "counts": [dict(zip(_COUNT, c)) for c in counts]}


_SPAN = ("id", "name", "start", "end", "parent", "tid", "uid")
_COUNT = ("name", "t", "value", "parent", "tid")


def _spanned(fn, name, bwd, tag, args, kwargs):
    s = _open(name)
    try:
        if fx_traceback.has_preserved_node_meta():
            with fx_traceback.annotate(tag):
                out = fn(*args, **kwargs)
        else:
            out = fn(*args, **kwargs)
    finally:
        _close(s)
    if torch.is_grad_enabled():
        _hook_backward(bwd, out, args, kwargs)
    return out


class _Region:
    """One call's backward: not yet begun (0), open (1) or ended (2)."""
    __slots__ = ("name", "state", "open")

    def __init__(self, name: str):
        self.name, self.state, self.open = name, 0, None


_HOOKS = "repro_torch.tracing"


def _nodes(tensors, skip=()) -> list:
    """The distinct ``grad_fn`` of the tensors among ``tensors``, less
    those in ``skip``."""
    out: list = []
    for t in tensors:
        n = t.grad_fn if isinstance(t, torch.Tensor) else None
        if n is not None and not any(n is m for m in [*out, *skip]):
            out.append(n)
    return out


def _hook_backward(name, out, args, kwargs) -> None:
    starts = _nodes(out if isinstance(out, (tuple, list)) else (out,))
    if not starts:
        return
    ends = _nodes(itertools.chain(args, kwargs.values()), starts)
    if not ends:
        return
    region = _Region(name)
    for node in starts:
        _node_hooks(node)[1].append(region)
    for node in ends:
        _node_hooks(node)[0].append(region)


def _node_hooks(node):
    """``(regions ending at node, regions starting at it)``, with the one
    pre-hook that acts on both registered the first time."""
    hooks = node.metadata.get(_HOOKS)
    if hooks is None:
        hooks = node.metadata[_HOOKS] = ([], [])
        node.register_prehook(functools.partial(_fire, hooks))
    return hooks


def _fire(hooks, grad_outputs) -> None:
    if not _tracing["on"]:
        return
    ends, starts = hooks
    for r in ends:                    # inner regions first
        if r.state == 1:
            _close(r.open, nested=False)
            r.state, r.open = 2, None
    if starts:
        t = _now()
        for r in reversed(starts):    # outer regions first: registered last
            if r.state == 0:
                r.open, r.state = _open(r.name, start=t), 1
