"""Trace annotations carried by the model and train code.

:func:`traced_source` tags the graph nodes a function traces with its
name; :func:`repeated` marks a loop whose iterations all do the same
work, which :func:`fold_loops` has traced once with its trip count.
Both act only while a trace preserves node metadata
(``torch.fx.traceback.preserve_node_meta``), as the dry-run's does
(``repro_torch.launch.dryrun.trace_step``); otherwise the code runs as
it is.  :func:`trips` and :func:`source_of` read the tags back from a
node (``repro_torch.roofline.graph``).
"""
from __future__ import annotations

import contextlib
import functools
from typing import Any, Iterator, Sequence

from torch.fx import traceback as fx_traceback

#: Whether loops fold (process-wide: a CUDA backward runs on an autograd
#: worker thread, which must see the forward's setting).
_folding = {"on": False}


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
    runs as it is."""
    tag = {"source": fn.__name__}

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
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
