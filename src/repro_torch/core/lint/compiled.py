"""Trace-tier analysis: trace the fixture's workload, read the aten graph.

The port of ``repro.core.lint.compiled``.  The ``benchmark::DoNotOptimize``
class of bugs — a workload whose result does not depend on what the
author believes they are timing — is invisible to AST inspection: the
source *looks* like it computes.  The reference lowers the fixture's
``(jitted_fn, *operands)`` with XLA and reads the optimized HLO; torch
has no such compiler pass to ask, so this tier traces the callable once
per representative instance with
``make_fx(fn, tracing_mode="fake", _allow_non_fake_inputs=True)``: the
operands become fake tensors, every op (the port's kernels through their
``register_fake``) runs on metadata only, so nothing launches on the
card and nothing is timed, and the body is never called.  The aten graph
is then diffed against what the author handed the tracer:

  * a workload with **no compute on its operands** — every op is a
    view, alias, copy or factory, or computes only from constants that
    no operand reaches — is the torch meaning of "folded away": its
    timings measure a copy or a precomputed result, not the op;
  * operand leaves whose placeholders have no users are dead: the
    benchmark sweeps an axis the workload does not consume.

Shares the fixture-context convention (``(callable, *operands)``) and
the FLOP formulas with the cost-model meter
(:func:`repro_torch.core.measure.fixture_call`,
``torch.utils.flop_counter.FlopCounterMode``, with the port's kernels'
formulas registered beside them), so what the linter certifies is what
the meters will later measure.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import List, Optional, Set

from ..logging import get_logger

log = get_logger("lint")

#: aten ops (by overload packet name) that copy or make data without
#: computing on it — a graph containing only these (or compute on
#: nothing but their constants) does no work on its operands.  Views and
#: aliases (``detach`` among them) are passive by their schema
#: (``OpOverload.is_view``); composite ops (``reshape``, ``flatten``)
#: never reach the trace.
PASSIVE_OPS = frozenset({
    "_unsafe_view", "clone", "_to_copy", "copy", "copy_",
    "lift_fresh_copy", "full", "ones", "zeros", "empty", "empty_strided",
    "arange", "scalar_tensor", "full_like", "ones_like", "zeros_like",
    "empty_like", "new_empty", "new_zeros", "new_ones", "new_full",
})
#: The copies of :data:`PASSIVE_OPS` that may change the dtype: passive
#: only when they do not.
_CONVERTING = frozenset({"_to_copy", "copy", "copy_"})


@dataclass
class CompiledWorkload:
    """What one family's fixture workload traced down to."""

    instance: str                    # representative instance name
    convention: bool = True          # ctx followed (callable, *operands)
    error: str = ""                  # fixture/trace failure
    graph_text: str = ""             # the traced aten graph's code
    compute_ops: int = 0             # non-passive ops on the operands
    entry_params: int = 0            # tensor placeholders with users
    operand_leaves: int = 0          # tensor leaves handed to the callable
    flops: float = 0.0               # FlopCounterMode, cost-meter formulas
    passive_only_ops: List[str] = field(default_factory=list)
    kernel_ops: List[str] = field(default_factory=list)  # repro_torch::*

    def analyzed(self) -> bool:
        return bool(self.graph_text) and not self.error


def _op_name(target) -> str:
    """``aten.mm`` style name of a node's target."""
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return f"{target.namespace}.{packet.__name__}"
    return getattr(target, "__name__", str(target))


def _passive(node) -> bool:
    """Whether ``node`` only moves, aliases or makes data.  A copy that
    changes the dtype (``_to_copy`` to bf16, say) converts every element
    — XLA's ``convert``, which the reference counts as compute — so it
    is not passive."""
    target = node.target
    if target is operator.getitem:
        return True
    if getattr(target, "is_view", False):
        return True
    packet = getattr(target, "overloadpacket", None)
    name = packet.__name__ if packet is not None \
        else getattr(target, "__name__", "")
    if name in _CONVERTING:
        return all(_dtype(n) == _dtype(node)
                   for n in node.all_input_nodes)
    return name in PASSIVE_OPS


def _dtype(node):
    val = getattr(node, "meta", {}).get("val")
    return getattr(val, "dtype", None)


def compile_workload(bench) -> Optional[CompiledWorkload]:
    """Trace the fixture's workload for the family's first instance;
    return its :class:`CompiledWorkload` (None when there is no fixture
    or no instance to represent the family).

    Only ``fixture(params)`` and a fake-tensor trace of its callable
    run — never the benchmark body, never a kernel launch, never a
    timed repetition.  Failures are recorded on the result (``error``)
    rather than raised: the trace tier degrades per family exactly like
    the cost-model meter does.
    """
    if bench.fixture is None:
        return None
    instances = bench.instances()
    if not instances:
        return None
    name, params = instances[0]
    out = CompiledWorkload(instance=name)
    import torch.distributed as dist
    grouped = dist.is_available() and dist.is_initialized()
    try:
        _trace(out, bench.fixture, params)
    finally:
        # a process group the fixture opened (comm's one-rank group) is
        # torn down with the trace: the pass leaves the process as it
        # found it, and a later run opens its own
        if not grouped and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
    return out


def _trace(out: CompiledWorkload, fixture, params) -> None:
    try:
        ctx = fixture(params)
    except Exception as e:  # noqa: BLE001 - report, don't crash the pass
        out.error = f"fixture failed: {e!r}"
        return
    from ..measure import fixture_call
    call = fixture_call(SimpleNamespace(fixture=ctx))
    if call is None:
        out.convention = False
        return
    fn, args = call
    import torch
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.utils._pytree import tree_leaves
    try:
        # through *args: the tracer makes a placeholder for every
        # parameter of the callable it is given, keyword-only ones with
        # defaults too (a kernel wrapper's tile knobs)
        gm = make_fx(lambda *a: fn(*a), tracing_mode="fake",
                     _allow_non_fake_inputs=True)(*args)
    except Exception as e:  # noqa: BLE001
        out.error = f"would not trace: {e!r}"
        return
    out.graph_text = gm.code
    out.operand_leaves = sum(isinstance(a, torch.Tensor)
                             for a in tree_leaves(args))
    _analyze_graph(out, gm.graph)
    out.flops = _flops(gm, args)


def _analyze_graph(out: CompiledWorkload, graph) -> None:
    import torch
    live: Set = set()            # nodes an operand reaches
    ops: List[str] = []
    seen: List[str] = []
    for node in graph.nodes:
        if node.op == "placeholder":
            if isinstance(node.meta.get("val"), torch.Tensor):
                live.add(node)
                if node.users:
                    out.entry_params += 1
            continue
        if node.op != "call_function":
            continue
        name = _op_name(node.target)
        if name not in seen:
            seen.append(name)
        if getattr(node.target, "namespace", "") == "repro_torch":
            out.kernel_ops.append(name)
        if any(n in live for n in node.all_input_nodes):
            live.add(node)
            if not _passive(node):
                ops.append(name)
    out.compute_ops = len(ops)
    if not ops:
        out.passive_only_ops = seen


def _flops(gm, args) -> float:
    """FLOPs of the traced graph, run once more on fake copies of the
    operands under ``FlopCounterMode`` (metadata only: no launch) — the
    dry-run's counter, ``repro_torch.roofline.graph.graph_flops``."""
    from repro_torch.roofline.graph import graph_flops
    try:
        return graph_flops(gm, args)
    except Exception as e:  # noqa: BLE001 - flops are advisory here
        log.debug("lint: flops analysis failed: %s", e)
        return 0.0
