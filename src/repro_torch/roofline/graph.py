"""Static analyzer for a traced per-rank step — the counterpart of
``repro.roofline.hlo``.

The reference lowers a step through XLA's SPMD partitioner and reads
the per-device program from the optimized HLO text.  The port traces
the step with ``make_fx(..., tracing_mode="fake")`` over ``DTensor``
state on a (fake) process group: below the ``DTensor`` dispatch the
graph holds one rank's local aten ops and the ``_c10d_functional``
collectives between them, which is the torch form of the post-SPMD
module.  This module reads that graph:

  * FLOPs: ``FlopCounterMode`` over the graph run on fake tensors
    (:func:`graph_flops`, the formulas the linter's trace tier and the
    cost meter use, the port's kernels' among them);
  * HBM bytes: every op's tensor operands and results, with no fusion or
    reuse, as the cost meter counts them
    (``repro_torch.core.measure._bytes_mode``);
  * collective bytes by kind: the operands of the ``_c10d_functional``
    nodes under the reference's five names (``collective-permute`` has
    no torch counterpart and stays 0);
  * the static peak: a last-use liveness walk over the graph, the
    arguments live throughout.

Both counts are kept per node (an ``Interpreter`` pass reads the two
counters before and after each node), for the profile and for the
kernel substitution, each weighed by its loop's trip count: a loop the
model code writes with ``repro_torch.models.tracing.repeated`` is traced
once under ``fold_loops``, as the reference's ``while`` loop with its
trip count, and every other loop is unrolled.  The reference's HLO text
parser and its CPU bf16→f32 widening artifact have no torch meaning:
nothing is widened.
"""
from __future__ import annotations

import operator
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from repro_torch.models.tracing import source_of, trips

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: ``_c10d_functional`` op → the reference's collective name
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


@dataclass
class GraphStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    per_kind_bytes: Dict[str, float] = field(default_factory=dict)
    per_kind_count: Dict[str, int] = field(default_factory=dict)
    argument_bytes: int = 0
    output_bytes: int = 0
    peak_bytes: int = 0
    nodes: int = 0
    #: per call_function node: its op, FLOPs and bytes (weighed by its
    #: trips) and source function
    per_node: List["NodeCost"] = field(default_factory=list)


@dataclass
class NodeCost:
    name: str
    op: str
    flops: float
    nbytes: float
    source: str


def op_name(target) -> str:
    """``aten.mm`` style name of a node's target."""
    if target is operator.getitem:
        return "getitem"
    packet = getattr(target, "overloadpacket", None)
    if packet is not None:
        return f"{target.namespace}.{packet.__name__}"
    return getattr(target, "__name__", str(target))


def _val_bytes(val) -> int:
    import torch
    from torch.utils._pytree import tree_leaves
    return sum(t.numel() * t.element_size() for t in tree_leaves(val)
               if isinstance(t, torch.Tensor))


def collective_kind(node) -> Optional[str]:
    """The reference's name of a ``_c10d_functional`` node's collective
    (None for any other node)."""
    target = node.target
    if getattr(target, "namespace", "") != "_c10d_functional":
        return None
    packet = getattr(target, "overloadpacket", None)
    return _KINDS.get(getattr(packet, "__name__", ""))


def collective_bytes(graph) -> Dict[str, Any]:
    """Operand bytes per collective kind over a traced graph's
    ``_c10d_functional`` nodes, in the reference's return shape."""
    per_kind: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    counts: Dict[str, int] = {k: 0 for k in COLLECTIVES}
    for node in graph.nodes:
        if node.op != "call_function":
            continue
        kind = collective_kind(node)
        if kind is None:
            continue
        nbytes = sum(_val_bytes(a.meta.get("val"))
                     for a in node.all_input_nodes)
        if nbytes == 0:
            continue
        per_kind[kind] += nbytes * trips(node)
        counts[kind] += trips(node)
    return {"total_bytes": sum(per_kind.values()),
            "per_kind_bytes": per_kind, "per_kind_count": counts}


def _aliases(node) -> bool:
    """Whether a node's result shares storage with an operand (a view,
    an in-place op) rather than allocating."""
    target = node.target
    if target is operator.getitem:
        return True
    if getattr(target, "is_view", False):
        return True
    schema = getattr(target, "_schema", None)
    if schema is None:
        return False
    return any(r.alias_info is not None for r in schema.returns)


def static_peak(graph) -> Dict[str, int]:
    """Bytes live at the program's peak, by a last-use walk: each
    allocating node's result lives from its node to the last use of it
    or of any alias of it; arguments and results live throughout."""
    nodes = list(graph.nodes)
    index = {n: i for i, n in enumerate(nodes)}
    base: Dict[Any, Any] = {}
    for n in nodes:
        if n.op == "call_function" and _aliases(n) and n.all_input_nodes:
            src = n.all_input_nodes[0]
            base[n] = base.get(src, src)
    end = len(nodes)
    last: Dict[Any, int] = {}
    args = outs = 0
    for n in nodes:
        for a in n.all_input_nodes:
            b = base.get(a, a)
            last[b] = end if n.op == "output" else max(last.get(b, 0),
                                                       index[n])
        if n.op == "placeholder":
            args += _val_bytes(n.meta.get("val"))
        if n.op == "output":
            outs = sum(_val_bytes(a.meta.get("val"))
                       for a in n.all_input_nodes
                       if base.get(a, a).op != "placeholder")
    frees: Dict[int, int] = {}
    live = peak = args
    for i, n in enumerate(nodes):
        if n.op == "call_function" and n not in base:
            size = _val_bytes(n.meta.get("val"))
            live += size
            peak = max(peak, live)
            e = last.get(n, i)
            frees[e] = frees.get(e, 0) + size
        live -= frees.pop(i, 0)
    return {"argument_bytes": args, "output_bytes": outs,
            "peak_bytes": peak}


def graph_flops(gm, args) -> float:
    """FLOPs of a traced graph: ``FlopCounterMode`` over it run on fake
    copies of ``args`` (metadata only: nothing launches)."""
    return _run_counted(gm, args, per_node=False)[0]


def _fake_args(args):
    import torch
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    mode = detect_fake_mode(args)
    if mode is None:
        mode = FakeTensorMode(allow_non_fake_inputs=True)
        args = tree_map(lambda a: mode.from_tensor(a)
                        if isinstance(a, torch.Tensor) else a, args)
    return mode, args


def _run_counted(gm, args, per_node: bool):
    """Run ``gm`` on fake ``args`` under the FLOP counter and the cost
    meter's bytes counter, reading both around each call_function node;
    returns the totals, each node's share weighed by its :func:`trips`,
    and (with ``per_node``) each node's weighed share."""
    import torch.fx
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core.measure import _bytes_mode
    mode, fake = _fake_args(args)
    costs: List[NodeCost] = []
    total = [0.0, 0.0]

    class Counted(torch.fx.Interpreter):
        def run_node(self, n):
            if n.op != "call_function":
                return super().run_node(n)
            f0, b0 = counter.get_total_flops(), moved.nbytes
            out = super().run_node(n)
            k = trips(n)
            f = float(counter.get_total_flops() - f0) * k
            b = float(moved.nbytes - b0) * k
            total[0] += f
            total[1] += b
            if per_node:
                costs.append(NodeCost(n.name, op_name(n.target), f, b,
                                      source_of(n)))
            return out

    from torch.utils._pytree import tree_leaves
    with mode, FlopCounterMode(display=False) as counter, \
            _bytes_mode() as moved:
        # the graph's placeholders are the arguments' leaves, in order
        Counted(gm).run(*tree_leaves(fake))
    return total[0], total[1], costs


def analyze_graph(gm, args) -> GraphStats:
    """Every count of a traced per-rank step (see the module
    docstring)."""
    flops, nbytes, costs = _run_counted(gm, args, per_node=True)
    coll = collective_bytes(gm.graph)
    mem = static_peak(gm.graph)
    return GraphStats(
        flops=flops, bytes_accessed=nbytes,
        collective_bytes=float(coll["total_bytes"]),
        per_kind_bytes={k: float(v) for k, v in
                        coll["per_kind_bytes"].items()},
        per_kind_count=dict(coll["per_kind_count"]),
        argument_bytes=mem["argument_bytes"],
        output_bytes=mem["output_bytes"], peak_bytes=mem["peak_bytes"],
        nodes=len(gm.graph.nodes), per_node=costs)
