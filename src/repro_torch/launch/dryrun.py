"""Multi-pod dry-run: prove the distribution config is coherent.

The torch port of ``repro.launch.dryrun``.  For every (architecture ×
input-shape × mesh) cell:

  1. build the production mesh (16×16 single-pod / 2×16×16 multi-pod)
     over a fake process group of 256 or 512 ranks (``launch.mesh``);
  2. make the state, batch and cache on ``meta`` (no allocation: a
     full-size configuration never touches device memory), each leaf
     placed by ``distributed.partition``;
  3. trace one train, prefill or decode step for one rank with
     ``make_fx(..., tracing_mode="fake")``: the leaves are that rank's
     local shards (fake tensors), wrapped as DTensors inside the
     traced function, and the step runs under the config's logical
     rules, so the graph is the per-rank program with its collectives;
  4. read the graph (``roofline.graph``): per-rank FLOPs, HBM bytes,
     collective bytes by kind and the static peak, and the three-term
     roofline in H100 terms (``roofline.analysis``);
  5. write the cell's record as JSON, in the reference's keys.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
  python -m repro_torch.launch.dryrun --arch all --shape all --multi-pod

``--device`` (default ``cuda``) places the fake tensors; without a card
the command exits 2 unless given ``--device cpu``.  Nothing runs on the
card either way: the trace and its analysis are metadata only.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.core.logging import get_logger
from repro_torch.distributed import partition as part
from repro_torch.distributed.logical import default_rules, logical_rules
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import build, family_module, get_config, list_archs
from repro_torch.models import tree
from repro_torch.models.config import ModelConfig
from repro_torch.roofline.analysis import analyze_compiled, model_flops
from repro_torch.models.tracing import fold_loops
from repro_torch.train import AdamWConfig, adamw_init, make_train_step

log = get_logger("dryrun")

RESULTS_DEFAULT = "results/dryrun"

#: GPUs an NVLink domain joins in an H100 node (HGX: 8 per node)
NVLINK_DOMAIN = 8


# ---------------------------------------------------------------------------
# per-shape config adjustments (baseline implementation policy, recorded)
# ---------------------------------------------------------------------------

def tune_config(cfg: ModelConfig, shape: str, overrides: Dict[str, Any],
                kind: Optional[str] = None) -> ModelConfig:
    """Baseline numerics/memory policy for full-scale tracing: remat=full
    and a seq-chunked loss for training, no loss chunking for prefill;
    then the overrides that are config fields."""
    tuned: Dict[str, Any] = {}
    kind = kind or inp.SHAPES[shape].kind
    if kind == "train":
        tuned.update(remat="full", loss_chunk=1024)
    if kind == "prefill":
        tuned.update(loss_chunk=0)
    tuned.update({k: v for k, v in overrides.items()
                  if k not in ("microbatches", "param_mode", "dp_layout",
                               "no_grad_spec")})
    return cfg.override(**tuned)


def auto_param_mode(cfg: ModelConfig, mesh) -> str:
    """fsdp when fp32 params per device (TP-only) would exceed ~2 GiB."""
    m = part.axis_size(mesh, "model")
    per_dev = cfg.num_params() * 4 / m
    return "fsdp" if per_dev > 2 * 2**30 else "tp"


def microbatches_for(cfg: ModelConfig, shape, mesh) -> int:
    """Bound the remat residual stack (L × B_loc × S × d × 2B) to ~1 GiB.
    ``shape``: a name in ``SHAPES`` or a ``ShapeSpec``."""
    sh = inp.SHAPES[shape] if isinstance(shape, str) else shape
    if sh.kind != "train":
        return 1
    dp = part.dp_size(mesh)
    b_loc = max(sh.global_batch // dp, 1)
    layers = cfg.num_layers + cfg.num_enc_layers
    resid = layers * b_loc * sh.seq_len * cfg.d_model * 2
    # unshardable heads (whisper/qwen2-vl: 12 H on a 16-way axis) leave
    # attention activations replicated across 'model' — budget tighter
    m = part.axis_size(mesh, "model")
    if cfg.num_heads % m != 0 and cfg.family != "ssm":
        resid *= 4
    mb = 1
    while resid / mb > 1 * 2**30 and mb < b_loc:
        mb *= 2
    return mb


# ---------------------------------------------------------------------------
# tracing
# ---------------------------------------------------------------------------

@dataclass
class TracedCell:
    """One rank's traced step: the graph and the fake local shards it
    was traced on (the torch form of the reference's ``Compiled``)."""
    gm: Any
    args: List[Any]
    trace_s: float
    _stats: Any = field(default=None, repr=False)

    def stats(self):
        """``roofline.graph.GraphStats`` of the graph (computed once)."""
        if self._stats is None:
            from repro_torch.roofline.graph import analyze_graph
            self._stats = analyze_graph(self.gm, self.args)
        return self._stats


def _local_shape(shape, placements, mesh) -> List[int]:
    out = list(shape)
    for md, p in enumerate(placements):
        if p.is_shard():
            n = mesh.size(md)
            if out[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not "
                                 f"split {n} ways")
            out[p.dim] //= n
    return out


def trace_step(fn: Callable, trees: List[Any], specs: List[Any], mesh,
               rules: Dict[str, Any], device: str, grad: bool
               ) -> TracedCell:
    """Trace ``fn(*trees)`` for one rank of ``mesh``.  ``trees``: trees
    of ``meta`` tensors (the global shapes); ``specs``: matching trees
    of specs.  ``fn`` returns a tree of DTensors; the graph's
    outputs are their local shards (replicated first where they hold
    partial sums)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate
    from torch.fx.experimental.proxy_tensor import make_fx

    leaves: List[torch.Tensor] = []
    places: List[list] = []
    for t, s in zip(trees, specs):
        flat = tree.flatten(t)
        flat_specs = _flat_specs(s, t)
        leaves += flat
        places += [part.placements(sp, mesh) for sp in flat_specs]
    fake_mode = FakeTensorMode()
    with fake_mode:
        local_args = [torch.empty(_local_shape(m.shape, pl, mesh),
                                  dtype=m.dtype, device=device)
                      for m, pl in zip(leaves, places)]

    def step(*locals_):
        dts = [DTensor.from_local(x, mesh, pl, run_check=False,
                                  shape=m.shape,
                                  stride=part.contiguous_stride(m.shape))
               for x, pl, m in zip(locals_, places, leaves)]
        it = iter(dts)
        args = [tree.unflatten(t, [next(it) for _ in tree.flatten(t)])
                for t in trees]
        ctx = contextlib.nullcontext() if grad else torch.no_grad()
        with ctx, logical_rules(rules):
            out = fn(*args)
        from torch.utils._pytree import tree_leaves
        res = []
        for o in tree_leaves(out):
            if isinstance(o, DTensor):
                if any(p.is_partial() for p in o.placements):
                    o = o.redistribute(mesh, [
                        Replicate() if p.is_partial() else p
                        for p in o.placements])
                o = o.to_local()
            if isinstance(o, torch.Tensor):
                res.append(o)
        return res

    from torch.fx import traceback as fx_traceback
    t0 = time.perf_counter()
    # nodes carry their model function's tag (``traced_source``)
    with fx_traceback.preserve_node_meta(), fold_loops():
        gm = make_fx(step, tracing_mode="fake")(*local_args)
    _drop_dead(gm.graph)
    gm.recompile()
    return TracedCell(gm=gm, args=local_args,
                      trace_s=time.perf_counter() - t0)


#: ops that make a fresh tensor with no data of the program's in it
_FACTORIES = frozenset({"empty", "empty_strided", "empty_like", "zeros",
                        "zeros_like", "full", "full_like"})


def _drop_dead(graph) -> None:
    """Drop what no result needs: DTensor's sharding propagation runs
    some ops at the global shape on empty tensors, and a tracer may
    record them (torch 2.11 does), an in-place copy into an empty
    tensor nobody reads among them.  The program does not run them: the
    unused nodes go, and so does a mutation whose target is a fresh
    tensor that nothing else reads."""
    def packet(node):
        return getattr(getattr(node.target, "overloadpacket", None),
                       "__name__", "")

    def mutates(node):
        schema = getattr(node.target, "_schema", None)
        return node.op == "call_function" and schema is not None \
            and schema.is_mutable
    while True:
        graph.eliminate_dead_code()
        dead = [n for n in graph.nodes
                if mutates(n) and not n.users and n.args
                and hasattr(n.args[0], "target")
                and packet(n.args[0]) in _FACTORIES
                and all(mutates(u) and not u.users
                        for u in n.args[0].users)]
        if not dead:
            return
        for n in dead:
            graph.erase_node(n)


def _flat_specs(specs, like) -> List[Any]:
    """The specs of ``like``'s leaves, in ``tree.flatten``'s order
    (specs are tuples, which ``tree.flatten`` would walk into)."""
    if isinstance(like, dict):
        out: List[Any] = []
        for k in like:
            out += _flat_specs(specs[k], like[k])
        return out
    if isinstance(like, tuple):
        out = []
        for i, v in enumerate(like):
            out += _flat_specs(specs[i], v)
        return out
    return [specs]


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _mesh_name(mesh, multi_pod: bool, dp_layout: bool) -> str:
    shape = part.mesh_shape(mesh)
    if tuple(shape.values()) in ((16, 16), (2, 16, 16), (256, 1),
                                 (2, 256, 1)):
        if dp_layout:
            return "pod2x256x1" if multi_pod else "pod256x1"
        return "pod2x16x16" if multi_pod else "pod16x16"
    return "mesh" + "x".join(str(n) for n in shape.values())


@contextlib.contextmanager
def cell_mesh(multi_pod: bool, overrides: Dict[str, Any],
              device_type: str = "cpu"):
    """The mesh a cell is traced on: the production mesh, or with the
    ``dp_layout`` override the (256, 1) / (2, 256, 1) one."""
    if overrides.get("dp_layout"):
        shape = (2, 256, 1) if multi_pod else (256, 1)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
        with make_mesh(shape, axes, device_type=device_type) as mesh:
            yield mesh
    else:
        with make_production_mesh(multi_pod=multi_pod,
                                  device_type=device_type) as mesh:
            yield mesh


def lower_cell(arch: str, shape: str, *, multi_pod: bool = False,
               overrides: Optional[Dict[str, Any]] = None,
               mesh=None, device: str = "cuda",
               spec: Optional[inp.ShapeSpec] = None,
               cfg: Optional[ModelConfig] = None):
    """Trace and analyze one (arch × shape × mesh) cell.  Returns
    (``TracedCell`` or None for a skip, meta dict).

    ``mesh``: trace on this mesh (default: open the production mesh, or
    the ``dp_layout`` one, for the call); ``spec``: a ``ShapeSpec`` to
    use in place of ``SHAPES[shape]`` (``shape`` then names its policy);
    ``cfg``: the configuration (default: ``get_config(arch)``)."""
    overrides = overrides or {}
    if mesh is None:
        with cell_mesh(multi_pod, overrides, device) as m:
            return lower_cell(arch, shape, multi_pod=multi_pod,
                              overrides=overrides, mesh=m, device=device,
                              spec=spec, cfg=cfg)
    sh = spec or inp.SHAPES[shape]
    mesh_name = _mesh_name(mesh, multi_pod, bool(overrides.get("dp_layout")))
    chips = mesh.size()
    cfg = tune_config(cfg or get_config(arch), shape, overrides, sh.kind)
    ok, why = inp.shape_applicable(cfg, sh.name)
    if not ok:
        return None, {"arch": arch, "shape": shape, "mesh": mesh_name,
                      "status": "skip", "reason": why}
    api = build(cfg)
    kind = sh.kind
    rules = default_rules(cfg, mesh)
    params = family_module(cfg).init(cfg, torch.Generator(), device="meta")
    mode = overrides.get("param_mode") or auto_param_mode(cfg, mesh)
    pspecs = (part.zero_shard_specs(cfg, params, mesh) if mode == "fsdp"
              else part.param_specs(cfg, params, mesh))

    extra: Dict[str, Any] = {}
    if kind == "train":
        mb = int(overrides.get("microbatches")
                 or microbatches_for(cfg, sh, mesh))
        opt_cfg = AdamWConfig()
        zspecs = part.zero_shard_specs(cfg, params, mesh)
        grad_specs = zspecs if (mb > 1 and not overrides.get(
            "no_grad_spec")) else None
        train_step = make_train_step(api, opt_cfg, num_microbatches=mb,
                                     grad_specs=grad_specs)
        state = {"params": params, "opt": adamw_init(params),
                 "step": torch.zeros((), dtype=torch.int32, device="meta")}
        state_specs = {"params": pspecs,
                       "opt": {"m": zspecs, "v": zspecs, "count": ()},
                       "step": ()}
        batch = inp.token_batch_structs(cfg, sh.global_batch, sh.seq_len,
                                        with_labels=True)
        traced = trace_step(train_step, [state, batch],
                            [state_specs,
                             part.input_specs_tree(cfg, batch, mesh)],
                            mesh, rules, device, grad=True)
        extra = {"microbatches": mb}
        tokens = sh.global_batch * sh.seq_len
    else:
        serve = tree.map(lambda p: torch.empty(p.shape, dtype=torch.bfloat16,
                                               device="meta"), params)
        cache = api.init_cache(sh.global_batch, sh.seq_len, device="meta")
        cspecs = part.cache_specs(cfg, cache, mesh)
        if kind == "prefill":
            batch = inp.token_batch_structs(cfg, sh.global_batch,
                                            sh.seq_len, with_labels=False)
            traced = trace_step(
                lambda p, b, c: api.prefill(p, b, c), [serve, batch, cache],
                [pspecs, part.input_specs_tree(cfg, batch, mesh), cspecs],
                mesh, rules, device, grad=False)
            tokens = sh.global_batch * sh.seq_len
        else:
            toks = torch.empty((sh.global_batch, 1), dtype=torch.int32,
                               device="meta")
            tok_spec = (part.batch_spec(mesh, 2)
                        if sh.global_batch % part.dp_size(mesh) == 0 else ())
            traced = trace_step(
                lambda p, t, c: api.decode_step(p, t, c),
                [serve, toks, cache], [pspecs, tok_spec, cspecs],
                mesh, rules, device, grad=False)
            tokens = sh.global_batch * 1

    mflops = model_flops(cfg, tokens, kind)
    notes = _notes(cfg, mesh)
    device_name = (torch.cuda.get_device_name(0)
                   if device == "cuda" and torch.cuda.is_available()
                   else None)
    terms = analyze_compiled(traced, arch, shape, mesh_name, chips, mflops,
                             notes=notes, device_name=device_name)
    st = traced.stats()
    meta = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "status": "ok",
        "kind": kind, "chips": chips, "compile_s": round(traced.trace_s, 1),
        "param_mode": mode,
        "tokens": tokens,
        "memory": {
            "argument_bytes": st.argument_bytes,
            "output_bytes": st.output_bytes,
            "temp_bytes": st.peak_bytes - st.argument_bytes,
            "peak_bytes": st.peak_bytes,
        },
        "roofline": terms.to_dict(),
        "graph_nodes": st.nodes,
        **extra,
    }
    return traced, meta


def _notes(cfg: ModelConfig, mesh) -> str:
    """What the cell's numbers do not show."""
    out = []
    if part.axis_size(mesh, "model") > NVLINK_DOMAIN:
        out.append(f"the {part.axis_size(mesh, 'model')}-wide model axis "
                   f"spans {part.axis_size(mesh, 'model') // NVLINK_DOMAIN} "
                   f"{NVLINK_DOMAIN}-GPU NVLink domains of an H100 cluster: "
                   f"the collective term (NVLink) is a lower bound")
    return "; ".join(out)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cells(archs, shapes, multi_pod: bool, out_dir: str,
              overrides: Optional[Dict[str, Any]] = None,
              tag: str = "", device: str = "cuda") -> int:
    os.makedirs(out_dir, exist_ok=True)
    overrides = overrides or {}
    failures = 0
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    with cell_mesh(multi_pod, overrides, device) as mesh:
        for arch in archs:
            for shape in shapes:
                suffix = f"-{tag}" if tag else ""
                path = os.path.join(
                    out_dir, f"{arch}--{shape}--{mesh_name}{suffix}.json")
                if os.path.exists(path):
                    print(f"[dryrun] SKIP (cached) {path}")
                    continue
                print(f"[dryrun] {arch} × {shape} × {mesh_name} ...",
                      flush=True)
                try:
                    _traced, meta = lower_cell(
                        arch, shape, multi_pod=multi_pod,
                        overrides=overrides, mesh=mesh, device=device)
                    if meta["status"] == "ok":
                        mem = meta["memory"]
                        print(f"  traced in {meta['compile_s']}s; "
                              f"args={_gb(mem['argument_bytes'])} "
                              f"temp={_gb(mem['temp_bytes'])} "
                              f"dominant={meta['roofline']['dominant']}")
                    else:
                        print(f"  SKIP: {meta['reason']}")
                except Exception as e:  # noqa: BLE001 - recorded, counted
                    failures += 1
                    meta = {"arch": arch, "shape": shape,
                            "mesh": mesh_name, "status": "fail",
                            "error": f"{type(e).__name__}: {e}",
                            "traceback": traceback.format_exc(limit=8)}
                    print(f"  FAIL: {type(e).__name__}: {e}")
                with open(path, "w") as f:
                    json.dump(meta, f, indent=2, default=str)
    return failures


def _gb(x) -> str:
    return "n/a" if x is None else f"{x / 2**30:.2f}GiB"


def parse_overrides(items: List[str]) -> Dict[str, Any]:
    """``key=value`` strings → a dict, each value JSON where it parses."""
    overrides: Dict[str, Any] = {}
    for ov in items:
        k, v = ov.split("=", 1)
        try:
            v = json.loads(v)
        except json.JSONDecodeError:
            pass
        overrides[k] = v
    return overrides


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out", default=RESULTS_DEFAULT)
    ap.add_argument("--tag", default="", help="suffix for experiment files")
    ap.add_argument("--override", action="append", default=[],
                    help="cfg override key=value (e.g. remat=none)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="the device of the fake tensors (default: the "
                         "card's)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("no CUDA device is available: pass --device cpu to trace "
                  "the cells on the CPU")
        return 2
    archs = list(list_archs()) if args.arch == "all" else args.arch.split(",")
    shapes = (list(inp.SHAPES) if args.shape == "all"
              else args.shape.split(","))
    return run_cells(archs, shapes, args.multi_pod, args.out,
                     overrides=parse_overrides(args.override),
                     tag=args.tag, device=args.device)


if __name__ == "__main__":
    sys.exit(main())
