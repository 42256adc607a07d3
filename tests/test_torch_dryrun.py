"""The port's dry-run (``repro_torch.launch.dryrun``) on the CPU: cells
traced for one rank of a mesh over a fake process group.

On an 8-rank (2, 4) mesh, llama3.2-1b at two layers and the shapes'
full batch and length: decode_32k and train_4k are ``ok`` with the
reference's keys and a nonzero all-reduce, and their per-rank FLOPs × 8
equal the one-rank (1, 1) trace's within 1 % (every dim of llama3.2-1b
divides by 4, so any excess would be work that DTensor replicated).  On
(1, 16) the decode step keeps its cache split by position (K = 8 kv
heads on a 16-wide axis): no collective moves the cache.  One reduced
cell of each other family is ``ok``.  The CLI writes cells (a skip
among them, a failure recorded and counted), ``roofline.report`` and
the model scope's ``dryrun_rooflines`` read them as the reference's
read the same files, and ``kernel_adjust`` and ``profile`` read a
traced cell.  Every test writes under ``tmp_path`` and leaves no
process group behind.
"""
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import pytest
import torch
import torch.distributed as dist

from repro.roofline.analysis import RooflineTerms as RefTerms
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import ShapeSpec
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import get_config
from repro_torch.roofline import kernel_adjust, profile, report

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the reference's cell keys (``src/repro/launch/dryrun.py``), less the
#: CPU widening artifact and the TPU-corrected peak
CELL_KEYS = {"arch", "shape", "mesh", "status", "kind", "chips",
             "compile_s", "param_mode", "tokens", "memory", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}


def llama2():
    return get_config("llama3.2-1b").override(num_layers=2)


def cell(shape, mesh_shape, cfg, arch="llama3.2-1b", spec=None,
         **overrides):
    """One cell traced on a fake (data, model) mesh, its fake tensors on
    the CPU."""
    with make_mesh(mesh_shape, ("data", "model")) as mesh:
        traced, meta = dryrun.lower_cell(arch, shape, mesh=mesh, cfg=cfg,
                                         spec=spec, overrides=overrides,
                                         device="cpu")
    assert not dist.is_initialized()
    return traced, meta


@pytest.mark.parametrize("shape,overrides", [
    ("decode_32k", {}), ("train_4k", {"microbatches": 2})])
def test_llama_cells_conserve_flops(shape, overrides):
    _, meta = cell(shape, (2, 4), llama2(), **overrides)
    assert meta["status"] == "ok" and meta["mesh"] == "mesh2x4"
    assert CELL_KEYS <= set(meta) and set(meta["memory"]) == MEMORY_KEYS
    r = meta["roofline"]
    assert set(r) == set(RefTerms("a", "s", "m", 1, 0, 0, 0, 0, 0, 0,
                                  "compute", 0, 0).to_dict())
    assert meta["chips"] == 8 and r["per_kind"]["all-reduce"] > 0
    assert meta["memory"]["peak_bytes"] == \
        meta["memory"]["argument_bytes"] + meta["memory"]["temp_bytes"]
    if shape == "train_4k":
        assert meta["microbatches"] == 2
        assert r["per_kind"]["reduce-scatter"] > 0    # grad_specs (ZeRO)
    _, one = cell(shape, (1, 1), llama2(), **overrides)
    assert one["roofline"]["collective_bytes_"] == 0
    per_rank, whole = r["hlo_flops"], one["roofline"]["hlo_flops"]
    assert abs(per_rank * 8 - whole) <= 0.01 * whole


def test_decode_keeps_a_sequence_split_cache():
    traced, meta = cell("decode_32k", (1, 16), llama2())
    assert meta["status"] == "ok"
    # [L, B, S/16, K, hd] bf16 k and v on each rank
    cache = 2 * 2 * 128 * (32768 // 16) * 8 * 64 * 2
    coll = meta["roofline"]["per_kind"]
    assert max(coll.values()) < cache / 100
    assert coll["all-reduce"] > 0               # the flash-decode combine
    assert any(c.source == "_write_at_sharded" or c.source == "write_at"
               for c in traced.stats().per_node)


@pytest.mark.parametrize("arch,shape", [
    ("deepseek-moe-16b", "decode_32k"), ("mamba2-780m", "decode_32k"),
    ("jamba-v0.1-52b", "decode_32k"), ("whisper-small", "decode_32k"),
    ("qwen2-vl-2b", "decode_32k"), ("mamba2-780m", "train_4k"),
    ("qwen2-vl-2b", "train_4k")])
def test_other_families_trace(arch, shape, monkeypatch):
    # a train cell at 8 × 256 under the train_4k policy: the SSD's and
    # M-RoPE's backward, at a tenth of the shape's trace
    spec = ShapeSpec(shape, 256, 8, "train") if shape == "train_4k" \
        else None
    cfg = get_config(arch).reduced()
    traced, meta = cell(shape, (2, 4), cfg, arch=arch, spec=spec)
    assert meta["status"] == "ok", meta
    assert meta["roofline"]["hlo_flops"] > 0
    if cfg.moe_num_experts:
        # the expert-parallel branch: each rank runs E/4 experts, where
        # the experts gathered on every rank run them all
        assert cfg.moe_num_experts % 4 == 0
        assert "moe_shard_map" not in meta["roofline"]["notes"]
        assert any(c.source == "moe_shard_map"
                   for c in traced.stats().per_node)
        rules = dryrun.default_rules
        monkeypatch.setattr(dryrun, "default_rules", lambda c, m: dict(
            rules(c, m), experts=None))
        gathered, gmeta = cell(shape, (2, 4), cfg, arch=arch, spec=spec)
        assert not any(c.source == "moe_shard_map"
                       for c in gathered.stats().per_node)
        assert meta["roofline"]["hlo_flops"] \
            < gmeta["roofline"]["hlo_flops"]


def _run_module(module, *args):
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=600)


def test_cli_writes_cells_the_readers_take(tmp_path):
    out = tmp_path / "dryrun"
    rc = dryrun.main(["--arch", "llama3.2-1b", "--shape",
                      "decode_32k,long_500k", "--device", "cpu",
                      "--out", str(out)])
    assert rc == 0 and not dist.is_initialized()
    files = sorted(os.listdir(out))
    assert files == ["llama3.2-1b--decode_32k--pod16x16.json",
                     "llama3.2-1b--long_500k--pod16x16.json"]
    ok = json.loads((out / files[0]).read_text())
    skip = json.loads((out / files[1]).read_text())
    assert ok["status"] == "ok" and ok["chips"] == 256
    assert "lower bound" in ok["roofline"]["notes"]
    assert skip["status"] == "skip" and "long_500k skipped" in skip["reason"]
    # a second run finds the cells cached
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert dryrun.main(["--arch", "llama3.2-1b", "--shape",
                            "decode_32k", "--device", "cpu", "--out",
                            str(out)]) == 0
    assert "SKIP (cached)" in buf.getvalue()
    # the report reads them as the reference's does
    for module in ("repro_torch.roofline.report", "repro.roofline.report"):
        res = _run_module(module, "--dir", str(out))
        assert res.returncode == 0, res.stderr
        assert "| llama3.2-1b | decode_32k | ok |" in res.stdout
    # so does the model scope, in either package
    counters = []
    for package, extra in (("repro_torch", ["--device", "cpu"]),
                           ("repro", [])):
        doc = tmp_path / f"{package}.json"
        res = _run_module(package, "run", "--enable-scope", "model",
                          "--benchmark_filter", "dryrun_rooflines",
                          "--model.dryrun_dir", str(out), "--results-dir",
                          "", "--benchmark_out", str(doc), *extra)
        assert res.returncode == 0, res.stderr
        (rec,) = json.loads(doc.read_text())["benchmarks"]
        counters.append((rec["cells"], rec["sum_bound_s"]))
    r = ok["roofline"]
    assert counters[0] == counters[1] == (
        1, max(r["compute_s"], r["memory_s"], r["collective_s"]))


def test_cli_records_and_counts_a_failure(tmp_path):
    rc = dryrun.main(["--arch", "no-such-arch", "--shape", "decode_32k",
                      "--device", "cpu", "--out", str(tmp_path)])
    assert rc == 1 and not dist.is_initialized()
    (f,) = os.listdir(tmp_path)
    d = json.loads((tmp_path / f).read_text())
    assert d["status"] == "fail" and d["error"].startswith("KeyError")
    assert report.roofline_table([d]).endswith(
        "| no-such-arch | decode_32k | FAIL | - | - | - | - | - | - | - | - |")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_cli_needs_a_card_or_cpu():
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k"]) \
        == 2


def test_kernel_adjust_and_profile_read_a_cell():
    cfg = llama2().override(attn_chunk_q=128, attn_chunk_k=128)
    traced, meta = cell("prefill_32k", (2, 4), cfg)
    st = traced.stats()
    B, S, H, D = 32 // 2, 32768, 32 // 4, 64
    kb = 2 * kernel_adjust.flash_kernel_bytes(B, S, S, H, D, True, bq=128)
    adj = kernel_adjust.adjust_memory_term(st, kb)
    assert 0 < adj["pair_scan_bytes"] < adj["measured_bytes"]
    assert adj["adjusted_bytes"] == pytest.approx(
        st.bytes_accessed - adj["pair_scan_bytes"] + kb)
    byte_rows, flop_rows = profile.top_contributors(st, 5)
    assert len(byte_rows) == len(flop_rows) == 5
    assert [r[0] for r in flop_rows] == sorted((r[0] for r in flop_rows),
                                               reverse=True)
    assert flop_rows[0][1] in ("aten.mm", "aten.bmm")
    assert sum(c.flops for c in st.per_node) == pytest.approx(st.flops)


def test_dead_scratch_is_dropped_from_the_trace():
    """What no result needs leaves the traced graph — a copy into a
    fresh tensor nobody reads among it (DTensor's propagation records
    such global-shaped scratch on some torch versions) — while a
    mutation of an argument stays."""
    from torch.fx.experimental.proxy_tensor import make_fx

    def f(x, y):
        scratch = torch.empty(64, 64)
        scratch.copy_(y)              # read by nothing
        x.add_(1.0)                   # the program's own mutation
        return x * 2
    gm = make_fx(f, tracing_mode="fake")(torch.zeros(4), torch.zeros(64, 64))
    dryrun._drop_dead(gm.graph)
    ops = [str(n.target) for n in gm.graph.nodes if n.op == "call_function"]
    assert ops == ["aten.add_.Tensor", "aten.mul.Tensor"]


def test_library_entry_points_default_to_the_card():
    """``lower_cell``, ``run_cells`` and ``profile_cell`` place their
    fake tensors on the card unless asked for the CPU, as their CLIs
    do (a CPU trace hid faults that the card's showed)."""
    import inspect
    for fn in (dryrun.lower_cell, dryrun.run_cells, profile.profile_cell):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
