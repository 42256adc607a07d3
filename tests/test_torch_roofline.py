"""The port's roofline (``repro_torch.roofline``) against the JAX
package's, on the CPU.

Exact equality: ``model_flops`` for every arch and kind; the arithmetic
of ``kernel_adjust`` (``flash_kernel_bytes``, ``attention_pair_trips``);
the report's tables and picks on the same cell JSONs.  Then the graph
analyzer, the torch counterpart of ``roofline/hlo.py``, on graphs whose
counts are known by hand: FLOPs, the cost meter's bytes, collective
bytes by kind, the static peak, and a folded loop weighed by its trips;
and the three terms in H100 terms.
"""
import io
import json
import os
from contextlib import redirect_stdout

import pytest
import torch

from repro.models import get_config as ref_get_config
from repro.models import list_archs as ref_list_archs
from repro.roofline import analysis as ref_analysis
from repro.roofline import kernel_adjust as ref_adjust
from repro.roofline import report as ref_report
from repro_torch.core.sysinfo import H100_PCIE, H100_SXM
from repro_torch.models import get_config, tracing
from repro_torch.roofline import analysis, graph, kernel_adjust, report
from repro_torch.roofline import model_flops, roofline_terms

ARCHS = list(ref_list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    for kind in ("train", "prefill", "decode"):
        for tokens in (1, 4096, 256 * 4096):
            assert model_flops(get_config(arch), tokens, kind) == \
                ref_analysis.model_flops(ref_get_config(arch), tokens, kind)


@pytest.mark.parametrize("args", [
    (1, 32768, 32768, 2, 64, True), (8, 4096, 4096, 4, 128, True),
    (2, 1024, 2048, 16, 64, False), (1, 256, 256, 1, 64, True, 4, 128)])
def test_flash_kernel_bytes_equal_reference(args):
    assert kernel_adjust.flash_kernel_bytes(*args) == \
        ref_adjust.flash_kernel_bytes(*args)


@pytest.mark.parametrize("args", [(32768, 32768, 512, 512),
                                  (4096, 4096, 512, 512),
                                  (1024, 2048, 128, 256), (64, 64, 64, 64)])
def test_attention_pair_trips_equal_reference(args):
    assert kernel_adjust.attention_pair_trips(*args) == \
        ref_adjust.attention_pair_trips(*args)


def _cells():
    """Cells in the dry-run's keys: ok (two meshes, one with
    microbatches), skip and fail."""
    def ok(arch, shape, mesh, c, m, k, mb=None, mode="tp"):
        cell = {"arch": arch, "shape": shape, "mesh": mesh, "status": "ok",
                "kind": "train", "chips": 256, "compile_s": 12.5,
                "param_mode": mode, "tokens": 1048576,
                "memory": {"argument_bytes": 3 * 2**30,
                           "output_bytes": 28, "temp_bytes": 2**31,
                           "peak_bytes": 5 * 2**30},
                "roofline": {"compute_s": c, "memory_s": m,
                             "collective_s": k,
                             "dominant": max(
                                 {"compute": c, "memory": m,
                                  "collective": k}.items(),
                                 key=lambda kv: kv[1])[0],
                             "useful_ratio": 0.52, "collective_bytes_": 2.9e10,
                             "per_kind": {"all-gather": 4.4e7,
                                          "all-reduce": 2.2e10,
                                          "reduce-scatter": 6.4e9,
                                          "all-to-all": 0.0,
                                          "collective-permute": 0.0}}}
        if mb:
            cell["microbatches"] = mb
        return cell
    return [
        ok("llama3.2-1b", "train_4k", "pod16x16", 0.0588, 0.744, 0.0629, 4),
        ok("llama3.2-1b", "prefill_32k", "pod16x16", 0.0213, 0.676, 0.0197),
        ok("mamba2-780m", "decode_32k", "pod16x16", 2e-5, 4e-4, 3e-2,
           mode="fsdp"),
        ok("llama3.2-1b", "decode_32k", "pod2x16x16", 1.2e-5, 2.2e-3, 1e-6),
        {"arch": "llama3.2-1b", "shape": "long_500k", "mesh": "pod16x16",
         "status": "skip", "reason": "long_500k skipped"},
        {"arch": "whisper-small", "shape": "train_4k", "mesh": "pod16x16",
         "status": "fail", "error": "RuntimeError: x"},
    ]


def _write(directory, cells, tag=""):
    for d in cells:
        suffix = f"-{tag}" if tag else ""
        with open(os.path.join(
                directory, f"{d['arch']}--{d['shape']}--{d['mesh']}{suffix}"
                ".json"), "w") as f:
            json.dump(d, f)


def test_report_tables_equal_reference(tmp_path):
    _write(tmp_path, _cells())
    _write(tmp_path, _cells()[:1], tag="exp")
    for mesh in ("pod16x16", "pod2x16x16", None):
        for tag in ("", "exp"):
            mine = report.load_cells(str(tmp_path), mesh, tag)
            ref = ref_report.load_cells(str(tmp_path), mesh, tag)
            assert mine == ref
            assert report.roofline_table(mine) == ref_report.roofline_table(ref)
            assert report.dryrun_table(mine) == ref_report.dryrun_table(ref)
            if any(d["status"] == "ok" for d in ref):
                assert report.pick_hillclimb(mine) == \
                    ref_report.pick_hillclimb(ref)
            else:                       # both refuse a set with no ok cell
                for pick in (report.pick_hillclimb,
                             ref_report.pick_hillclimb):
                    with pytest.raises(ValueError):
                        pick(mine)
    for x in (0, 3e-5, 0.25, 4.5):
        assert report.fmt_s(x) == ref_report.fmt_s(x)
    outs = []
    for main in (report.main, ref_report.main):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert main(["--dir", str(tmp_path)]) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]


def _trace(fn, *args, fold=False):
    from torch.fx import traceback as fx_traceback
    from torch.fx.experimental.proxy_tensor import make_fx
    ctx = tracing.fold_loops() if fold else fx_traceback.preserve_node_meta()
    with fx_traceback.preserve_node_meta(), ctx:
        return make_fx(fn, tracing_mode="fake")(*args)


def test_graph_counts_by_hand():
    x, w = torch.randn(4, 8), torch.randn(8, 16)
    gm = _trace(lambda a, b: torch.relu(a @ b), x, w)
    st = graph.analyze_graph(gm, [x, w])
    assert st.flops == 2 * 4 * 8 * 16
    # mm: x, w and its result; relu: its operand and result (float32)
    assert st.bytes_accessed == (32 + 128 + 64) * 4 + (64 + 64) * 4
    assert st.collective_bytes == 0
    assert st.argument_bytes == (32 + 128) * 4
    assert st.output_bytes == 64 * 4
    # the product's result is freed after the relu has read it
    assert st.peak_bytes == (32 + 128 + 64 + 64) * 4
    assert graph.graph_flops(gm, [x, w]) == st.flops


def test_folded_loop_weighs_its_body():
    x, w = torch.randn(4, 8), torch.randn(8, 8)

    def f(a, b):
        for _ in tracing.repeated(list(range(3))):      # nested: 3 × 5
            for _ in tracing.repeated(list(range(5))):
                a = a @ b
            a = a + 1.0
        return a
    folded = _trace(f, x, w, fold=True)
    unrolled = _trace(f, x, w)
    st_f = graph.analyze_graph(folded, [x, w])
    st_u = graph.analyze_graph(unrolled, [x, w])
    assert len(folded.graph.nodes) < len(unrolled.graph.nodes)
    assert st_f.flops == st_u.flops == 15 * 2 * 4 * 8 * 8
    assert st_f.bytes_accessed == st_u.bytes_accessed


def test_collective_bytes_by_kind_on_a_fake_group():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.launch.mesh import make_mesh
    with make_mesh((4,), ("model",)) as mesh:
        def f(x, w):
            xd = DTensor.from_local(x, mesh, [Shard(1)], run_check=False)
            wd = DTensor.from_local(w, mesh, [Shard(0)], run_check=False)
            y = (xd @ wd).redistribute(mesh, [Replicate()])   # all-reduce
            z = wd.redistribute(mesh, [Replicate()])          # all-gather
            return y.to_local(), z.to_local()
        x, w = torch.randn(4, 2), torch.randn(2, 16)
        gm = _trace(f, x, w)
        coll = graph.collective_bytes(gm.graph)
        st = graph.analyze_graph(gm, [x, w])
    assert coll["per_kind_bytes"]["all-reduce"] == 4 * 16 * 4
    assert coll["per_kind_bytes"]["all-gather"] == 2 * 16 * 4
    assert coll["per_kind_count"] == {"all-gather": 1, "all-reduce": 1,
                                      "reduce-scatter": 0, "all-to-all": 0,
                                      "collective-permute": 0}
    assert st.collective_bytes == coll["total_bytes"] == (64 + 32) * 4
    assert st.flops == 2 * 4 * 2 * 16          # one rank's product


def test_roofline_terms_in_h100_terms():
    t = roofline_terms("a", "s", "m", 256, flops=989e12, bytes_accessed=1e9,
                       coll_bytes=1e8, mflops=5e16)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1e9 / 3.35e12)
    # NVLink's 900 GB/s is both directions summed: one carries 450
    assert t.collective_s == pytest.approx(1e8 / 450e9)
    assert t.dominant == "compute" and t.bound_time() == t.compute_s
    assert t.useful_ratio == pytest.approx(5e16 / (989e12 * 256))
    t2 = roofline_terms("a", "s", "m", 8, flops=1e9, bytes_accessed=1e9,
                        coll_bytes=1e10, mflops=1e9,
                        device_name="NVIDIA H100 PCIe")
    assert t2.dominant == "collective"
    assert t2.collective_s == pytest.approx(1e10 / 300e9)
    assert H100_SXM["nvlink_bandwidth"] == 900e9
    assert H100_PCIE["nvlink_bandwidth"] == 600e9
    assert set(t.to_dict()) == set(ref_analysis.RooflineTerms(
        "a", "s", "m", 1, 0, 0, 0, 0, 0, 0, "compute", 0, 0).to_dict())
    assert analysis.collective_bytes is graph.collective_bytes
