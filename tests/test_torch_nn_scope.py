"""The torch port's nn scope (cuDNN|Scope) as a whole, on the CPU:
``python -m repro_torch run --enable-scope nn`` against the JAX
package's run, the scope's families against the reference's, and each
family's function on the reference's own fixture inputs carried across
with ``bridge.from_numpy``.

The port's ``torch`` backend stands where the reference's ``xla`` stood,
its ``cuda`` backend (the hand-written kernel) where ``pallas`` stood,
and the kernel families are renamed ``flash_attention_pallas`` →
``flash_attention_cuda`` and ``ssd_scan_pallas`` → ``ssd_scan_cuda``.
A CPU run leaves the ``cuda`` rows and families out, so the kernels'
wrappers are called directly here, where a CPU tensor takes the plain
version.  Tolerances are the reference's (tests/test_layers.py,
tests/test_kernels.py).
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.flags import FlagRegistry as RefFlagRegistry
from repro.core.hooks import HookChain as RefHookChain
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.scope import ScopeManager as RefScopeManager
from repro.kernels.flash_attention import flash_attention_ref as jax_attention
from repro.models import layers as RL
from repro_torch.core.bridge import from_numpy
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.scope import ScopeManager
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm
from repro_torch.kernels.ssd_scan import ssd
from repro_torch.models import layers as TL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = {"xla": "torch", "pallas": "cuda"}              # reference → port
FAMILIES = {"flash_attention_pallas": "flash_attention_cuda",
            "ssd_scan_pallas": "ssd_scan_cuda"}
#: The reference's families that run on plain XLA: the ones a CPU run of
#: both packages can pair (its kernel families run in interpret mode).
PLAIN_FAMILIES = ("flash_attention_fwd", "flash_attention_bwd", "rmsnorm",
                  "moe_dispatch_scatter", "ssd_chunked_scan")


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def _run(package, args, out):
    argv = [sys.executable, "-m", package, "run", "--enable-scope", "nn",
            *args, "--benchmark_min_time", "0.01", "--benchmark_out",
            str(out)]
    argv += ["--results-dir", ""]
    r = subprocess.run(argv, capture_output=True, text=True, env=_env(),
                       cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr
    return json.loads(out.read_text())


def _port_name(ref_name: str) -> str:
    scope, family, *axes = ref_name.split("/")
    axes = [f"backend:{BACKENDS[a.split(':', 1)[1]]}"
            if a.startswith("backend:") else a for a in axes]
    return "/".join([scope, FAMILIES.get(family, family), *axes])


def test_nn_run_on_cpu_pairs_with_reference(tmp_path):
    port = _run("repro_torch", ["--device", "cpu"], tmp_path / "p.json")
    ref = _run("repro", ["--benchmark_filter",
                         "^nn/(" + "|".join(PLAIN_FAMILIES) + ")"],
               tmp_path / "r.json")
    records = {rec["name"]: rec for rec in port["benchmarks"]}
    # a CPU document holds no CUDA row or family: no CUDA kernel ran
    assert not [n for n in records if "cuda" in n]
    for name, rec in records.items():
        assert not rec.get("error_occurred"), (name, rec)
        assert rec["real_time"] > 0 and rec["compile_time_s"] >= 0
    paired = [r for r in ref["benchmarks"] if "backend:pallas" not in r["name"]]
    assert sorted(_port_name(r["name"]) for r in paired) == sorted(records)
    for ref_rec in paired:
        rec = records[_port_name(ref_rec["name"])]
        assert sorted(rec) == sorted(ref_rec)
    S = 1024
    assert records[f"nn/flash_attention_fwd/seq:{S}"]["attn_flops"] == \
        4.0 * 2 * 4 * S * S * 64 / 2
    assert records["nn/flash_attention_bwd/seq:512"]["attn_flops"] == \
        2.5 * 4.0 * 2 * 4 * 512 * 512 * 64 / 2
    rms = records["nn/rmsnorm/backend:torch/rows:4096/d:1024"]
    assert rms["bytes_per_second"] == pytest.approx(
        2 * 4 * 4096 * 1024 / (rms["real_time"] * 1e-6), rel=1e-6)
    ctx = port["context"]
    assert ctx["backend"] == "cpu"
    assert ctx["scopes"] == {"example": "disabled", "mxu": "disabled",
                             "histo": "disabled", "nn": "enabled",
                             "linalg": "disabled", "instr": "disabled",
                             "comm": "disabled", "io": "disabled"}


def test_nn_param_selects_the_same_small_point(tmp_path):
    args = ["--param", "seq=256"]
    port = _run("repro_torch", ["--device", "cpu", *args], tmp_path / "p.json")
    ref = _run("repro", args, tmp_path / "r.json")
    names = sorted(r["name"] for r in port["benchmarks"])
    assert names == ["nn/flash_attention_bwd/seq:256",
                     "nn/flash_attention_fwd/seq:256"]
    assert names == sorted(_port_name(r["name"]) for r in ref["benchmarks"])


def _families(mgr_cls, registry, flags, hooks):
    mgr = mgr_cls(registry=registry, flags=flags, hooks=hooks)
    mgr.load()
    mgr.configure(enable=["nn"])
    mgr.register_all()
    return {b.name: b for b in registry.all()}


def _ref_families():
    return _families(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                     RefHookChain())


def _port_families(device):
    before = FLAGS.get("device")
    FLAGS.set("device", device)
    try:
        return _families(ScopeManager, BenchmarkRegistry(), FlagRegistry(),
                         HookChain())
    finally:
        FLAGS.set("device", before)


def _instances(bench):
    return [name for name, _ in bench.instances()]


def test_nn_families_pair_with_reference():
    """On the card every reference family has its port family; the
    plain families keep the reference's instances, and each kernel row
    or family takes the points of its plain sibling.  On the CPU the
    kernel rows and families are left out."""
    ref = _ref_families()
    card = _port_families("cuda")
    assert sorted(_port_name(n) for n in ref) == sorted(card)
    for family in PLAIN_FAMILIES:
        want = [_port_name(n) for n in _instances(ref[f"nn/{family}"])
                if "backend:pallas" not in n]
        got = [n for n in _instances(card[f"nn/{family}"])
               if "backend:cuda" not in n]
        assert got == want
    rms = _instances(card["nn/rmsnorm"])
    assert [n for n in rms if "backend:cuda" in n] == \
        [n.replace("backend:torch", "backend:cuda") for n in rms
         if "backend:torch" in n]
    seqs = [n.rsplit("/", 1)[1] for n in
            _instances(card["nn/flash_attention_fwd"])]
    assert [n.rsplit("/", 1)[1] for n in
            _instances(card["nn/flash_attention_cuda"])] == seqs
    seqs = [n.rsplit("/", 1)[1] for n in
            _instances(card["nn/ssd_chunked_scan"])]
    assert [n.rsplit("/", 1)[1] for n in
            _instances(card["nn/ssd_scan_cuda"])] == seqs
    cpu = _port_families("cpu")
    assert sorted(cpu) == sorted(f"nn/{f}" for f in PLAIN_FAMILIES)
    assert not [n for b in cpu.values() for n in _instances(b)
                if "cuda" in n]


def _fixture(families, family, **point):
    bench = families[family]
    for _, params in bench.instances():
        if dict(params) == point:
            return bench.fixture(params)
    raise KeyError(point)


@pytest.fixture(scope="module")
def fams():
    """Both packages' nn families; the port's registered for the CPU,
    where its fixtures allocate (they read FLAGS' device when called)."""
    ref, port = _ref_families(), _port_families("cpu")
    before = FLAGS.get("device")
    FLAGS.set("device", "cpu")
    yield ref, port
    FLAGS.set("device", before)


def _carry(*arrays):
    return from_numpy(tuple(np.asarray(a) for a in arrays))


def test_flash_fixtures_on_reference_inputs(fams):
    ref, port = fams
    fn, *operands = _fixture(ref, "nn/flash_attention_fwd", seq=256)
    want = np.asarray(fn(*operands))
    pfn, pq, *_ = _fixture(port, "nn/flash_attention_fwd", seq=256)
    tq, tk, tv = _carry(*operands)
    assert pq.shape == tq.shape and pq.device.type == "cpu"
    np.testing.assert_allclose(pfn(tq, tk, tv).numpy(), want, atol=2e-5)
    # the kernel family: its oracle on the reference's (cut) operands
    fn, *operands = _fixture(ref, "nn/flash_attention_pallas", seq=128)
    want = np.asarray(jax_attention(*operands, causal=True))
    got = flash_attention(*_carry(*operands), causal=True)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


def test_flash_bwd_fixture_on_reference_inputs(fams):
    ref, port = fams
    fn, *operands = _fixture(ref, "nn/flash_attention_bwd", seq=256)
    want = fn(*operands)
    pfn, pq, *_ = _fixture(port, "nn/flash_attention_bwd", seq=256)
    assert pq.requires_grad
    got = pfn(*(t.requires_grad_() for t in _carry(*operands)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("ref_backend,rows,d", [("xla", 4096, 1024),
                                                ("pallas", 1024, 1024)])
def test_rmsnorm_fixture_on_reference_inputs(fams, ref_backend, rows, d):
    ref, port = fams
    fn, x = _fixture(ref, "nn/rmsnorm", backend=ref_backend, rows=rows, d=d)
    want = np.asarray(fn(x))
    (tx,) = _carry(x)
    scale = torch.ones(d)
    np.testing.assert_allclose(rmsnorm(tx, scale).numpy(), want, atol=1e-5)
    pfn, px = _fixture(port, "nn/rmsnorm", backend="torch", rows=4096, d=d)
    np.testing.assert_allclose(pfn(tx).numpy(), want, atol=1e-5)
    assert px.dtype == torch.float32 and px.shape == (4096, d)


def test_moe_fixture_on_reference_inputs(fams):
    ref, port = fams
    fn, x = _fixture(ref, "nn/moe_dispatch_scatter", tokens=1024)
    want = np.asarray(fn(x))
    # the reference fixture's parameters: init_moe(PRNGKey(0), ...)
    params = RL.init_moe(jax.random.PRNGKey(0), 256, 8, 512, 0)
    tparams = from_numpy({k: np.asarray(v) for k, v in params.items()})
    (tx,) = _carry(x)
    got, _ = TL.moe_scatter(tparams, tx, top_k=2, capacity_factor=1.25)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    pfn, px = _fixture(port, "nn/moe_dispatch_scatter", tokens=1024)
    y = pfn(px)
    assert y.shape == px.shape and torch.isfinite(y).all()


def test_ssd_fixtures_on_reference_inputs(fams):
    ref, port = fams
    fn, *operands = _fixture(ref, "nn/ssd_chunked_scan", seq=1024)
    want = np.asarray(fn(*operands))
    targs = _carry(*operands)
    pfn, *pops = _fixture(port, "nn/ssd_chunked_scan", seq=1024)
    assert [(p.shape, p.dtype) for p in pops] == \
        [(t.shape, t.dtype) for t in targs]
    np.testing.assert_allclose(pfn(*targs).numpy(), want, atol=3e-5)
    np.testing.assert_allclose(ssd(*targs, chunk=128)[0].numpy(), want,
                               atol=3e-5)
    # the kernel family: Pallas in interpret mode at its tuned chunk
    fn, *operands = _fixture(ref, "nn/ssd_scan_pallas", seq=512)
    want = np.asarray(fn(*operands))
    y, _ = ssd(*_carry(*operands), chunk=128)
    np.testing.assert_allclose(y.numpy(), want, atol=3e-5)
