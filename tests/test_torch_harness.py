"""The torch port's harness core against the JAX package's, on the CPU.

Quantiles, parameter spaces and instance names must agree exactly with
the reference on shared inputs; ``python -m repro_torch run --device
cpu`` over the numpy-only example scope must write records with the
reference's keys, which the reference's ``compare`` pairs by name.  The
subprocesses inherit ``os.environ`` (jax's platform probe hangs without
``JAX_PLATFORMS``).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.core import baseline as ref_baseline
from repro.core import quantile as ref_quantile
from repro.core.benchmark import ParamSpace as RefParamSpace
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.registry import register_benchmark as ref_register
from repro.core.runner import RunRecord as RefRunRecord
from repro_torch.core import main as port_main
from repro_torch.core import measure, quantile, sysinfo
from repro_torch.core.benchmark import ParamSpace, State
from repro_torch.core.bridge import from_numpy
from repro_torch.core.registry import BenchmarkRegistry, register_benchmark
from repro_torch.core.runner import RunRecord

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def run_cli(package: str, *args: str, out=None, timeout: int = 300):
    """``python -m <package> run ...``; returns (rc, document or None)."""
    argv = [sys.executable, "-m", package, "run", *args]
    argv += ["--results-dir", ""]
    if out is not None:
        argv += ["--benchmark_out", str(out)]
    r = subprocess.run(argv, capture_output=True, text=True, env=_env(),
                       cwd=ROOT, timeout=timeout)
    doc = None
    if out is not None and r.returncode == 0:
        with open(out) as f:
            doc = json.load(f)
    return r.returncode, doc, r.stderr


# -- quantiles --------------------------------------------------------------

@pytest.mark.parametrize("seed,size", [(0, 1), (1, 4), (2, 5), (3, 97),
                                       (4, 1000)])
def test_quantiles_match_reference(seed, size):
    rng = np.random.default_rng(seed)
    xs = list(rng.exponential(1.0, size))
    for q in (0.0, 0.25, 0.5, 0.9, 0.99, 0.999, 1.0):
        assert quantile.percentile(xs, q) == ref_quantile.percentile(xs, q)
    assert quantile.tail_percentiles(xs, "latency_") == \
        ref_quantile.tail_percentiles(xs, "latency_")
    half = size // 2
    assert quantile.combine(xs[half:], xs[:half]) == \
        ref_quantile.combine(xs[half:], xs[:half])
    for q in (0.5, 0.99):
        port, ref = quantile.StreamingQuantile(q), \
            ref_quantile.StreamingQuantile(q)
        for v in xs:
            port.observe(v)
            ref.observe(v)
        assert port.value() == ref.value()


# -- parameter spaces and names --------------------------------------------

def _spaces(PS):
    return [
        PS.product(backend=["torch", "cuda"], dtype=["f32", "bf16"],
                   n=[256, 512, 1024]),
        PS.product(dtype=["f32"], n=[1 << 14], flag=[True, False],
                   scale=[0.5]),
        PS.zip(a=[1, 2, 3], b=["x", "y", "z"]),
        PS.cases({"n": 1}, {"n": 2, "m": 3}) + PS.cases({"n": 5}),
        PS.product(n=[1, 2]) * PS.product(k=["a", "b"]),
        PS.product(n=[1 << 16, 1 << 20], bins=[256, 4096])
        .where(lambda p: p.n > p.bins * 100),
    ]


def _names(register, registry, space):
    b = register("fam", lambda s: None, scope="sc", registry=registry)
    b.param_space(space)
    return [(name, params.canonical(), params.int_values())
            for name, params in b.instances()]


@pytest.mark.parametrize("index", range(6))
def test_param_space_instance_names_match_reference(index):
    ref = _names(ref_register, RefRegistry(), _spaces(RefParamSpace)[index])
    port = _names(register_benchmark, BenchmarkRegistry(),
                  _spaces(ParamSpace)[index])
    assert port == ref


@pytest.mark.parametrize("build", [
    lambda b: b.range_multiplier_args(1 << 8, 1 << 16, mult=4)
    .set_arg_names(["n"]),
    lambda b: b.args([1, 2]).args([3, 4]),
    lambda b: b.ranges([(1, 8), (16, 32)]),
    lambda b: b.args_product([[1, 2], [5, 6]]).set_arg_names(["a", "b"]),
    lambda b: b,
])
def test_legacy_instance_names_match_reference(build):
    ref = build(ref_register("fam", lambda s: None, scope="sc",
                             registry=RefRegistry()))
    port = build(register_benchmark("fam", lambda s: None, scope="sc",
                                    registry=BenchmarkRegistry()))
    assert [n for n, _ in port.instances()] == \
        [n for n, _ in ref.instances()]


def test_duplicates_rejected_like_reference():
    for PS in (RefParamSpace, ParamSpace):
        with pytest.raises(ValueError, match="duplicate parameter point"):
            PS.cases({"n": 1}, {"n": 1})
    ref = ref_register("f", lambda s: None, registry=RefRegistry())
    port = register_benchmark("f", lambda s: None,
                              registry=BenchmarkRegistry())
    for b in (ref, port):
        b.args([1])
        with pytest.raises(ValueError, match="duplicate arg-set"):
            b.args([1])


def test_record_keys_match_reference():
    fields = dict(name="f/n:1", run_name="f/n:1", run_type="iteration",
                  iterations=3, real_time=1.0, cpu_time=0.5, time_unit="us",
                  bytes_per_second=2.0, items_per_second=3.0, label="l",
                  compile_time_s=0.1, counters={"flops": 1.0,
                                                "real_time": 9.0})
    assert RunRecord(**fields).to_json() == RefRunRecord(**fields).to_json()


# -- measurement ------------------------------------------------------------

def test_fence_is_a_no_op_without_cuda_tensors():
    st = State()
    measure.default_sync(st, "f")            # nothing delivered, no fixture
    st.fixture = (np.ones(3), torch.ones(3))
    st.deliverables = {"out": [torch.ones(2)]}
    assert measure.cuda_devices(st.deliverables) == []
    measure.default_sync(st, "f")
    assert "f" not in measure._WEAK_FENCE_WARNED
    assert [t.shape for t in measure.tensor_leaves(
        ((torch.ones(1),), {"a": torch.ones(2)}, 3))] == \
        [torch.Size([1]), torch.Size([2])]


def test_meter_stack_times_a_body():
    reg = BenchmarkRegistry()

    def body(state):
        while state.keep_running():
            state.deliver(torch.ones(4) * 2)
    b = register_benchmark("body", body, registry=reg)
    stack = measure.MeterStack.build(None, b)
    assert [m.name for m in stack.meters] == ["wall", "cpu"]
    st = State(max_iterations=5)
    stack.begin(st)
    b.fn(st)
    metrics = stack.end(st)
    assert metrics[measure.WALL_TIME] > 0 and st.iterations == 5


@pytest.mark.parametrize("spec,ok", [("wall,cpu,latency", True),
                                     ("costmodel", True),
                                     ("wall,bogus", False)])
def test_meter_names(spec, ok):
    if ok:
        assert measure.parse_meters(spec) == spec.split(",")
    else:
        with pytest.raises(ValueError):
            measure.parse_meters(spec)


# -- context ----------------------------------------------------------------

def test_target_hardware_table():
    assert sysinfo.target_hardware(None)["name"] == "h100_sxm"
    assert sysinfo.target_hardware("NVIDIA H100 80GB HBM3")["name"] == \
        "h100_sxm"
    assert sysinfo.target_hardware("NVIDIA H100 PCIe")["peak_bf16_flops"] \
        == 756e12
    ctx = sysinfo.build_context({"scopes": {}}, device="cpu")
    assert ctx["backend"] == "cpu" and ctx["target_hardware"] == "h100_sxm"
    assert set(sysinfo._DIGEST_KEYS) <= set(ctx)
    assert "jax_version" not in ctx


def test_bridge_carries_numpy_and_bfloat16():
    import jax.numpy as jnp
    a = np.arange(6, dtype=np.float32).reshape(2, 3) / 7
    bf = np.asarray(jnp.asarray(a, jnp.bfloat16))
    out = from_numpy({"a": a, "pair": (bf, np.int32(3)), "keep": "s"})
    assert out["a"].dtype == torch.float32 and out["keep"] == "s"
    assert torch.equal(out["a"], torch.from_numpy(a))
    assert out["pair"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(out["pair"][0].float().numpy(),
                                  bf.astype(np.float32))
    assert out["pair"][1].dtype == torch.int32
    out["a"][0, 0] = 100.0                   # a copy, never an alias
    assert a[0, 0] == 0.0


# -- the CLI ----------------------------------------------------------------

@pytest.fixture
def fresh_cli(monkeypatch):
    """The process-global flags, hooks and registry as a new process has
    them (core flags only), restored afterwards."""
    from repro_torch.core.flags import FLAGS
    from repro_torch.core.hooks import HOOKS
    from repro_torch.core.registry import REGISTRY
    saved = (dict(FLAGS._specs), dict(FLAGS._values),
             list(HOOKS._pre_parse), list(HOOKS._post_parse),
             dict(REGISTRY._benchmarks))
    for name in [n for n, spec in FLAGS._specs.items()
                 if spec.owner != "core"]:
        del FLAGS._specs[name]
        FLAGS._values.pop(name, None)
    HOOKS._pre_parse[:] = [h for h in HOOKS._pre_parse if h[0] == "core"]
    HOOKS._post_parse[:] = [h for h in HOOKS._post_parse if h[0] == "core"]
    REGISTRY._benchmarks.clear()
    yield
    FLAGS._specs.clear(), FLAGS._specs.update(saved[0])
    FLAGS._values.clear(), FLAGS._values.update(saved[1])
    HOOKS._pre_parse[:], HOOKS._post_parse[:] = saved[2], saved[3]
    REGISTRY._benchmarks.clear(), REGISTRY._benchmarks.update(saved[4])


@pytest.mark.parametrize("argv", [
    ["run", "--strict"], ["run", "--lint"], ["lint"], ["report", "x"],
])
def test_unported_surface_is_refused(argv, tmp_path, capsys, monkeypatch,
                                     fresh_cli):
    """Nothing of the reference's CLI is refused as unported any more
    (``lint``, ``--lint`` and ``--strict`` since the linter's slice): on
    a host with no card ``run --lint``/``--strict`` and ``lint`` refuse
    to carry on on the CPU, exit 2, as ``run`` does, and run with
    ``--device cpu``; ``report`` on a missing run exits as the
    reference's does."""
    if argv[0] != "report":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert port_main.NOT_YET_PORTED_COMMANDS == () and \
            port_main.NOT_YET_PORTED_FLAGS == ()
        assert port_main.main(argv) == 2
        scope = (["--scope", "example"] if argv[0] == "lint" else
                 ["--enable-scope", "example", "--results-dir", "",
                  "--benchmark_min_time", "0.001", "--benchmark_out",
                  str(tmp_path / "out.json")])
        assert port_main.main([*argv, "--device", "cpu", *scope]) == 0
        return
    # report is ported: on a missing run it exits as the reference's
    # report_main does (2, naming the run directory it looked for)
    from repro.scopeplot.report import report_main as ref_report_main
    args = [*argv, "--results-dir", str(tmp_path)]
    assert port_main.main(args) == 2
    port_err = capsys.readouterr().err
    assert ref_report_main(args[1:]) == 2
    assert port_err == capsys.readouterr().err
    assert f"no run directory {tmp_path / 'x'}" in port_err


def test_example_scope_document_pairs_with_reference(tmp_path):
    args = ("--enable-scope", "example", "--benchmark_min_time", "0.01")
    rc, port, err = run_cli("repro_torch", "--device", "cpu", *args,
                            out=tmp_path / "port.json")
    assert rc == 0, err
    rc, ref, err = run_cli("repro", *args, out=tmp_path / "ref.json")
    assert rc == 0, err
    port_keys = {r["name"]: sorted(r) for r in port["benchmarks"]}
    ref_keys = {r["name"]: sorted(r) for r in ref["benchmarks"]}
    assert port_keys == ref_keys
    assert port["context"]["backend"] == "cpu"
    assert port["context"]["scopes"]["example"] == "enabled"
    # the reference's loader and comparison read the port's document and
    # pair every instance by name
    loaded = ref_baseline.load_document(str(tmp_path / "port.json"))
    comps = ref_baseline.compare_documents(
        ref_baseline.load_document(str(tmp_path / "ref.json")), loaded)
    assert sorted(c.name for c in comps) == sorted(ref_keys)
    assert not [c for c in comps
                if c.verdict in (ref_baseline.ADDED, ref_baseline.REMOVED)]
    # and so does its CLI (exit 1 only flags timing regressions)
    r = subprocess.run([sys.executable, "-m", "repro", "compare",
                        str(tmp_path / "ref.json"), str(tmp_path / "port.json")],
                       capture_output=True, text=True, env=_env(), cwd=ROOT,
                       timeout=300)
    assert r.returncode in (0, 1), r.stderr
    assert all(name in r.stdout for name in ref_keys)
    assert "added" not in r.stdout and "removed" not in r.stdout
