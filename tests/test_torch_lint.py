"""repro_torch.core.lint: the reference's ``tests/test_lint.py`` through
the port, with bodies and fixtures written in torch — every built-in
rule has a triggering family and a clean family, the CLI gates exit
codes (2 without a card unless ``--device cpu``), the whole pass
provably never executes a benchmark body, and one buggy scope built in
each package gives the same JSON report.  The trace tier's facts (the
aten graph's compute, placeholders, the kernels' nodes, FLOPs) are held
on small workloads, and the port's ten scopes lint clean on the CPU with
the trace tier on."""
import json
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.core.lint import run_lint as ref_run_lint
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.registry import register_benchmark as ref_register
from repro_torch.core import FLAGS, ParamSpace, Scope, State
from repro_torch.core.flags import FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.lint import (RULES, FamilyAnalysis, FamilyRule,
                                   LintReport, Rule, compile_workload,
                                   lint_main, parse_rules, register_rule,
                                   run_lint)
from repro_torch.core.registry import BenchmarkRegistry, register_benchmark
from repro_torch.core.scope import BUILTIN_SCOPES, ScopeManager

#: Every rule id of the reference's catalog.
REFERENCE_RULES = ["SCOPE000"] + [f"SCOPE{i}" for i in range(101, 111)] \
    + ["SCOPE201", "SCOPE202", "SCOPE203", "SCOPE301", "SCOPE302",
       "SCOPE303"]


def reg():
    return BenchmarkRegistry()


def rules_of(report, family=None):
    return sorted({f.rule for f in report.findings
                   if family is None or f.family == family})


def lint(registry, **kwargs):
    kwargs.setdefault("compile_checks", False)
    return run_lint(registry.all(), **kwargs)


@pytest.fixture
def no_body_runs(monkeypatch):
    """Poison the timed loop: any benchmark body that starts iterating
    blows up the test — the linter must never get there."""
    def boom(self):
        raise AssertionError("lint executed a benchmark body")
    monkeypatch.setattr(State, "keep_running", boom)


@pytest.fixture
def on_cpu(monkeypatch):
    """Fixtures of the port's scopes place their tensors on ``--device``."""
    monkeypatch.setitem(FLAGS._values, "device", "cpu")


def test_rule_catalog_is_the_reference_s():
    from repro.core.lint import RULES as REF_RULES
    assert sorted(RULES) == REFERENCE_RULES == sorted(REF_RULES)
    for rule_id in RULES:
        ours, ref = RULES[rule_id](), REF_RULES[rule_id]()
        assert (ours.severity, ours.requires_compile) == \
            (ref.severity, ref.requires_compile), rule_id


# ---------------------------------------------------------------------------
# SCOPE000 — unanalyzable body
# ---------------------------------------------------------------------------

def test_scope000_triggers_on_sourceless_body(no_body_runs):
    r = reg()
    ns = {}
    exec("def body(state):\n"
         "    while state.keep_running():\n"
         "        pass\n", ns)
    register_benchmark("nosource", ns["body"], scope="s", registry=r)
    assert "SCOPE000" in rules_of(lint(r))


def test_scope000_clean_on_plain_function(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            state.deliver(1)
        state.set_items_processed(1)
    register_benchmark("plain", body, scope="s", registry=r)
    assert lint(r).findings == []


# ---------------------------------------------------------------------------
# SCOPE101 — unfenced asynchronous body
# ---------------------------------------------------------------------------

def _quietly(b):
    """Silence the rules a minimal body would otherwise trip."""
    b.set_sync(lambda ctx: None)
    return b


def test_scope101_triggers_without_deliver_or_sync(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            pass
        state.set_items_processed(1)
    register_benchmark("unfenced", body, scope="s", registry=r)
    assert rules_of(lint(r)) == ["SCOPE101"]


def test_scope101_clean_when_delivering(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            state.deliver(41 + 1)
        state.set_items_processed(1)
    register_benchmark("delivers", body, scope="s", registry=r)
    assert lint(r).findings == []


def test_scope101_clean_with_sync_fence_or_manual_time(no_body_runs):
    r = reg()

    def fenced(state):
        while state.keep_running():
            pass
        state.set_items_processed(1)
    _quietly(register_benchmark("fenced", fenced, scope="s", registry=r))

    def manual(state):
        while state.keep_running():
            state.set_iteration_time(1e-3)
        state.set_items_processed(1)
    register_benchmark("manual", manual, scope="s",
                       registry=r).manual_time()
    assert lint(r).findings == []


# ---------------------------------------------------------------------------
# SCOPE102 — allocation/compilation inside the timed loop
# ---------------------------------------------------------------------------

def test_scope102_triggers_on_alloc_in_timed_loop(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            x = torch.ones(16)
            state.deliver(torch.compile(lambda v: v * 2)(x))
        state.set_items_processed(16)
    register_benchmark("hot_alloc", body, scope="s", registry=r)
    found = [f for f in lint(r).findings if f.rule == "SCOPE102"]
    assert len(found) == 2          # torch.ones and torch.compile
    assert all(f.severity == "error" for f in found)


@pytest.mark.parametrize("call", [
    "torch.randn(4)", "torch.rand(4)", "torch.randint(0, 4, (4,))",
    "torch.tensor([1.0])", "torch.as_tensor([1.0])",
    "torch.from_numpy(x)", "torch.zeros_like(x)",
    "torch.func.grad(f)", "torch.func.vmap(f)", "torch.manual_seed(0)",
    "torch.Generator()", "np.asarray(x)"])
def test_scope102_bans_the_torch_constructors_and_transforms(
        no_body_runs, call):
    r = reg()
    ns = {}
    src = ("def body(state):\n"
           "    x = f = None\n"
           "    while state.keep_running():\n"
           f"        state.deliver({call})\n"
           "    state.set_items_processed(1)\n")
    exec(src, ns)
    b = register_benchmark("banned", ns["body"], scope="s", registry=r)
    b.source = src
    found = [f for f in lint(r).findings if f.rule == "SCOPE102"]
    assert len(found) == 1 and call.split("(")[0] in found[0].message


def test_scope102_clean_when_setup_is_outside_the_loop(no_body_runs):
    r = reg()

    def body(state):
        x = torch.ones(16)              # before the first keep_running():
        fn = torch.compile(lambda v: v * 2)   # untimed by construction
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(16)
    register_benchmark("cold_alloc", body, scope="s", registry=r)
    assert lint(r).findings == []


# ---------------------------------------------------------------------------
# SCOPE103 — dead parameter axes
# ---------------------------------------------------------------------------

def test_scope103_triggers_on_unread_axis(no_body_runs):
    r = reg()

    def body(state):
        n = state.params.n
        while state.keep_running():
            state.deliver(n * 2)
        state.set_items_processed(n)
    b = register_benchmark("deadaxis", body, scope="s", registry=r)
    b.param_space(ParamSpace.product(dtype=["f32", "f64"], n=[4]))
    found = [f for f in lint(r).findings if f.rule == "SCOPE103"]
    assert len(found) == 1 and "'dtype'" in found[0].message


def test_scope103_clean_when_fixture_reads_the_axis(no_body_runs):
    r = reg()

    def setup(params):
        return torch.zeros(params.n, dtype=getattr(torch, params.dtype))

    def body(state):
        x = state.fixture
        while state.keep_running():
            state.deliver(x + 1)
        state.set_items_processed(state.params.n)
    b = register_benchmark("liveaxis", body, scope="s", registry=r)
    b.param_space(ParamSpace.product(dtype=["float32"], n=[4]))
    b.set_fixture(setup)
    assert lint(r).findings == []


def test_scope103_stays_quiet_when_params_escape(no_body_runs):
    r = reg()

    def helper(p):
        return p

    def body(state):
        cfg = helper(state.params)      # analyzer can't see inside
        while state.keep_running():
            state.deliver(cfg)
        state.set_items_processed(1)
    b = register_benchmark("escapes", body, scope="s", registry=r)
    b.param_space(ParamSpace.product(dtype=["f32"], n=[4]))
    assert rules_of(lint(r)) == []


def test_scope103_reads_via_state_range_and_alias(no_body_runs):
    r = reg()

    def legacy(state):
        n = state.range(0)
        while state.keep_running():
            state.deliver(n)
        state.set_items_processed(n)
    b = register_benchmark("legacy_range", legacy, scope="s", registry=r)
    b.args([4]).set_arg_names(["n"])

    def aliased(state):
        p = state.params
        while state.keep_running():
            state.deliver(p.n)
        state.set_items_processed(p.n)
    b2 = register_benchmark("aliased", aliased, scope="s", registry=r)
    b2.param_space(ParamSpace.product(n=[4]))
    assert lint(r).findings == []


# ---------------------------------------------------------------------------
# SCOPE104 — no throughput signal
# ---------------------------------------------------------------------------

def test_scope104_triggers_without_counters(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            state.deliver(1)
    register_benchmark("bare_time", body, scope="s", registry=r)
    assert rules_of(lint(r)) == ["SCOPE104"]


def test_scope104_clean_with_any_signal(no_body_runs):
    r = reg()

    def with_bytes(state):
        while state.keep_running():
            state.deliver(1)
        state.set_bytes_processed(64)
    register_benchmark("with_bytes", with_bytes, scope="s", registry=r)

    def with_counter(state):
        while state.keep_running():
            state.deliver(1)
        state.counters["flops"] = 2.0
    register_benchmark("with_counter", with_counter, scope="s", registry=r)
    assert lint(r).findings == []


# ---------------------------------------------------------------------------
# SCOPE105 — wall-clock reads in the body
# ---------------------------------------------------------------------------

def test_scope105_triggers_on_host_clock(no_body_runs):
    r = reg()

    def body(state):
        import time
        t0 = time.perf_counter()
        while state.keep_running():
            state.deliver(time.perf_counter() - t0)
        state.set_items_processed(1)
    register_benchmark("clocky", body, scope="s", registry=r)
    found = [f for f in lint(r).findings if f.rule == "SCOPE105"]
    assert len(found) == 2 and found[0].severity == "error"


def test_scope105_exempts_manual_time_families(no_body_runs):
    r = reg()

    def body(state):
        import time
        while state.keep_running():
            t0 = time.perf_counter()
            state.deliver(1)
            state.set_iteration_time(time.perf_counter() - t0)
        state.set_items_processed(1)
    register_benchmark("manual_clock", body, scope="s",
                       registry=r).manual_time()
    assert lint(r).findings == []


# ---------------------------------------------------------------------------
# SCOPE106 — manual_time without set_iteration_time
# ---------------------------------------------------------------------------

def test_scope106_triggers_when_time_is_never_reported(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            state.deliver(1)
        state.set_items_processed(1)
    register_benchmark("silent_manual", body, scope="s",
                       registry=r).manual_time()
    assert rules_of(lint(r)) == ["SCOPE106"]


# ---------------------------------------------------------------------------
# SCOPE107 — hardcoded kernel tiles bypass the tuned defaults
# ---------------------------------------------------------------------------

def test_scope107_triggers_on_literal_block_knob(no_body_runs):
    r = reg()

    def setup(params):
        from repro_torch.kernels.matmul import matmul
        x = torch.ones((params.n, params.n))
        return (lambda x: matmul(x, x, bm=128, bk=64)), x

    def body(state):
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(1)
    b = register_benchmark("pinned_blocks", body, scope="s", registry=r)
    b.param_space(n=[256]).set_fixture(setup)
    found = [f for f in lint(r).findings if f.rule == "SCOPE107"]
    assert len(found) == 2 and found[0].severity == "warning"
    assert "bm=128" in found[0].message
    assert "python -m repro_torch tune" in found[0].message


@pytest.mark.parametrize("call,knob", [
    ("flash_attention(q, q, q, bq=64)", "bq=64"),
    ("flash_attention(q, q, q, bk=32)", "bk=32"),
    ("rmsnorm(q, q, br=4)", "br=4"),
    ("ssd(q, q, q, q, q, q, chunk=64)", "chunk=64"),
    ("ops.ssd_chunk(q, q, q, q, q, chunk=128)", "chunk=128")])
def test_scope107_names_every_tuned_wrapper(no_body_runs, call, knob):
    r = reg()
    src = ("def body(state):\n"
           "    q = state.fixture\n"
           "    while state.keep_running():\n"
           f"        state.deliver({call})\n"
           "    state.set_items_processed(1)\n")
    ns = {}
    exec(src, ns)
    b = register_benchmark("pinned", ns["body"], scope="s", registry=r)
    b.source = src
    found = [f for f in lint(r).findings if f.rule == "SCOPE107"]
    assert len(found) == 1 and knob in found[0].message


def histogram_like(x, *, chunk):
    return (x, chunk)


def test_scope107_clean_when_blocks_come_from_tuning(no_body_runs):
    r = reg()

    def setup(params):
        from repro_torch.kernels.matmul import matmul
        x = torch.ones((params.n, params.n))
        # no literal knobs: the tuned defaults apply; non-knob kwargs
        # and non-kernel calls with a `chunk=` kwarg stay exempt
        unrelated = histogram_like(x, chunk=4096)
        return (lambda x: matmul(x, x)), x, unrelated

    def body(state):
        fn, x, _ = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(1)
    b = register_benchmark("tuned_blocks", body, scope="s", registry=r)
    b.param_space(n=[256]).set_fixture(setup)
    assert [f for f in lint(r).findings if f.rule == "SCOPE107"] == []


# ---------------------------------------------------------------------------
# SCOPE201 — workload with no compute on its operands
# ---------------------------------------------------------------------------

def _trace_findings(registry):
    return run_lint(registry.all(), compile_checks=True).findings


def _traced_family(r, name, setup):
    def body(state):
        fn, *args = state.fixture
        while state.keep_running():
            state.deliver(fn(*args))
        state.set_items_processed(state.params.n)
    b = register_benchmark(name, body, scope="s", registry=r)
    b.param_space(ParamSpace.product(n=[4]))
    b.set_fixture(setup)
    return b


def test_undelivered_constant_output_flagged_as_dce_hazard(no_body_runs):
    """A callable whose result never depends on its operands computes
    from constants alone; the traced graph's diff must flag it."""
    r = reg()
    _traced_family(r, "folded", lambda params: (
        lambda x: torch.sum(torch.ones(4)), torch.ones(params.n)))
    found = [f for f in _trace_findings(r) if f.rule == "SCOPE201"]
    assert len(found) == 1
    assert found[0].severity == "error"
    assert "aten graph" in found[0].message


@pytest.mark.parametrize("fn", [
    lambda x: x.clone(), lambda x: x.view(2, 2).t().contiguous(),
    lambda x: x.detach().float(), lambda x: x[1:]])
def test_scope201_flags_copies_and_views(no_body_runs, fn):
    r = reg()
    _traced_family(r, "copies", lambda params: (fn, torch.ones(params.n)))
    assert [f.rule for f in _trace_findings(r)] == ["SCOPE201"]


@pytest.mark.parametrize("fn", [
    lambda x: x * 2.0 + 1.0, lambda x: x.to(torch.bfloat16),
    lambda x: x.sum(), lambda x: torch.ones(4) @ x])
def test_scope201_clean_on_real_compute(no_body_runs, fn):
    """Arithmetic, a dtype conversion (XLA's ``convert``), a reduction
    and a product with a constant all compute on the operand."""
    r = reg()
    _traced_family(r, "computes", lambda params: (fn, torch.ones(params.n)))
    assert _trace_findings(r) == []


# ---------------------------------------------------------------------------
# SCOPE202 — dead operands
# ---------------------------------------------------------------------------

def test_scope202_triggers_on_unconsumed_operand(no_body_runs):
    r = reg()
    _traced_family(r, "deadop", lambda params: (
        lambda x, y: x * 2.0, torch.ones(params.n), torch.ones(params.n)))
    found = [f for f in _trace_findings(r) if f.rule == "SCOPE202"]
    assert len(found) == 1 and "2 operand leaves" in found[0].message
    assert found[0].severity == "warning"


# ---------------------------------------------------------------------------
# SCOPE203 — opaque fixture convention, untraceable workloads
# ---------------------------------------------------------------------------

def test_scope203_triggers_on_nonconforming_fixture(no_body_runs):
    r = reg()

    def setup(params):
        return torch.ones(params.n), torch.ones(params.n)

    def body(state):
        x, y = state.fixture
        while state.keep_running():
            state.deliver(x + y)
        state.set_items_processed(state.params.n)
    b = register_benchmark("opaque", body, scope="s", registry=r)
    b.param_space(ParamSpace.product(n=[4]))
    b.set_fixture(setup)
    found = [f for f in _trace_findings(r) if f.rule == "SCOPE203"]
    assert len(found) == 1 and found[0].severity == "info"


def test_scope203_reports_a_workload_that_will_not_trace(no_body_runs):
    """Data-dependent control flow cannot be traced on fake tensors: the
    failure is recorded, as the reference records a failure to lower."""
    r = reg()

    def branchy(x):
        return x * 2 if x.sum().item() > 0 else x
    _traced_family(r, "branchy", lambda params: (branchy,
                                                 torch.ones(params.n)))
    (found,) = _trace_findings(r)
    assert found.rule == "SCOPE203" and found.severity == "info"
    assert "could not be traced" in found.message and found.fix_hint == ""


def test_trace_rules_skipped_without_compile_checks(no_body_runs):
    r = reg()
    report = lint(r)
    assert "SCOPE201" not in report.rules_run
    assert "SCOPE101" in report.rules_run


# ---------------------------------------------------------------------------
# the trace tier's facts
# ---------------------------------------------------------------------------

def test_trace_reads_the_aten_graph_without_running_anything(no_body_runs):
    """A kernel wrapper on CPU tensors traces through its custom op (no
    launch, nothing computed): the graph holds the ``repro_torch`` node,
    the FLOPs come from its registered formula, a tensor the callable
    closes over becomes a constant, not a placeholder."""
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.rmsnorm import rmsnorm
    r = reg()
    scale = torch.ones(8)
    _traced_family(r, "kernels", lambda params: (
        lambda x, y: rmsnorm(matmul(x, y), scale),
        torch.ones(16, 32), torch.ones(32, 8)))
    (bench,) = r.all()
    out = compile_workload(bench)
    assert out.analyzed() and out.convention
    assert out.kernel_ops == ["repro_torch.matmul", "repro_torch.rmsnorm"]
    assert out.entry_params == out.operand_leaves == 2
    assert out.compute_ops == 2
    assert out.flops == 2 * 16 * 32 * 8
    assert "torch.ops.repro_torch.matmul" in out.graph_text


def test_trace_takes_a_wrapper_with_keyword_only_knobs(no_body_runs):
    """A fixture may hand over the kernel wrapper itself, whose tile
    knobs are keyword-only parameters (linalg's ``matmul_rect``)."""
    from repro_torch.kernels.matmul import matmul
    r = reg()
    _traced_family(r, "wrapper", lambda params: (
        matmul, torch.ones(8, 16), torch.ones(16, 4)))
    (bench,) = r.all()
    out = compile_workload(bench)
    assert out.analyzed(), out.error
    assert out.kernel_ops == ["repro_torch.matmul"]
    assert out.entry_params == out.operand_leaves == 2


def test_trace_counts_only_tensor_leaves_of_the_operands(no_body_runs):
    r = reg()
    _traced_family(r, "nested", lambda params: (
        lambda d, k: d["a"] * k + d["b"][0],
        {"a": torch.ones(4), "b": [torch.ones(4), torch.ones(4)]}, 3))
    (bench,) = r.all()
    out = compile_workload(bench)
    assert out.operand_leaves == 3 and out.entry_params == 2
    assert [f.rule for f in run_lint(r.all()).findings] == ["SCOPE202"]


def test_trace_tears_down_the_fixture_s_process_group(no_body_runs,
                                                      on_cpu):
    """comm's fixture opens a one-rank gloo group; the pass closes it."""
    assert not dist.is_initialized()
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(["repro_torch.scopes.comm_scope"])
    mgr.register_all()
    bench = mgr.registry.get("comm/all_reduce_measured")
    out = compile_workload(bench)
    assert out.analyzed() and out.compute_ops >= 1
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# SCOPE301 — duplicate points after dead-axis projection
# ---------------------------------------------------------------------------

def test_scope301_triggers_on_projected_duplicates(no_body_runs):
    r = reg()

    def body(state):
        n = state.params.n
        while state.keep_running():
            state.deliver(n)
        state.set_items_processed(n)
    b = register_benchmark("dupes", body, scope="s", registry=r)
    b.param_space(ParamSpace.product(trial=[1, 2], n=[4]))
    found = [f for f in lint(r).findings if f.rule == "SCOPE301"]
    assert len(found) == 1
    assert "s/dupes/trial:1/n:4" in found[0].message
    assert "s/dupes/trial:2/n:4" in found[0].message


# ---------------------------------------------------------------------------
# SCOPE302 — instance-name collisions across families
# ---------------------------------------------------------------------------

def test_scope302_triggers_on_instance_name_collision(no_body_runs):
    r = reg()

    def swept(state):
        n = state.range(0)
        while state.keep_running():
            state.deliver(n)
        state.set_items_processed(n)
    b = register_benchmark("x", swept, scope="s", registry=r)
    b.args([4]).set_arg_names(["n"])

    def fixed(state):
        while state.keep_running():
            state.deliver(4)
        state.set_items_processed(4)
    register_benchmark("x/n:4", fixed, scope="s", registry=r)
    found = [f for f in lint(r).findings if f.rule == "SCOPE302"]
    assert len(found) == 1 and "'s/x/n:4'" in found[0].message
    assert found[0].severity == "error"


# ---------------------------------------------------------------------------
# SCOPE303 — empty sweeps and empty scopes
# ---------------------------------------------------------------------------

def test_scope303_triggers_on_zero_instances_and_empty_scope(no_body_runs):
    r = reg()

    def body(state):
        n = state.params.n
        while state.keep_running():
            state.deliver(n)
        state.set_items_processed(n)
    b = register_benchmark("empty", body, scope="s", registry=r)
    b.param_space(ParamSpace.product(n=[]))
    report = run_lint(r.all(), scope_names=["s", "ghost"],
                      compile_checks=False)
    found = [f for f in report.findings if f.rule == "SCOPE303"]
    assert {f.target() for f in found} == {"s/empty", "ghost"}


# ---------------------------------------------------------------------------
# framework: registration, selection, reporting, isolation
# ---------------------------------------------------------------------------

def test_register_rule_validates_and_rejects_duplicates():
    with pytest.raises(ValueError, match="no id"):
        register_rule(type("R", (Rule,), {}))
    with pytest.raises(ValueError, match="severity"):
        register_rule(type("R", (Rule,), {"id": "X1", "severity": "fatal"}))
    with pytest.raises(ValueError, match="already registered"):
        register_rule(type("R", (Rule,), {"id": "SCOPE101",
                                          "severity": "error"}))


def test_parse_rules_validates_ids():
    assert parse_rules("SCOPE101, SCOPE201,SCOPE101") == \
        ["SCOPE101", "SCOPE201"]
    with pytest.raises(ValueError, match="unknown rule"):
        parse_rules("SCOPE101,NOPE")
    with pytest.raises(ValueError, match="at least one"):
        parse_rules(" , ")


def test_custom_rule_registration_and_selection(no_body_runs):
    @register_rule
    class TooManyInstances(FamilyRule):
        id = "TST901"
        severity = "warning"
        title = "family sweeps more than 2 instances"
        fix_hint = "prune the space"

        def check_family(self, ctx, fam):
            if len(fam.bench.instances()) > 2:
                yield self.finding(fam)
    try:
        r = reg()

        def body(state):
            n = state.params.n
            while state.keep_running():
                state.deliver(n)
            state.set_items_processed(n)
        b = register_benchmark("wide", body, scope="s", registry=r)
        b.param_space(ParamSpace.product(n=[1, 2, 4]))
        report = run_lint(r.all(), rules=["TST901"], compile_checks=False)
        assert report.rules_run == ["TST901"]
        assert rules_of(report) == ["TST901"]
        assert report.findings[0].fix_hint == "prune the space"
    finally:
        RULES.pop("TST901")


def test_crashing_rule_does_not_kill_the_pass(no_body_runs):
    @register_rule
    class Broken(FamilyRule):
        id = "TST902"
        severity = "error"
        title = "always crashes"

        def check_family(self, ctx, fam):
            raise RuntimeError("boom")
    try:
        r = reg()

        def body(state):
            while state.keep_running():
                pass
        register_benchmark("buggy", body, scope="s", registry=r)
        report = run_lint(r.all(), compile_checks=False)
        assert "TST902" in report.rules_run
        assert "SCOPE101" in rules_of(report)   # others still reported
    finally:
        RULES.pop("TST902")


def test_report_gate_counts_and_json():
    report = LintReport(findings=[], families_checked=3, scopes_checked=1,
                        rules_run=["SCOPE101"])
    assert not report.failed() and not report.failed(strict=True)
    from repro_torch.core.lint import Finding
    warn = Finding(rule="W", severity="warning", scope="s", family="s/f",
                   message="m")
    err = Finding(rule="E", severity="error", scope="s", family="s/f",
                  message="m", fix_hint="h", location="f.py:3")
    report.findings.append(warn)
    assert not report.failed() and report.failed(strict=True)
    report.findings.append(err)
    assert report.failed()
    doc = report.to_json()
    assert doc["version"] == 1 and doc["counts"] == \
        {"error": 1, "warning": 1, "info": 0}
    assert doc["findings"][1]["location"] == "f.py:3"
    text = report.format_text()
    assert text.index("E error") < text.index("W warning")
    assert "fix: h" in text


def test_findings_carry_registration_location(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            pass
    register_benchmark("located", body, scope="s", registry=r)
    f = [f for f in lint(r).findings if f.rule == "SCOPE101"][0]
    assert f.location.startswith(__file__.replace(".pyc", ".py"))


# ---------------------------------------------------------------------------
# parity: one buggy scope in each package, the same report
# ---------------------------------------------------------------------------

def _unfenced(state):
    while state.keep_running():
        pass
    state.set_items_processed(1)


def _hot_alloc(state):
    while state.keep_running():
        state.deliver(np.ones(16))
    state.set_items_processed(16)


def _dead_axis(state):
    n = state.params.n
    while state.keep_running():
        state.deliver(n * 2)
    state.set_items_processed(n)


def _clocky(state):
    t0 = time.perf_counter()
    while state.keep_running():
        state.deliver(time.perf_counter() - t0)
    state.set_items_processed(1)


def _runs_fixture(state):
    fn, *args = state.fixture
    while state.keep_running():
        state.deliver(fn(*args))
    state.set_items_processed(state.params.n)


#: The trace tier's wording speaks of the aten graph in the port and of
#: optimized HLO in the reference: those findings agree on everything
#: but their message and fix hint.
_TRACE_WORDING = {"SCOPE201", "SCOPE202", "SCOPE203"}


def _buggy_scope(register, space_of, folded, deadop):
    """Families that trip SCOPE101, 102, 103, 105, 201, 202 and 301, one
    rule each, registered through one package's ``register``."""
    register("unfenced", _unfenced)
    register("hot_alloc", _hot_alloc)
    register("dead_axis", _dead_axis).param_space(
        space_of(dtype=["f32", "f64"], n=[4]))
    register("clocky", _clocky)
    register("folded", _runs_fixture).param_space(
        space_of(n=[4])).set_fixture(folded)
    register("deadop", _runs_fixture).param_space(
        space_of(n=[4])).set_fixture(deadop)
    register("dupes", _dead_axis).param_space(
        space_of(trial=[1, 2], n=[4]))


def test_buggy_scope_reports_as_the_reference(no_body_runs):
    from repro.core import ParamSpace as RefParamSpace
    ours, ref = reg(), RefRegistry()
    _buggy_scope(
        lambda name, fn: register_benchmark(name, fn, scope="bug",
                                            registry=ours),
        ParamSpace.product,
        lambda params: (lambda x: torch.sum(torch.ones(4)),
                        torch.ones(params.n)),
        lambda params: (lambda x, y: x * 2.0, torch.ones(params.n),
                        torch.ones(params.n)))
    _buggy_scope(
        lambda name, fn: ref_register(name, fn, scope="bug", registry=ref),
        RefParamSpace.product,
        lambda params: (jax.jit(lambda x: jnp.sum(jnp.ones(4))),
                        jnp.ones(params.n)),
        lambda params: (jax.jit(lambda x, y: x * 2.0),
                        jnp.ones(params.n), jnp.ones(params.n)))
    got = run_lint(ours.all(), scope_names=["bug"]).to_json()
    want = ref_run_lint(ref.all(), scope_names=["bug"]).to_json()

    def comparable(doc):
        rows = []
        for f in doc["findings"]:
            f = dict(f)
            f.pop("location")
            if f["rule"] in _TRACE_WORDING:
                f.pop("message"), f.pop("fix_hint")
            rows.append(f)
        return dict(doc, findings=sorted(
            rows, key=lambda f: (f["family"], f["rule"],
                                 f.get("message", ""))))
    assert comparable(got) == comparable(want)
    assert {f["rule"] for f in got["findings"]} == {
        "SCOPE101", "SCOPE102", "SCOPE103", "SCOPE105", "SCOPE201",
        "SCOPE202", "SCOPE301"}
    assert got["counts"] == want["counts"]


# ---------------------------------------------------------------------------
# the ten builtin scopes lint clean — without executing anything
# ---------------------------------------------------------------------------

def _builtin_manager(modules=None):
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(modules or BUILTIN_SCOPES)
    mgr.register_all()
    return mgr


def test_builtin_scopes_lint_clean(no_body_runs, on_cpu):
    """All three tiers over the port's ten scopes on the CPU: fixtures
    are built and traced, bodies never run.  The only findings allowed
    are the SCOPE203 infos of the two families whose fixtures do not
    follow the ``(callable, *operands)`` convention, as in the
    reference."""
    mgr = _builtin_manager()
    benches = mgr.registry.all()
    assert len(benches) >= 20
    report = run_lint(benches, scope_names=sorted(mgr.status()),
                      compile_checks=True)
    assert report.scopes_checked == 10
    assert "SCOPE201" in report.rules_run
    assert not report.failed(strict=True), report.format_text()
    assert {(f.rule, f.family) for f in report.findings} == {
        ("SCOPE203", "example/axpy"), ("SCOPE203", "serve/under_load")}
    assert all(f.message == RULES["SCOPE203"]().title
               for f in report.findings)
    assert not dist.is_initialized()


def test_linalg_scope_compile_tier_clean(no_body_runs, on_cpu):
    """Full pass (AST + trace + registry) over one torch scope: fixtures
    are built and traced, bodies still never run."""
    mgr = _builtin_manager(["repro_torch.scopes.linalg_scope"])
    report = run_lint(mgr.registry.all(), compile_checks=True)
    assert "SCOPE201" in report.rules_run
    assert not report.failed(strict=True), report.format_text()
    assert report.counts()["info"] == 0


# ---------------------------------------------------------------------------
# CLI end-to-end
# ---------------------------------------------------------------------------

@pytest.fixture
def global_state():
    """Snapshot/restore the process-global FLAGS/HOOKS/REGISTRY that
    lint_main drives, so CLI tests don't leak into other tests."""
    from repro_torch.core.hooks import HOOKS
    from repro_torch.core.registry import REGISTRY
    specs, values = dict(FLAGS._specs), dict(FLAGS._values)
    pre, post = list(HOOKS._pre_parse), list(HOOKS._post_parse)
    benches = dict(REGISTRY._benchmarks)
    yield
    FLAGS._specs.clear(), FLAGS._specs.update(specs)
    FLAGS._values.clear(), FLAGS._values.update(values)
    HOOKS._pre_parse[:], HOOKS._post_parse[:] = pre, post
    REGISTRY._benchmarks.clear(), REGISTRY._benchmarks.update(benches)


def _fake_scope_module(name, register):
    modname = f"fake_torch_lint_scopes.{name}"
    mod = types.ModuleType(modname)
    mod.SCOPE = Scope(name=name, register=register)
    sys.modules[modname] = mod
    return modname


def cli(args, modules, entry=None):
    """One lint_main/main call against a pristine global registry (the
    process-global REGISTRY would otherwise accumulate registrations
    across calls and collide)."""
    from repro_torch.core.registry import REGISTRY
    saved = dict(REGISTRY._benchmarks)
    REGISTRY._benchmarks.clear()
    try:
        return (entry or lint_main)(args, modules)
    finally:
        REGISTRY._benchmarks.clear()
        REGISTRY._benchmarks.update(saved)


CPU = ["--device", "cpu"]


@pytest.fixture
def buggy_scope(global_state):
    def _register(registry):
        def unfenced(state):
            while state.keep_running():
                pass
            state.set_items_processed(1)
        register_benchmark("unfenced", unfenced, scope="buggy",
                           registry=registry)
    name = _fake_scope_module("buggy", _register)
    yield name
    sys.modules.pop(name)


@pytest.fixture
def warn_scope(global_state):
    def _register(registry):
        def bare(state):
            while state.keep_running():
                state.deliver(1)
        _quietly(register_benchmark("bare", bare, scope="warny",
                                    registry=registry))
    name = _fake_scope_module("warny", _register)
    yield name
    sys.modules.pop(name)


@pytest.fixture
def clean_scope(global_state):
    def _register(registry):
        def good(state):
            while state.keep_running():
                state.deliver(1)
            state.set_items_processed(1)
        _quietly(register_benchmark("good", good, scope="cleany",
                                    registry=registry))
    name = _fake_scope_module("cleany", _register)
    yield name
    sys.modules.pop(name)


@pytest.fixture
def folded_scope(global_state):
    """A family the trace tier refuses (SCOPE201): its callable computes
    from a constant, whatever its operand."""
    def _register(registry):
        def folded(state):
            fn, x = state.fixture
            while state.keep_running():
                state.deliver(fn(x))
            state.set_items_processed(state.params.n)
        b = register_benchmark("folded", folded, scope="foldy",
                               registry=registry)
        b.param_space(n=[4])
        b.set_fixture(lambda params: (lambda x: torch.ones(4).sum(),
                                      torch.ones(params.n)))
    name = _fake_scope_module("foldy", _register)
    yield name
    sys.modules.pop(name)


def test_cli_exit_codes(no_body_runs, capsys, buggy_scope, warn_scope,
                        clean_scope):
    # errors gate with and without --strict
    assert cli(["--no-compile", *CPU], [buggy_scope]) == 1
    out = capsys.readouterr().out
    assert "SCOPE101" in out and "1 error(s)" in out
    # warnings gate only under --strict
    assert cli(["--no-compile", *CPU], [warn_scope]) == 0
    capsys.readouterr()
    assert cli(["--no-compile", "--strict", *CPU], [warn_scope]) == 1
    assert "SCOPE104" in capsys.readouterr().out
    # a clean scope passes even strict
    assert cli(["--no-compile", "--strict", *CPU], [clean_scope]) == 0


def test_cli_needs_a_card_unless_told_cpu(no_body_runs, capsys,
                                          clean_scope, monkeypatch):
    """As ``run`` does: ``--device`` defaults to cuda, and with no card
    the command exits 2 rather than build fixtures on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli(["--strict"], [clean_scope]) == 2
    assert cli(["--strict", *CPU], [clean_scope]) == 0


def test_cli_scope_and_family_selection(no_body_runs, capsys, buggy_scope,
                                        clean_scope):
    # --scope narrows to the clean scope: the buggy one never gates
    assert cli(["--no-compile", "--scope", "cleany", *CPU],
               [buggy_scope, clean_scope]) == 0
    capsys.readouterr()
    # --family regex selecting nothing is a usage error
    assert cli(["--no-compile", "--family", "nope$", *CPU],
               [clean_scope]) == 2
    # --family narrows within a scope (and doesn't make the unselected
    # buggy scope look empty to SCOPE303)
    assert cli(["--no-compile", "--strict", "--family", "cleany/good",
                *CPU], [buggy_scope, clean_scope]) == 0


def test_cli_json_contract(no_body_runs, capsys, buggy_scope):
    assert cli(["--no-compile", "--format", "json", *CPU],
               [buggy_scope]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert set(doc) == {"version", "families_checked", "scopes_checked",
                        "rules_run", "counts", "findings", "failed"}
    assert doc["version"] == 1 and doc["failed"] is True
    assert doc["counts"]["error"] == 1
    (finding,) = doc["findings"]
    assert set(finding) == {"rule", "severity", "scope", "family",
                            "message", "fix_hint", "location"}
    assert finding["rule"] == "SCOPE101"
    assert finding["family"] == "buggy/unfenced"
    assert finding["fix_hint"]


def test_cli_trace_tier_refuses_a_folded_workload(no_body_runs, capsys,
                                                  folded_scope):
    assert cli(["--format", "json", *CPU], [folded_scope]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert [f["rule"] for f in doc["findings"]] == ["SCOPE201"]
    assert cli(["--no-compile", *CPU], [folded_scope]) == 0


def test_cli_rules_subset_and_list(no_body_runs, capsys, buggy_scope):
    assert cli(["--no-compile", "--rules", "SCOPE104", *CPU],
               [buggy_scope]) == 0          # 101 not selected
    capsys.readouterr()
    assert cli(["--rules", "BOGUS", *CPU], [buggy_scope]) == 2
    assert cli(["--list-rules"], [buggy_scope]) == 0
    out = capsys.readouterr().out
    for rule_id in RULES:
        assert rule_id in out
    assert "(trace tier)" in out


def test_main_dispatches_lint_and_help(no_body_runs, capsys, clean_scope):
    from repro_torch.core.main import (NOT_YET_PORTED_COMMANDS,
                                       NOT_YET_PORTED_FLAGS, main)
    assert NOT_YET_PORTED_COMMANDS == () and NOT_YET_PORTED_FLAGS == ()
    assert cli(["lint", "--no-compile", *CPU], [clean_scope],
               entry=main) == 0
    capsys.readouterr()
    assert cli(["lint", "--help"], [clean_scope], entry=main) == 0
    out = capsys.readouterr().out
    assert "--strict" in out and "python -m repro_torch lint" in out
    assert cli(["--help"], [clean_scope], entry=main) == 0
    out = capsys.readouterr().out
    assert "  lint      static-analyze" in out
    assert "gate against windowed drift, report" in out


def test_run_lint_preflight_aborts_before_running(no_body_runs, capsys,
                                                  buggy_scope, tmp_path):
    from repro_torch.core.main import main
    results = tmp_path / "results"
    assert cli(["run", "--lint", "--results-dir", str(results), *CPU],
               [buggy_scope], entry=main) == 1
    captured = capsys.readouterr()
    assert "SCOPE101" in captured.err and captured.out == ""
    assert not results.exists()


def test_run_lint_preflight_refuses_a_folded_workload(no_body_runs, capsys,
                                                      folded_scope):
    from repro_torch.core.main import main
    assert cli(["run", "--lint", "--results-dir", "", *CPU],
               [folded_scope], entry=main) == 1
    assert "SCOPE201" in capsys.readouterr().err


def test_run_lint_strict_gates_warnings_then_runs_clean(capsys, warn_scope,
                                                        clean_scope):
    from repro_torch.core.main import main
    common = ["--results-dir", "", "--benchmark_min_time", "0.001", *CPU]
    assert cli(["run", "--lint", *common], [warn_scope], entry=main) == 0
    capsys.readouterr()
    assert cli(["run", "--lint", "--strict", *common], [warn_scope],
               entry=main) == 1
    assert "SCOPE104" in capsys.readouterr().err
    assert cli(["run", "--lint", "--strict", *common], [clean_scope],
               entry=main) == 0
    doc = json.loads(capsys.readouterr().out)
    assert [b["name"] for b in doc["benchmarks"]] == ["cleany/good"]


def test_analysis_handles_for_loop_and_nested_loops(no_body_runs):
    r = reg()

    def body(state):
        for _ in state:
            state.deliver(np.ones(4))
        state.set_items_processed(4)
    register_benchmark("forloop", body, scope="s", registry=r)
    found = [f for f in lint(r).findings if f.rule == "SCOPE102"]
    assert len(found) == 1           # np.ones inside `for _ in state`

    b = r.get("s/forloop")
    ana = FamilyAnalysis(b)
    assert len(ana.timed_loops) == 1


# ---------------------------------------------------------------------------
# SCOPE108 — meters reading host clocks
# ---------------------------------------------------------------------------

def _clean_family(r):
    def body(state):
        while state.keep_running():
            state.deliver(1)
        state.set_items_processed(1)
    register_benchmark("f", body, scope="s", registry=r)


def test_scope108_triggers_on_clock_reading_meter(no_body_runs, monkeypatch):
    from repro_torch.core.measure import METERS, Meter

    class StampsItself(Meter):
        name = "stampsitself"

        def begin(self, state):
            self._t0 = time.perf_counter()

        def end(self, state):
            return {"elapsed": time.perf_counter() - self._t0}

    monkeypatch.setitem(METERS, "stampsitself", StampsItself)
    r = reg()
    _clean_family(r)
    found = [f for f in lint(r).findings if f.rule == "SCOPE108"]
    assert found
    assert all(f.family == "meter:stampsitself" for f in found)
    assert all(f.severity == "error" for f in found)
    assert {m for f in found for m in ("begin", "end")
            if f"StampsItself.{m}" in f.message} == {"begin", "end"}


def test_scope108_flags_the_observe_channel(no_body_runs, monkeypatch):
    """observe() is the per-sample path — a self-read clock there stamps
    enqueue time per request, the exact bug class fence_timestamps
    exists for."""
    from repro_torch.core.measure import METERS, Meter

    class ObserveStamper(Meter):
        name = "observestamper"

        def observe(self, state, sample):
            sample = dict(sample)
            sample["seen_at"] = time.time()

    monkeypatch.setitem(METERS, "observestamper", ObserveStamper)
    r = reg()
    _clean_family(r)
    found = [f for f in lint(r).findings if f.rule == "SCOPE108"]
    assert len(found) == 1
    assert "ObserveStamper.observe" in found[0].message
    assert "time.time" in found[0].message


def test_scope108_builtin_meters_are_clean(no_body_runs):
    r = reg()
    _clean_family(r)
    assert "SCOPE108" not in rules_of(lint(r))


# ---------------------------------------------------------------------------
# SCOPE109 — direct open() of history.jsonl outside the store layer
# ---------------------------------------------------------------------------

def test_scope109_triggers_on_direct_history_open(no_body_runs, tmp_path,
                                                  monkeypatch):
    import repro_torch
    pkg = tmp_path / "fakepkg"
    (pkg / "store").mkdir(parents=True)
    (pkg / "core").mkdir()
    (pkg / "__init__.py").write_text("")
    # violation: a random module hand-opens the history file
    (pkg / "rogue.py").write_text(
        'import os\n'
        'def peek(d):\n'
        '    with open(os.path.join(d, "history.jsonl")) as f:\n'
        '        return f.read()\n')
    # sanctioned: the store layer and core/history.py may open it
    (pkg / "store" / "index.py").write_text(
        'def ok():\n    return open("results/history.jsonl")\n')
    (pkg / "core" / "history.py").write_text(
        'def ok():\n    return open("results/history.jsonl")\n')
    # opening some *other* file is nobody's business
    (pkg / "fine.py").write_text(
        'def ok():\n    return open("notes.txt")\n')
    monkeypatch.setattr(repro_torch, "__file__", str(pkg / "__init__.py"))
    r = reg()
    _clean_family(r)
    found = [f for f in lint(r, rules=["SCOPE109"]).findings
             if f.rule == "SCOPE109"]
    assert len(found) == 1
    assert found[0].severity == "warning"
    assert found[0].family == "module:repro_torch/rogue.py"
    assert "history.jsonl" in found[0].message
    assert str(pkg / "rogue.py") in found[0].location


def test_scope109_real_tree_is_clean(no_body_runs):
    """The shipped package must satisfy its own rule: only
    repro_torch.core.history / repro_torch.store touch the JSONL
    directly."""
    r = reg()
    _clean_family(r)
    report = lint(r, rules=["SCOPE109"])
    assert report.findings == []
    assert report.rules_run == ["SCOPE109"]


# ---------------------------------------------------------------------------
# SCOPE110 — body reads module-level mutable state (fingerprint-invisible)
# ---------------------------------------------------------------------------

_TABLE = {"scale": 2.0}          # the hazard: mutable, module-level
_FACTORS = [1, 2, 4]
_FROZEN = (1, 2, 4)              # immutable → clean


def test_scope110_triggers_on_module_dict_read(no_body_runs):
    r = reg()

    def body(state):
        while state.keep_running():
            state.deliver(_TABLE["scale"])
        state.set_items_processed(1)
    register_benchmark("tabled", body, scope="s", registry=r)
    found = [f for f in lint(r, rules=["SCOPE110"]).findings
             if f.rule == "SCOPE110"]
    assert len(found) == 1
    assert found[0].severity == "warning"
    assert "_TABLE" in found[0].message
    assert "dict" in found[0].message


def test_scope110_triggers_on_global_statement_and_list(no_body_runs):
    r = reg()

    def body(state):
        global _TABLE
        while state.keep_running():
            state.deliver(_FACTORS[0])
        state.set_items_processed(1)
    register_benchmark("globaled", body, scope="s", registry=r)
    msgs = [f.message for f in lint(r, rules=["SCOPE110"]).findings
            if f.rule == "SCOPE110"]
    assert len(msgs) == 2
    assert any("global _TABLE" in m for m in msgs)
    assert any("_FACTORS" in m and "list" in m for m in msgs)


def test_scope110_clean_on_locals_constants_and_modules(no_body_runs):
    r = reg()

    def body(state):
        table = {"scale": 2.0}              # local dict: fine
        acc = torch.zeros(())               # module read: fine
        while state.keep_running():
            state.deliver(acc + table["scale"] * _FROZEN[0])
        state.set_items_processed(1)
    _quietly(register_benchmark("selfcontained", body, scope="s",
                                registry=r))
    assert [f for f in lint(r, rules=["SCOPE110"]).findings
            if f.rule == "SCOPE110"] == []


def test_every_reference_rule_id_is_exercised():
    """Each id of the catalog appears in a test of this file, by name."""
    with open(__file__) as f:
        text = f.read()
    for rule_id in REFERENCE_RULES:
        assert f"def test_{rule_id.lower()}_" in text or \
            f'"{rule_id}"' in text, rule_id
