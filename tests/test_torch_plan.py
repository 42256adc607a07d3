"""The torch port's work-plan layer (``repro_torch.core.plan``): the
reference's ``tests/test_plan.py`` run through the port on the CPU, one
test for each of the reference's, plus parity with the reference (plan
IDs, the reference's readers on the port's run directories) and the
port's ``plan`` CLI and ``--help`` examples."""
import argparse
import json
import os
import shlex
import subprocess
import sys

import pytest

from repro.core.flags import FlagRegistry as RefFlagRegistry
from repro.core.hooks import HookChain as RefHookChain
from repro.core.plan import build_plan as ref_build_plan
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.scope import ScopeManager as RefScopeManager
from repro_torch.core import baseline as bl
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.orchestrate import OrchestratorOptions, execute
from repro_torch.core.plan import (Plan, PlanItem, build_plan, instance_id,
                                   load_cost_hints, scope_worklist)
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.runner import RunOptions, run_benchmarks
from repro_torch.core.scope import Scope, ScopeManager

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = "repro_torch.scopes.example_scope"
FAST = RunOptions(min_time=0.001, device="cpu")


def _env():
    src = os.path.join(ROOT, "src")
    path = os.environ.get("PYTHONPATH")
    return dict(os.environ, PYTHONPATH=f"{src}:{path}" if path else src)


def make_mgr(modules):
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(modules)
    mgr.register_all()
    return mgr


def make_ref_mgr(modules):
    mgr = RefScopeManager(registry=RefRegistry(), flags=RefFlagRegistry(),
                          hooks=RefHookChain())
    mgr.load(modules)
    mgr.register_all()
    return mgr


def item(name, cost=None, scope="s", module="m"):
    return PlanItem(instance_id=instance_id(name), name=name, scope=scope,
                    family=name.rsplit("/", 1)[0] if "/" in name else name,
                    module=module, arg_set=(), cost=cost)


@pytest.fixture
def on_device():
    """Sets FLAGS' device (the port's scopes register on it) and
    restores it."""
    before = FLAGS.get("device")

    def set_device(device):
        FLAGS.set("device", device)
    yield set_device
    FLAGS.set("device", before)


# ---------------------------------------------------------------------------
# enumeration + stable IDs
# ---------------------------------------------------------------------------

def test_build_plan_enumerates_in_document_order():
    mgr = make_mgr([EXAMPLE])
    seq = run_benchmarks(mgr.registry.filter(".*"), FAST, progress=False)
    plan = build_plan(mgr, mgr.registry)
    assert [i.name for i in plan.items] == \
        [r["name"] for r in seq["benchmarks"]]
    assert all(i.scope == "example" for i in plan.items)
    assert all(i.module == EXAMPLE for i in plan.items)
    saxpy = [i for i in plan.items if i.family == "example/saxpy"]
    assert [i.arg_set for i in saxpy] == \
        [(256,), (1024,), (4096,), (16384,), (65536,)]


def test_instance_ids_stable_unique_and_fs_safe():
    mgr = make_mgr([EXAMPLE])
    a = build_plan(mgr, mgr.registry)
    b = build_plan(mgr, mgr.registry)
    ids = [i.instance_id for i in a.items]
    assert ids == [i.instance_id for i in b.items]
    assert len(set(ids)) == len(ids)
    for iid in ids:
        assert "/" not in iid and ":" not in iid
    assert instance_id("a/b:1") != instance_id("a/b_1")
    assert instance_id("x") == instance_id("x")


def test_plan_item_meta_round_trips():
    it = item("s/f/2", cost=1.5)
    assert PlanItem.from_meta(json.loads(json.dumps(it.meta()))) == it


def test_scope_worklist_skips_disabled_and_unavailable():
    mgr = make_mgr([EXAMPLE, "no.such.module"])
    mgr.add_scope(Scope(name="ext"))
    assert scope_worklist(mgr) == [("example", EXAMPLE),
                                   ("ext", "<external>")]
    mgr.configure(disable=["example"])
    assert scope_worklist(mgr) == [("ext", "<external>")]
    assert build_plan(mgr, mgr.registry).items == []


# ---------------------------------------------------------------------------
# cost hints + LPT binning
# ---------------------------------------------------------------------------

def test_lpt_bins_balance_by_cost():
    plan = Plan(items=[item("s/a", 4.0), item("s/b", 3.0),
                       item("s/c", 2.0), item("s/d", 1.0)])
    bins = plan.bins(2)
    loads = [sum(plan.cost_of(i) for i in b) for b in bins]
    assert sorted(loads) == [5.0, 5.0]
    assert [i.name for i in bins[0]] == ["s/a", "s/d"]
    assert [i.name for i in bins[1]] == ["s/b", "s/c"]


def test_bins_preserve_plan_order_and_drop_empty():
    plan = Plan(items=[item(f"s/{k}") for k in "abcde"])
    for b in plan.bins(3):
        names = [i.name for i in b]
        assert names == sorted(names)
    assert plan.bins(10) and all(len(b) == 1 for b in plan.bins(10))
    assert len(plan.bins(10)) == 5
    assert [i.name for b in plan.bins(1) for i in b] == \
        [i.name for i in plan.items]


def test_bins_deterministic():
    plan = Plan(items=[item(f"s/{k}", cost=1.0) for k in "abcdef"])
    assert [[i.name for i in b] for b in plan.bins(3)] == \
        [[i.name for i in b] for b in plan.bins(3)]


def test_default_cost_is_median_of_hints():
    mgr = make_mgr([EXAMPLE])
    hints = {"example/noop": 2.0, "example/saxpy/n:256": 6.0}
    plan = build_plan(mgr, mgr.registry, cost_hints=hints)
    by = {i.name: i for i in plan.items}
    assert by["example/noop"].cost == 2.0
    assert by["example/saxpy/n:1024"].cost is None
    assert plan.cost_of(by["example/saxpy/n:1024"]) == 4.0


def test_load_cost_hints_from_gb_document(tmp_path):
    doc = {"context": {}, "benchmarks": [
        {"name": "s/a", "run_name": "s/a", "run_type": "iteration",
         "repetitions": 1, "repetition_index": 0, "threads": 1,
         "iterations": 10, "real_time": 2000.0, "cpu_time": 2000.0,
         "time_unit": "us"}]}
    p = tmp_path / "base.json"
    p.write_text(json.dumps(doc))
    assert load_cost_hints(str(p))["s/a"] == pytest.approx(2e-3)


def test_load_cost_hints_prefers_manifest_durations(tmp_path):
    run = tmp_path / "r"
    run.mkdir()
    (run / "manifest.json").write_text(json.dumps({
        "run_id": "r", "grain": "benchmark",
        "items": [
            {"instance_id": "x", "name": "s/a", "status": "ok",
             "duration_s": 7.5, "shard": "shards/x.json"},
            {"instance_id": "y", "name": "s/b", "status": "error",
             "duration_s": 1.0, "shard": "shards/y.json"},
        ]}))
    assert load_cost_hints(str(run)) == {"s/a": 7.5}


# ---------------------------------------------------------------------------
# baseline/scopeplot read instance-sharded run directories
# ---------------------------------------------------------------------------

def _instance_shard(name, t_us):
    return {"context": {"instance": {"instance_id": instance_id(name),
                                     "name": name, "status": "ok"}},
            "benchmarks": [{
                "name": name, "run_name": name, "run_type": "iteration",
                "repetitions": 1, "repetition_index": 0, "threads": 1,
                "iterations": 1, "real_time": t_us, "cpu_time": t_us,
                "time_unit": "us"}]}


def _write_instance_run_dir(run, names, drop_manifest=False):
    shards = run / "shards"
    shards.mkdir(parents=True)
    items = []
    for n in names:
        iid = instance_id(n)
        (shards / f"{iid}.json").write_text(
            json.dumps(_instance_shard(n, 1.0)))
        items.append({"instance_id": iid, "name": n, "status": "ok",
                      "shard": f"shards/{iid}.json"})
    if not drop_manifest:
        (run / "manifest.json").write_text(json.dumps(
            {"run_id": run.name, "grain": "benchmark", "items": items}))


def test_load_document_reads_interrupted_instance_run_dir(tmp_path):
    run = tmp_path / "r1"
    _write_instance_run_dir(run, ["s/zeta", "s/alpha", "s/mid"])
    doc = bl.load_document(str(run))
    assert [r["name"] for r in doc["benchmarks"]] == \
        ["s/zeta", "s/alpha", "s/mid"]


def test_load_document_instance_dir_without_manifest(tmp_path):
    run = tmp_path / "r2"
    _write_instance_run_dir(run, ["s/b", "s/a"], drop_manifest=True)
    doc = bl.load_document(str(run))
    assert sorted(r["name"] for r in doc["benchmarks"]) == ["s/a", "s/b"]


def test_scopeplot_loads_port_instance_run_dir(tmp_path):
    """The port has no ScopePlot yet: the reference's loader reads the
    instance-sharded run directory the port's orchestrator writes, in
    plan order, with and without its merged.json."""
    from repro.scopeplot import load
    mgr = make_mgr([EXAMPLE])
    res = execute(mgr, mgr.registry, OrchestratorOptions(
        jobs=1, shard_grain="benchmark", run=FAST,
        results_dir=str(tmp_path), run_id="r3"))
    names = [i.name for i in res.plan.items]
    out = tmp_path / "r3"
    assert [r.name for r in load(str(out))] == names
    (out / "merged.json").unlink()
    assert [r.name for r in load(str(out))] == names
    assert load(str(out)).scope_names() == ["example"]


# ---------------------------------------------------------------------------
# parity with the reference, and the CLI
# ---------------------------------------------------------------------------

def test_plan_ids_identical_to_reference(on_device):
    """Plan IDs come from instance names alone: the example scope gives
    the same (name, ID) sequence in both packages, and so does the
    linalg scope registered for the card."""
    def ids(plan):
        return [(i.name, i.instance_id) for i in plan.items]
    ref = make_ref_mgr(["repro.scopes.example_scope"])
    port = make_mgr([EXAMPLE])
    assert ids(build_plan(port, port.registry)) == \
        ids(ref_build_plan(ref, ref.registry))
    on_device("cuda")
    ref = make_ref_mgr(["repro.scopes.linalg_scope"])
    port = make_mgr(["repro_torch.scopes.linalg_scope"])
    assert ids(build_plan(port, port.registry)) == \
        ids(ref_build_plan(ref, ref.registry))


def test_plan_cli_bins_and_hints(tmp_path):
    """``python -m repro_torch plan`` prints every instance with its ID
    and bin, without a card (nothing runs), and takes cost hints."""
    hints = tmp_path / "hints.json"
    hints.write_text(json.dumps({"context": {}, "benchmarks": [
        {"name": "example/noop", "run_name": "example/noop",
         "run_type": "iteration", "repetitions": 1, "repetition_index": 0,
         "threads": 1, "iterations": 1, "real_time": 5.0, "cpu_time": 5.0,
         "time_unit": "s"}]}))
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch", "plan", "--enable-scope",
         "example", "--enable-scope", "linalg", "--jobs", "2", "--costs",
         str(hints)], capture_output=True, text=True, env=_env(), cwd=ROOT,
        timeout=300)
    assert r.returncode == 0, r.stderr
    rows = [line.split() for line in r.stdout.splitlines()
            if line.startswith(("example/", "linalg/"))]
    assert len(rows) == 16                  # 8 example + 8 linalg
    by = {row[0]: row for row in rows}
    assert by["example/noop"][2] == "prior"
    assert by["linalg/matmul_rect/m:512/n:256/k:256"][4] == \
        instance_id("linalg/matmul_rect/m:512/n:256/k:256")
    assert {row[3] for row in rows} == {"0", "1"}
    assert "16 instance(s) across 2 worker bin(s)" in r.stdout


def _parsers():
    from repro_torch.core.baseline import build_compare_parser
    from repro_torch.core.ci import build_ci_parser
    from repro_torch.core.main import build_plan_parser, build_run_parser
    from repro_torch.core.tune import build_tune_parser
    from repro_torch.store.cli import build_query_parser, build_store_parser
    return {"run": build_run_parser(), "plan": build_plan_parser(),
            "compare": build_compare_parser(), "tune": build_tune_parser(),
            "ci": build_ci_parser(), "query": build_query_parser(),
            "store": build_store_parser()}


def test_help_examples_appear_and_parse():
    """Every ``--help`` example of the port's commands is in its
    epilog and parses against that command's parser; leftover tokens
    are declared core or scope flags, not typos."""
    from repro_torch.core.cli_examples import EXAMPLES
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load()
    # the process's FLAGS also hold the scope flags of any run made in
    # this process before: the fresh manager's declarations replace them
    flag_parser = mgr.flags.build_parser(FLAGS.build_parser(
        argparse.ArgumentParser(conflict_handler="resolve")))
    parsers = _parsers()
    assert set(EXAMPLES) == set(parsers)
    for cmd, examples in EXAMPLES.items():
        help_text = parsers[cmd].format_help()
        for _, example in examples:
            assert example in help_text, (cmd, example)
            tokens = shlex.split(example)
            assert tokens[:4] == ["python", "-m", "repro_torch", cmd]
            _, rest = parsers[cmd].parse_known_args(tokens[4:])
            _, unknown = flag_parser.parse_known_args(rest)
            assert unknown == [], (example, unknown)
