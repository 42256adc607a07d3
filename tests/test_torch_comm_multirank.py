"""The comm scope's ``all_reduce_measured`` over four gloo ranks.

Each rank joins one group (as a launcher's ranks would), then builds
the family's fixture and runs its body through the port's runner:
``process_group`` takes the group that is up, so the records count 4
``devices``, each rank's operand holds ``params.bytes`` (one row of the
reference's ``(devices, bytes / 4)`` operand sharded over its mesh),
and the reduced tensor is 4.0 everywhere.  Every rank runs the same
fixed iteration count (a rank that calibrated its own from its clock
would pair its all-reduces with another instance's).
"""
import torch
from torch_ranks import run_ranks

WORLD = 4


def _ranks(rank):
    import torch.distributed as dist
    from repro_torch.core.flags import FLAGS, FlagRegistry
    from repro_torch.core.hooks import HookChain
    from repro_torch.core.registry import BenchmarkRegistry
    from repro_torch.core.runner import RunOptions, run_benchmarks
    from repro_torch.core.scope import ScopeManager
    from repro_torch.scopes import comm_scope
    FLAGS.set("device", "cpu")
    mgr = ScopeManager(registry=BenchmarkRegistry(), flags=FlagRegistry(),
                       hooks=HookChain())
    mgr.load(["repro_torch.scopes.comm_scope"])
    mgr.register_all()
    (bench,) = [b for b in mgr.registry.all()
                if b.name == "comm/all_reduce_measured"]
    for _, params in bench.instances():
        f, x = bench.fixture(params)
        assert x.numel() * x.element_size() == params.bytes
        out = f(x)
        assert torch.equal(out, torch.full_like(x, float(WORLD)))
        assert torch.equal(x, torch.ones_like(x))
    assert comm_scope.process_group("cpu") == "gloo"
    assert dist.get_world_size() == WORLD
    doc = run_benchmarks([bench], RunOptions(min_time=0.002, device="cpu"),
                         progress=False)
    records = doc["benchmarks"]
    assert [r["name"] for r in records] == [
        f"comm/all_reduce_measured/bytes:{b}"
        for b in (1 << 16, 1 << 19, 1 << 22)]
    for r in records:
        assert not r.get("error_occurred"), r
        assert r["devices"] == WORLD
        # every rank ran as many all-reduces: none calibrated its own
        assert r["iterations"] == comm_scope.RANKS_ITERATIONS
        assert r["bytes_per_second"] > 0


def test_all_reduce_measured_spans_the_ranks(tmp_path):
    run_ranks(_ranks, WORLD, tmp_path)
