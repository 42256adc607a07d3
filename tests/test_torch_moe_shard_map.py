"""The expert-parallel MoE (``layers.moe_shard_map``, chosen by
``moe_layer`` under logical rules) on four gloo ranks, mesh (2, 2).

(a) The reference test's case (``tests/test_multidevice.py::
test_moe_shard_map_matches_reference``: E = 8, top-2, capacity factor
8.0, so nothing is dropped): the output and the gradients of x and of
every weight against the port's ``moe_scatter`` on the whole batch in
one process.  (b) With drops (capacity factor 1.0), a prefill and a
decode shape, against the reference's ``moe_shard_map`` run in a JAX
subprocess on 4 host devices, mesh (2, 2), on the same numpy inputs
and weights: the same outputs, so the same capacity drops.  (c) A
batch that does not divide the data axis: x replicated, the same
checks as (a).  (d) The einsum dispatch, which ``moe_layer`` runs on
each rank's rows with every expert gathered: the same checks.  Every
check is within 1e-5 (relative to values above 1).

The aux loss is the whole batch's, as ``moe_scatter`` computes it on
one device: each rank's load-balance statistics are averaged over the
batch axes.  The reference's ``moe_shard_map`` returns the first batch
shard's aux instead (its ``out_specs`` give aux as ``P()`` with
``check=False``); (b) shows it (``ROADMAP.md`` queue 3).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_ranks import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, TOL = 4, 1e-5
D, E, FF, TOP_K = 32, 8, 64, 2
#: case → (x shape, capacity factor)
CASES = {"no_drops": ((4, 16, D), 8.0), "prefill": ((4, 64, D), 1.0),
         "decode": ((128, 1, D), 1.0), "replicated": ((3, 16, D), 8.0),
         "gathered": ((4, 16, D), 8.0)}


def _cfg(case):
    """The case's config; "gathered" dispatches by einsum, which
    ``moe_layer`` runs with every expert gathered on each rank."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(name="t", family="moe", num_layers=2, d_model=D,
                       num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                       moe_num_experts=E, moe_top_k=TOP_K, moe_d_ff=FF,
                       moe_capacity_factor=CASES[case][1], dtype="float32",
                       moe_dispatch="einsum" if case == "gathered"
                       else "scatter")


def _inputs(case):
    """x, the weights and a cotangent for y, from a seed (numpy)."""
    shape, _ = CASES[case]
    rng = np.random.default_rng(7)
    w = {"router": rng.normal(0, 0.02, (D, E)),
         "w_up": rng.normal(0, D ** -0.5, (E, D, FF)),
         "w_gate": rng.normal(0, D ** -0.5, (E, D, FF)),
         "w_down": rng.normal(0, FF ** -0.5, (E, FF, D))}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    return (rng.normal(0, 1, shape).astype(np.float32), w,
            rng.normal(0, 1, shape).astype(np.float32))


def _close(what, got, want):
    want = torch.as_tensor(want)
    err = (got - want).abs().max().item()
    assert err <= TOL * max(want.abs().max().item(), 1.0), \
        f"{what}: max abs error {err:.3g}"


def _ranks(rank, case, ref_path):
    import torch.distributed as dist
    from repro_torch.distributed import logical, partition as part
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    x, w, r = _inputs(case)
    cfg = _cfg(case)
    keys = list(w)
    # one process: moe_scatter on the whole batch (the oracle of (a), (c))
    leaves = [torch.from_numpy(w[k]).requires_grad_() for k in keys]
    xr = torch.from_numpy(x).requires_grad_()
    y1, aux1 = L.moe_scatter(dict(zip(keys, leaves)), xr, top_k=TOP_K,
                             capacity_factor=cfg.moe_capacity_factor)
    grads1 = torch.autograd.grad((y1 * torch.from_numpy(r)).sum() + aux1,
                                 [xr] + leaves)
    with make_host_mesh(2) as mesh:
        rules = logical.default_rules(cfg, mesh)
        assert rules["experts"] == "model"
        dw = [part.distribute(torch.from_numpy(w[k]), mesh,
                              () if k == "router" else ("model", None, None)
                              ).requires_grad_() for k in keys]
        dx = part.distribute(torch.from_numpy(x), mesh,
                             part.input_specs_tree(cfg, {"x": x}, mesh)["x"]
                             ).requires_grad_()
        with logical.logical_rules(rules):
            y, aux = L.moe_layer(dict(zip(keys, dw)), dx, cfg)
            grads = torch.autograd.grad(
                (y * torch.from_numpy(r)).sum() + aux, [dx] + dw)
        replicated = case == "replicated"
        assert y.placements[0].is_replicate() == replicated
        y, aux = y.full_tensor(), aux.full_tensor()
        grads = [g.full_tensor() for g in grads]
    if ref_path is None:                 # (a) and (c): the one-process oracle
        _close("y", y, y1.detach())
        _close("aux", aux, aux1.detach())
        for name, g, g1 in zip(["x"] + keys, grads, grads1):
            _close(f"gradient {name}", g, g1)
        return
    # (b): the reference's moe_shard_map on 4 jax devices
    want = np.load(ref_path)
    _close("y", y, want["y"])
    # capacity 1.0 dropped assignments: without a limit y differs
    y_all, _ = L.moe_scatter({k: torch.from_numpy(v) for k, v in w.items()},
                             torch.from_numpy(x), top_k=TOP_K,
                             capacity_factor=100.0)
    assert (y_all - torch.from_numpy(want["y"])).abs().max() > 1e-3
    # the whole batch's aux; the reference's is its first batch shard's
    _close("aux", aux, want["aux_whole"])
    first, second = (float(a) for a in want["aux_shards"])
    assert abs(float(want["aux_shard_map"]) - first) <= 1e-6 \
        < abs(first - second)
    assert dist.get_world_size() == WORLD


_REFERENCE = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.models import layers as L
from repro.models.config import ModelConfig
from repro.distributed.logical import default_rules, logical_rules
src, out, cf = sys.argv[1], sys.argv[2], float(sys.argv[3])
a = np.load(src)
x = jnp.asarray(a["x"])
p = {k: jnp.asarray(a[k]) for k in ("router", "w_up", "w_gate", "w_down")}
cfg = ModelConfig(name="t", family="moe", num_layers=2, d_model=x.shape[-1],
                  num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=128,
                  moe_num_experts=p["w_up"].shape[0], moe_top_k=2,
                  moe_d_ff=p["w_up"].shape[-1], moe_capacity_factor=cf)
mesh = jax.make_mesh((2, 2), ("data", "model"))
with mesh:
    pw = dict(p)
    for k in ("w_up", "w_gate", "w_down"):
        pw[k] = jax.device_put(p[k], NamedSharding(mesh, P("model", None, None)))
    xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
    with logical_rules(default_rules(cfg, mesh)):
        y, aux = jax.jit(lambda p, x: L.moe_layer(p, x, cfg))(pw, xs)
half = x.shape[0] // 2
shards = [float(L.moe_scatter(p, x[i * half:(i + 1) * half], top_k=2,
                              capacity_factor=cf)[1]) for i in range(2)]
whole = L.moe_scatter(p, x, top_k=2, capacity_factor=cf)[1]
np.savez(out, y=np.asarray(y), aux_shard_map=np.asarray(aux),
         aux_shards=np.asarray(shards), aux_whole=np.asarray(whole))
"""


def _reference(tmp_path, case):
    x, w, _ = _inputs(case)
    src, out = tmp_path / "inputs.npz", tmp_path / "reference.npz"
    np.savez(src, x=x, **w)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", _REFERENCE, str(src),
                          str(out), str(CASES[case][1])],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    return str(out)


@pytest.mark.parametrize("case", ["no_drops", "replicated", "gathered"])
def test_expert_parallel_equals_moe_scatter(tmp_path, case):
    run_ranks(_ranks, WORLD, tmp_path, case, None)


@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_drops_equal_the_reference_shard_map(tmp_path, case):
    run_ranks(_ranks, WORLD, tmp_path, case, _reference(tmp_path, case))
