"""The port's partition and logical rules (``repro_torch.distributed``)
and its meshes (``repro_torch.launch.mesh``) against the JAX package's,
on the CPU.

Exact equality: every leaf's spec from ``param_specs``,
``zero_shard_specs``, ``cache_specs`` and ``input_specs_tree`` for the
ten archs on the reference's three stand-in meshes (16×16, 2×16×16,
2×4; ``tests/test_partition.py``), ``PartitionSpec``\\ s compared as
tuples; ``default_rules`` apart from the mesh object.  Then the specs
as DTensor placements on real ``DeviceMesh``\\ es over fake groups, the
meshes' group handling, ``constrain`` without rules, and the train
step's ``grad_specs`` on a one-rank gloo group: three steps on DTensor
state equal the plain step's within 1e-6.
"""
import jax
import pytest
import torch
import torch.distributed as dist

from repro.distributed import logical as ref_logical
from repro.distributed import partition as ref_part
from repro.launch import inputs as ref_inp
from repro.models import build as ref_build
from repro.models import get_config as ref_get_config
from repro.models import list_archs as ref_list_archs
from repro_torch.distributed import logical, partition as part
from repro_torch.launch import inputs as inp
from repro_torch.launch.mesh import (make_host_mesh, make_mesh,
                                     make_production_mesh)
from repro_torch.models import build, family_module, get_config, tree
from repro_torch.train import AdamWConfig, make_init_fn, make_train_step

ARCHS = list(ref_list_archs())


class FakeMesh:
    """Mesh stand-in exposing .shape only (rules never touch devices)."""
    def __init__(self, shape):
        self.shape = dict(shape)


MESHES = [FakeMesh({"data": 16, "model": 16}),
          FakeMesh({"pod": 2, "data": 16, "model": 16}),
          FakeMesh({"data": 2, "model": 4})]
IDS = ["16x16", "2x16x16", "2x4"]


def ref_specs(spec_tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {ref_part._path_str(p): tuple(s) for p, s in flat}


def port_specs(spec_tree):
    out = {}
    part.map_with_path(lambda p, s: out.__setitem__(part._path_str(p), s),
                       spec_tree)
    return out


def ref_params(arch):
    return jax.eval_shape(ref_build(ref_get_config(arch)).init,
                          jax.ShapeDtypeStruct((2,), jax.numpy.uint32))


def port_params(arch):
    cfg = get_config(arch)
    return family_module(cfg).init(cfg, torch.Generator(), device="meta")


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero_specs_equal_reference(arch, mesh):
    rp, pp = ref_params(arch), port_params(arch)
    rc, pc = ref_get_config(arch), get_config(arch)
    for ref_fn, fn in ((ref_part.param_specs, part.param_specs),
                       (ref_part.zero_shard_specs, part.zero_shard_specs)):
        assert port_specs(fn(pc, pp, mesh)) == ref_specs(ref_fn(rc, rp, mesh))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_reference(arch, mesh):
    rc, pc = ref_get_config(arch), get_config(arch)
    for shape in ("decode_32k", "long_500k"):
        assert port_specs(part.cache_specs(
            pc, inp.cache_structs(pc, shape), mesh)) == ref_specs(
            ref_part.cache_specs(rc, ref_inp.cache_structs(rc, shape), mesh))
    for shape in ("train_4k", "prefill_32k", "long_500k"):
        assert port_specs(part.input_specs_tree(
            pc, inp.input_specs(pc, shape), mesh)) == ref_specs(
            ref_part.input_specs_tree(rc, ref_inp.input_specs(rc, shape),
                                      mesh))


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_mesh_helpers_and_default_rules_equal_reference(mesh):
    assert part.batch_axes(mesh) == ref_part.batch_axes(mesh)
    assert part.dp_size(mesh) == ref_part.dp_size(mesh)
    assert part.axis_size(mesh, "model") == ref_part.axis_size(mesh, "model")
    assert part.batch_spec(mesh, 3, 1) == tuple(ref_part.batch_spec(mesh, 3,
                                                                    1))
    for arch in ARCHS:
        ref = ref_logical.default_rules(ref_get_config(arch), mesh)
        mine = logical.default_rules(get_config(arch), mesh)
        assert mine.pop("mesh") is mesh and ref.pop("mesh") is mesh
        assert mine == ref


def test_placements_on_device_meshes():
    from torch.distributed.tensor import Replicate, Shard
    with make_mesh((2, 2, 2), ("pod", "data", "model")) as mesh:
        assert part.placements((("pod", "data"), None, "model"), mesh) == \
            [Shard(0), Shard(0), Shard(2)]
        assert part.placements((), mesh) == [Replicate()] * 3
        tree_pl = part.shardings_of({"a": (None, "model"), "b": ()}, mesh)
        assert tree_pl == {"a": [Replicate(), Replicate(), Shard(1)],
                           "b": [Replicate()] * 3}
        with pytest.raises(ValueError, match="twice"):
            part.placements(("model", "model"), mesh)
        assert part.mesh_shape(mesh) == {"pod": 2, "data": 2, "model": 2}
    assert not dist.is_initialized()


def test_meshes_open_and_close_their_groups():
    with make_production_mesh() as mesh:
        assert tuple(mesh.shape) == (16, 16)
        assert mesh.mesh_dim_names == ("data", "model")
        assert dist.get_world_size() == 256
        # a mesh of the size of the group that is up reuses it
        with make_mesh((16, 16), ("data", "model")) as again:
            assert again.size() == 256
        assert dist.is_initialized()
        with pytest.raises(RuntimeError, match="256 ranks is up"):
            with make_mesh((2, 4), ("data", "model")):
                pass
    assert not dist.is_initialized()
    with make_production_mesh(multi_pod=True) as mesh:
        assert tuple(mesh.shape) == (2, 16, 16)
        assert mesh.mesh_dim_names == ("pod", "data", "model")
    assert not dist.is_initialized()
    with make_host_mesh(1) as mesh:
        assert tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo"
    assert not dist.is_initialized()


def test_constrain_without_rules_or_dtensor_is_identity():
    x = torch.randn(2, 3)
    assert logical.constrain(x, "batch", None) is x
    with make_mesh((2, 4), ("data", "model")) as mesh:
        rules = logical.default_rules(get_config("llama3.2-1b"), mesh)
        with logical.logical_rules(rules):
            assert logical.active_rules() is rules
            assert logical.constrain(x, "batch", None) is x
        assert logical.active_rules() is None


def test_constrain_redistributes_dtensors():
    from torch.distributed.tensor import DTensor, Replicate, Shard
    with make_mesh((2, 4), ("data", "model")) as mesh:
        rules = logical.default_rules(get_config("llama3.2-1b"), mesh)
        x = DTensor.from_local(torch.zeros(4, 8, 32), mesh,
                               [Replicate(), Replicate()], run_check=False)
        with logical.logical_rules(rules):
            y = logical.constrain(x, "batch", None, "heads")
            # 'batch' on data, 'heads' on model; a dim the axis does not
            # divide stays whole (the rules' divisibility guard)
            assert y.placements == (Shard(0), Shard(2))
            z = logical.constrain(x[:, :, :3], "batch", None, "heads")
            assert z.placements == (Shard(0), Replicate())


def test_grad_specs_steps_equal_plain_steps():
    """Three microbatched steps on DTensor state over a one-rank gloo
    group, the gradient accumulator placed by ``zero_shard_specs``,
    against the same steps on plain tensors: loss and parameters within
    1e-6."""
    from torch.distributed.tensor import DTensor
    cfg = get_config("llama3.2-1b").reduced().override(dtype="float32")
    api = build(cfg)
    opt = AdamWConfig(lr=1e-3, warmup_steps=0)
    gen = torch.Generator().manual_seed(0)
    batches = [{"tokens": torch.randint(0, cfg.vocab_size, (4, 32),
                                        generator=gen, dtype=torch.int32)}
               for _ in range(3)]
    plain = make_init_fn(api, opt)(torch.Generator().manual_seed(1))
    start = tree.map(lambda t: t.clone(), plain)
    step = make_train_step(api, opt, num_microbatches=2)
    plain_losses = []
    for b in batches:
        plain, m = step(plain, b)
        plain_losses.append(float(m["loss"]))
    with make_host_mesh(1) as mesh:
        zs = part.zero_shard_specs(cfg, start["params"], mesh)
        ps = part.param_specs(cfg, start["params"], mesh)

        def place(t, spec):
            return DTensor.from_local(t, mesh, part.placements(spec, mesh),
                                      run_check=False)
        state = {"params": part_map(place, start["params"], ps),
                 "opt": {"m": part_map(place, start["opt"]["m"], zs),
                         "v": part_map(place, start["opt"]["v"], zs),
                         "count": place(start["opt"]["count"], ())},
                 "step": place(start["step"], ())}
        dstep = make_train_step(api, opt, num_microbatches=2, grad_specs=zs)
        rules = logical.default_rules(cfg, mesh)
        for b, want in zip(batches, plain_losses):
            db = {k: place(v, part.batch_spec(mesh, v.ndim))
                  for k, v in b.items()}
            with logical.logical_rules(rules):
                state, m = dstep(state, db)
            assert abs(float(m["loss"].full_tensor()) - want) <= 1e-6
        for got, ref in zip(tree.flatten(state["params"]),
                            tree.flatten(plain["params"])):
            torch.testing.assert_close(got.full_tensor(), ref, atol=1e-6,
                                       rtol=1e-6)
    assert not dist.is_initialized()


def part_map(fn, tensors, specs):
    """``fn(tensor, spec)`` over a tree and its matching spec tree."""
    if isinstance(tensors, dict):
        return {k: part_map(fn, v, specs[k]) for k, v in tensors.items()}
    return fn(tensors, specs)


def test_a_one_rank_axis_replicates():
    """A mesh dim of one rank splits nothing: its placement is
    ``Replicate``, so a batch of 1 on the 1×1 host mesh still views and
    multiplies (a ``Shard`` of a size-1 dim over it cannot be viewed)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.launch.mesh import make_host_mesh
    with make_mesh((1, 4), ("data", "model")) as mesh:
        assert part.placements(("data", "model"), mesh) == \
            [Replicate(), Shard(1)]
    with make_host_mesh() as mesh:
        x = part.distribute(torch.randn(1, 8, 4), mesh, ("data", None, None))
        w = part.distribute(torch.randn(4, 6), mesh, (None, "model"))
        assert list(x.placements) == [Replicate(), Replicate()]
        y = x @ w
        assert torch.equal(y.full_tensor(), x.full_tensor() @ w.full_tensor())
    assert not dist.is_initialized()
