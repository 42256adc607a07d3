"""The torch port's linalg scope against the JAX package's, on the CPU.

The same seeded numpy inputs go through the reference's fixture
callables (jitted XLA, and the Pallas matmul in interpret mode) and the
port's, held to the reference's tolerances: float32 1e-5 (the einsum,
the factorization and the solve sum in another order on each side),
bfloat16 2e-2 (one bf16 ulp of a unit-scale product is 2**-8).  The
instance names must equal the reference's: all of them when the port
registers for the card, all but ``matmul_rect`` (a CUDA kernel row)
under ``--device cpu``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core.flags import FlagRegistry as RefFlagRegistry
from repro.core.hooks import HookChain as RefHookChain
from repro.core.registry import BenchmarkRegistry as RefRegistry
from repro.core.scope import ScopeManager as RefScopeManager
from repro_torch.core.bridge import from_numpy
from repro_torch.core.flags import FLAGS, FlagRegistry
from repro_torch.core.hooks import HookChain
from repro_torch.core.registry import BenchmarkRegistry
from repro_torch.core.scope import ScopeManager
from repro_torch.kernels.matmul import matmul as port_matmul

F32_TOL = 1e-5
BF16_TOL = 2e-2


def _families(mgr_cls, registry, flags, hooks):
    mgr = mgr_cls(registry=registry, flags=flags, hooks=hooks)
    mgr.load()
    mgr.configure(enable=["linalg"])
    mgr.register_all()
    return {b.name: b for b in registry.all()}


def _ref_families():
    return _families(RefScopeManager, RefRegistry(), RefFlagRegistry(),
                     RefHookChain())


def _port_families():
    return _families(ScopeManager, BenchmarkRegistry(), FlagRegistry(),
                     HookChain())


def _fixture(families, family, **point):
    bench = families[family]
    for _, params in bench.instances():
        if dict(params) == point:
            return bench.fixture(params)
    raise KeyError(point)


@pytest.fixture
def on_device():
    """Sets FLAGS' device (the port's scopes register and allocate on
    it) and restores it."""
    before = FLAGS.get("device")

    def set_device(device):
        FLAGS.set("device", device)
    yield set_device
    FLAGS.set("device", before)


def _names(families):
    return [name for b in families.values() for name, _ in b.instances()]


def test_instance_names_match_reference(on_device):
    ref = _names(_ref_families())
    on_device("cuda")                 # registering needs no card
    assert _names(_port_families()) == ref
    on_device("cpu")
    assert _names(_port_families()) == \
        [n for n in ref if not n.startswith("linalg/matmul_rect/")]
    assert "linalg/matmul_rect/m:512/n:256/k:256" in ref


@pytest.mark.parametrize("dtype,n", [("f32", 128), ("f32", 256),
                                     ("bf16", 128), ("bf16", 256)])
def test_batched_matmul_on_reference_inputs(on_device, dtype, n):
    on_device("cpu")
    rng = np.random.default_rng(n)
    a = rng.standard_normal((8, n, n), np.float32) / np.sqrt(n)
    ref_fn, ref_x = _fixture(_ref_families(), "linalg/batched_matmul",
                             dtype=dtype, b=8, n=n)
    x = jnp.asarray(a, ref_x.dtype)
    want = np.asarray(ref_fn(x), np.float32)
    fn, px = _fixture(_port_families(), "linalg/batched_matmul",
                      dtype=dtype, b=8, n=n)
    tx = from_numpy(np.asarray(x))
    assert tx.dtype == px.dtype and px.device.type == "cpu"
    tol = F32_TOL if dtype == "f32" else BF16_TOL
    np.testing.assert_allclose(fn(tx).float().numpy(), want, atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("n", [256, 512])
def test_cholesky_on_reference_inputs(on_device, n):
    on_device("cpu")
    rng = np.random.default_rng(n)
    m = rng.standard_normal((n, n), np.float32)
    a = (m @ m.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    ref_fn, _ = _fixture(_ref_families(), "linalg/cholesky", n=n)
    want = np.asarray(ref_fn(jnp.asarray(a)))
    fn, pa = _fixture(_port_families(), "linalg/cholesky", n=n)
    assert pa.dtype == from_numpy(a).dtype and pa.shape == (n, n)
    np.testing.assert_allclose(fn(from_numpy(a)).numpy(), want,
                               atol=F32_TOL, rtol=F32_TOL)


def test_triangular_solve_on_reference_inputs(on_device):
    on_device("cpu")
    n = 256
    rng = np.random.default_rng(7)
    a = (np.eye(n) + np.tril(rng.standard_normal((n, n)) * 0.01)
         ).astype(np.float32)
    b = rng.standard_normal((n, 16), np.float32)
    ref_fn, _, ref_b = _fixture(_ref_families(), "linalg/triangular_solve",
                                n=n)
    want = np.asarray(ref_fn(jnp.asarray(a), jnp.asarray(b)))
    fn, pa, pb = _fixture(_port_families(), "linalg/triangular_solve", n=n)
    assert pb.shape == tuple(ref_b.shape) and pa.shape == (n, n)
    np.testing.assert_allclose(
        fn(*from_numpy((a, b))).numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_matmul_rect_plain_path_on_reference_inputs():
    """The reference's ``matmul_rect`` (its Pallas kernel in interpret
    mode) against the port's kernel wrapper on CPU tensors, which takes
    the plain version, at the family's 512×256×256 float32 point, to the
    reference's matmul tolerance (1e-4)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((512, 256), np.float32) / 16
    y = rng.standard_normal((256, 256), np.float32)
    ref_fn, _, _ = _fixture(_ref_families(), "linalg/matmul_rect",
                            m=512, n=256, k=256)
    want = np.asarray(ref_fn(jnp.asarray(x), jnp.asarray(y)))
    got = port_matmul(*from_numpy((x, y)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)
