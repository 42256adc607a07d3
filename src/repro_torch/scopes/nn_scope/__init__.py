"""NN|Scope — the cuDNN|Scope analogue: neural-network op hot-spots, back
on an NVIDIA card.

Layer-level bodies from the port's model code (:mod:`repro_torch.models.
layers`): flash attention (the plain-torch chunked formulation with its
recompute backward), RMSNorm (one typed family whose ``backend`` axis
selects ``torch``, the plain layer, or ``cuda``, the hand-written
kernel), MoE dispatch (scatter path) and the Mamba2 SSD chunked scan,
plus the hand-written kernels' own families ``flash_attention_cuda`` and
``ssd_scan_cuda`` (the reference's ``*_pallas`` families).  On the card
the kernel rows take the shapes of their plain-torch siblings, so each
pair compares point by point; the reference cut its kernel rows only
because interpret mode is slow.  Under ``--device cpu`` the ``cuda`` rows
and families are left out, as in the mxu scope.

Every family builds operands and its callable in a fixture (untimed; the
runner's warm phase reports the first call as ``compile_time_s``) and
declares its output with ``state.deliver``.  Counters and bytes/items
processed keep the reference's formulas.  The port has no kernel tuning
yet, so the families declare no tunable knobs.
"""
import torch

from repro_torch.core import FLAGS, ParamSpace, Scope, State, benchmark
from repro_torch.core.registry import BenchmarkRegistry

NAME = "nn"


def _device() -> torch.device:
    return torch.device(FLAGS.get("device"))


def _attn_operands(S, requires_grad: bool = False):
    """Causal GQA operands of the nn scope: B=2, H=4, K=2, D=64."""
    device = _device()
    q = torch.ones((2, S, 4, 64), device=device, requires_grad=requires_grad)
    k = torch.ones((2, S, 2, 64), device=device, requires_grad=requires_grad)
    v = torch.ones((2, S, 2, 64), device=device, requires_grad=requires_grad)
    return q, k, v


def _attn_flops(q) -> float:
    """Causal forward attention FLOPs: 4·B·H·S²·D / 2."""
    B, S, H, D = q.shape
    return 4.0 * B * H * S * S * D / 2


def _ssd_operands(S):
    """SSD operands of the nn scope: b=2, h=4, p=64, n=64, one group."""
    device = _device()
    b, h, p_, n = 2, 4, 64, 64
    x = torch.full((b, S, h, p_), 0.1, device=device)
    dt = torch.full((b, S, h), 0.1, device=device)
    A = -torch.ones((h,), device=device)
    Bm = torch.full((b, S, 1, n), 0.1, device=device)
    Cm = torch.full((b, S, 1, n), 0.1, device=device)
    D = torch.ones((h,), device=device)
    return x, dt, A, Bm, Cm, D


def _register(registry: BenchmarkRegistry) -> None:
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rmsnorm import rmsnorm as cuda_rmsnorm
    from repro_torch.kernels.ssd_scan import ssd
    from repro_torch.models import layers as L

    on_card = FLAGS.get("device") == "cuda"

    def flash_fwd_setup(params):
        def fn(q, k, v):
            return L.flash_attention_xla(q, k, v, causal=True, chunk_q=128,
                                         chunk_k=128)
        return (fn,) + _attn_operands(params.seq)

    @benchmark(scope=NAME, registry=registry)
    def flash_attention_fwd(state: State):
        """Causal flash attention forward (B=2, H=4, D=64) vs seq len."""
        fn, q, k, v = state.fixture
        while state.keep_running():
            state.deliver(fn(q, k, v))
        state.counters["attn_flops"] = _attn_flops(q)
    flash_attention_fwd.args([256]).args([512]).args([1024])
    flash_attention_fwd.set_arg_names(["seq"])
    flash_attention_fwd.set_fixture(flash_fwd_setup)

    def flash_bwd_setup(params):
        def fn(q, k, v):
            out = L.flash_attention_xla(q, k, v, chunk_q=128, chunk_k=128)
            return torch.autograd.grad((out ** 2).sum(), (q, k, v))
        return (fn,) + _attn_operands(params.seq, requires_grad=True)

    @benchmark(scope=NAME, registry=registry)
    def flash_attention_bwd(state: State):
        """Flash attention fwd+bwd through the recompute backward."""
        fn, q, k, v = state.fixture
        while state.keep_running():
            state.deliver(fn(q, k, v))
        # fwd + recompute + bwd ~ 2.5x the forward attention flops
        state.counters["attn_flops"] = 2.5 * _attn_flops(q)
    flash_attention_bwd.args([256]).args([512]).set_arg_names(["seq"])
    flash_attention_bwd.set_fixture(flash_bwd_setup)

    def rmsnorm_setup(params):
        device = _device()
        x = torch.ones((params.rows, params.d), device=device)
        s = torch.ones((params.d,), device=device)
        if params.backend == "torch":
            p = {"scale": s}
            return (lambda x: L.rms_norm(p, x)), x
        return (lambda x: cuda_rmsnorm(x, s)), x

    @benchmark(scope=NAME, registry=registry)
    def rmsnorm(state: State):
        """RMSNorm through the selected backend (plain torch vs the CUDA
        kernel) — one family, not a per-backend clone."""
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_bytes_processed(2 * 4 * state.params.rows * state.params.d)
    rmsnorm.param_space(
        ParamSpace.product(backend=["torch", "cuda"], rows=[4096],
                           d=[1024, 4096])
        .where(lambda p: on_card or p.backend != "cuda"))
    rmsnorm.set_fixture(rmsnorm_setup)

    if on_card:
        def flash_cuda_setup(params):
            def fn(q, k, v):
                return flash_attention(q, k, v, causal=True)
            return (fn,) + _attn_operands(params.seq)

        @benchmark(scope=NAME, registry=registry)
        def flash_attention_cuda(state: State):
            """Causal flash attention through the hand-written CUDA
            kernel, at the shapes of flash_attention_fwd."""
            fn, q, k, v = state.fixture
            while state.keep_running():
                state.deliver(fn(q, k, v))
            state.counters["attn_flops"] = _attn_flops(q)
        flash_attention_cuda.param_space(seq=[256, 512, 1024])
        flash_attention_cuda.set_fixture(flash_cuda_setup)

        def ssd_cuda_setup(params):
            def fn(*operands):
                return ssd(*operands, chunk=128)[0]
            return (fn,) + _ssd_operands(params.seq)

        @benchmark(scope=NAME, registry=registry)
        def ssd_scan_cuda(state: State):
            """Mamba2 SSD scan through the hand-written CUDA chunk kernel
            (chunk 128), at the shapes of ssd_chunked_scan."""
            fn, *operands = state.fixture
            while state.keep_running():
                state.deliver(fn(*operands))
            state.set_items_processed(2 * state.params.seq)
        ssd_scan_cuda.param_space(seq=[1024, 4096])
        ssd_scan_cuda.set_fixture(ssd_cuda_setup)

    def moe_setup(params):
        E, k, d, ff = 8, 2, 256, 512
        device = _device()
        p = L.init_moe(torch.Generator(device).manual_seed(0), d, E, ff, 0)
        x = torch.ones((1, params.tokens, d), device=device)

        def fn(x):
            return L.moe_scatter(p, x, top_k=k, capacity_factor=1.25)[0]
        return fn, x

    @benchmark(scope=NAME, registry=registry)
    def moe_dispatch_scatter(state: State):
        """Capacity-based MoE (router+dispatch+experts+combine)."""
        fn, x = state.fixture
        while state.keep_running():
            state.deliver(fn(x))
        state.set_items_processed(state.params.tokens)
    moe_dispatch_scatter.args([1024]).args([4096])
    moe_dispatch_scatter.set_arg_names(["tokens"])
    moe_dispatch_scatter.set_fixture(moe_setup)

    def ssd_setup(params):
        def fn(*operands):
            return L.ssd_chunked(*operands, chunk=128)[0]
        return (fn,) + _ssd_operands(params.seq)

    @benchmark(scope=NAME, registry=registry)
    def ssd_chunked_scan(state: State):
        """Mamba2 SSD chunked scan (plain-torch formulation)."""
        fn, *operands = state.fixture
        while state.keep_running():
            state.deliver(fn(*operands))
        state.set_items_processed(2 * state.params.seq)
    ssd_chunked_scan.args([1024]).args([4096]).set_arg_names(["seq"])
    ssd_chunked_scan.set_fixture(ssd_setup)


SCOPE = Scope(name=NAME, version="2.0.0",
              description="NN-operation hot-spots (cuDNN|Scope analogue)",
              register=_register)
