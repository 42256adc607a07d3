"""The port's hybrid path on a Granite 4.0-H layer pattern, on the CPU.

One period of ten layers (attention at index 5, Mamba2 elsewhere), an
MoE on every layer with a shared expert and no dense MLP, convolution
biases, a tied table and Granite's four μP scalars, at a tiny size in
float32, against the benchmark's plain reference
(``bench/reference/granite_hybrid.py``) on the same seeded weights, and
the dropless held-expert layer (``layers.moe_held``) against a
per-token loop and against the uncut layer.  Tolerances:

  * the loss 1e-5 nats and the logits atol 1e-6, rtol 1e-5 (the two
    agree to ~5e-8 of logits ~0.04: float32 sums in different orders);
    each leaf's gradient within 1e-4 of its largest reference entry
    (they agree to ~2e-6);
  * the held layer against a loop or the uncut layer: atol = rtol =
    1e-5 (float32, sums in different orders);
  * prefill plus decode against the forward, in float32: atol = rtol =
    1e-4, the decode tests' float32 tolerance; on a float32 residual
    stream under bfloat16, their bfloat16 one (atol 5e-2, rtol 1e-2),
    and the loss within 1e-2 nats of the reference (it reads ~4e-5).
"""
import math
import sys
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.reference import granite_hybrid as ref  # noqa: E402
from bench.reference.common import Numerics  # noqa: E402
from repro_torch.models import build, hybrid, tracing, tree  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

#: A Granite 4.0-H period at a tiny size: the reference's ``model`` dict.
MODEL = {"family": "hybrid", "num_layers": 10, "d_model": 64,
         "num_heads": 4, "num_kv_heads": 2, "head_dim": 16, "d_ff": 0,
         "vocab_size": 256, "norm_eps": 1e-05, "tie_embeddings": True,
         "use_rope": False, "embedding_multiplier": 12.0,
         "residual_multiplier": 0.22, "attention_multiplier": 0.0625,
         "logits_scaling": 16.0, "attn_every": 10, "attn_offset": 5,
         "moe_num_experts": 8, "moe_top_k": 3, "moe_num_shared": 2,
         "moe_d_ff": 32, "moe_every": 1, "moe_offset": 0,
         "moe_experts_held": 4, "ssm_state": 16, "ssm_expand": 2,
         "ssm_head_dim": 16, "ssm_conv": 4, "ssm_groups": 1,
         "ssm_conv_bias": True}
POLICY = {"dtype": "float32", "logits_dtype": "float32", "remat": "full",
          "loss_chunk": 32, "attn_impl": "flash_xla", "attn_chunk_q": 16,
          "attn_chunk_k": 16, "causal_skip": True, "ssm_chunk": 16,
          "moe_dispatch": "dropless"}
B, S = 2, 64
F32 = Numerics("float32")


def _cfg(model=MODEL, **policy) -> ModelConfig:
    return ModelConfig(name="granite-tiny", **model, **{**POLICY, **policy})


def _batch(seed=3):
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, MODEL["vocab_size"], (B, S), generator=g)
    return {"tokens": tokens,
            "labels": torch.cat([tokens[:, 1:], tokens[:, :1]], dim=1)}


def _leaves(params):
    return [t for _, t in tree.leaves(params)]


def _port_and_reference(model, params, batch):
    """(port loss, reference loss, port logits of row 0, reference
    logits of row 0) on the same weights."""
    api = build(_cfg())
    port, _ = api.loss(params, batch)
    ours = ref.loss(model, params, batch["tokens"], batch["labels"], F32)
    with torch.no_grad():
        lp, _ = api.logits(params, {"tokens": batch["tokens"][:1]})
        lr = ref.logits(model, params, batch["tokens"][0], F32,
                        torch.arange(S))
    return port, ours, lp[0], lr


def test_loss_logits_and_grads_match_the_reference():
    params = ref.make_params(MODEL, 7, "cpu")
    batch = _batch()
    for t in _leaves(params):
        t.requires_grad_(True)
    port, ours, lp, lr = _port_and_reference(MODEL, params, batch)
    assert abs(float(port.detach()) - float(ours.detach())) < 1e-5
    torch.testing.assert_close(lp, lr, atol=1e-6, rtol=1e-5)
    gp = torch.autograd.grad(port, _leaves(params))
    gr = torch.autograd.grad(ours, _leaves(params))
    for (path, _), a, b in zip(tree.leaves(params), gp, gr):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()), \
            path


@pytest.mark.parametrize("mutant", ["routed_left_out", "top_k_minus_1"])
def test_a_mutant_reference_fails_the_comparison(mutant):
    """The comparison above sees a routed part left out, or top-(k-1)
    taken: the logits part by far more than their tolerance."""
    params = ref.make_params(MODEL, 7, "cpu")
    batch = _batch()
    model = dict(MODEL)
    mutated = params
    if mutant == "top_k_minus_1":
        model["moe_top_k"] -= 1
    else:
        moe = dict(params["blocks"]["moe"],
                   w_down=torch.zeros_like(params["blocks"]["moe"]["w_down"]))
        mutated = dict(params, blocks=dict(params["blocks"], moe=moe))
    with torch.no_grad():
        lp, _ = build(_cfg()).logits(params, {"tokens": batch["tokens"][:1]})
        lr = ref.logits(model, mutated, batch["tokens"][0], F32,
                        torch.arange(S))
    gap = (lp[0] - lr).abs() - 1e-5 * lr.abs()
    assert float(gap.max()) > 100 * 1e-6


def _moe_params(E=8, d=32, ff=16, n_shared=2, seed=0):
    g = torch.Generator().manual_seed(seed)
    return L.init_moe(g, d, E, ff, n_shared, "silu", "cpu")


def _moe_cfg(E=8, k=3, held=0, n_shared=2):
    return _cfg(dict(MODEL, moe_num_experts=E, moe_top_k=k,
                     moe_experts_held=held, moe_num_shared=n_shared))


def test_held_shares_sum_to_the_uncut_layer():
    """Eight experts held in four shares of two (each share's experts
    made ``[0, 2)`` by rotating the router's columns): the shares'
    routed parts, with the shared expert counted once, sum to the
    reference's uncut layer; every share reports the same aux loss."""
    E, share = 8, 2
    p = _moe_params(E)
    h = torch.randn(2, 24, 32, generator=torch.Generator().manual_seed(1))
    whole, aux = ref._moe(dict(MODEL, moe_num_experts=E, moe_top_k=3), F32,
                          h, p["router"], p["w_up"], p["w_gate"],
                          p["w_down"], p["shared"]["w_up"],
                          p["shared"]["w_gate"], p["shared"]["w_down"])
    shared = L.mlp(p["shared"], h)
    total = shared.clone()
    for s in range(E // share):
        lo = s * share
        ps = dict(p, router=torch.roll(p["router"], -lo, dims=1),
                  **{k: p[k][lo:lo + share]
                     for k in ("w_up", "w_gate", "w_down")})
        y, a = L.moe_held(ps, h, _moe_cfg(E, held=share))
        total = total + (y - shared)
        torch.testing.assert_close(a, aux, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(total, whole, atol=1e-5, rtol=1e-5)


def test_moe_held_matches_a_per_token_loop():
    """The held layer against a loop over tokens and their top-k, with
    held expert 2 made to receive no token."""
    E, k, held = 8, 3, 4
    p = _moe_params(E)
    p["router"][:, 2] = -1.0          # positive inputs: never chosen
    x = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(2)
                    ).abs()
    y, _ = L.moe_held(dict(p, **{n: p[n][:held] for n in
                                 ("w_up", "w_gate", "w_down")}),
                      x, _moe_cfg(E, k, held))
    xt = x.reshape(-1, 32)
    probs = torch.softmax(xt @ p["router"], dim=-1)
    top, idx = probs.topk(k, dim=-1)
    gates = top / top.sum(-1, keepdim=True)
    assert not (idx == 2).any()
    want = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for j in range(k):
            e = int(idx[t, j])
            if e < held:
                r = xt[t:t + 1]
                o = (F.silu(r @ p["w_gate"][e]) * (r @ p["w_up"][e])) \
                    @ p["w_down"][e]
                want[t] += gates[t, j] * o[0]
    want = want.reshape(x.shape) + L.mlp(p["shared"], x)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)


def test_moe_held_spans_and_counters():
    """With the tracer on: a ``moe_held`` span and its ``.bwd``, and the
    counters of held assignments and the busiest held expert's load
    over the held mean."""
    E, k, held = 8, 3, 4
    p = _moe_params(E)
    p = dict(p, **{n: p[n][:held].requires_grad_(True)
                   for n in ("w_up", "w_gate", "w_down")})
    x0 = torch.randn(2, 12, 32, generator=torch.Generator().manual_seed(3))
    x = x0.requires_grad_(True) * 1.0   # a grad_fn: where the .bwd ends
    probs = torch.softmax(x0.reshape(-1, 32) @ p["router"], dim=-1)
    counts = torch.bincount(probs.topk(k, dim=-1)[1].reshape(-1),
                            minlength=E)[:held]
    tracing.enable()
    try:
        tracing.export()
        y, _ = L.moe_held(p, x, _moe_cfg(E, k, held))
        y.sum().backward()
        got = tracing.export()
    finally:
        tracing.disable()
    names = {s["name"] for s in got["spans"]}
    assert {"moe_held", "moe_held.bwd"} <= names
    counted = {c["name"]: c["value"] for c in got["counts"]}
    assert counted["moe.held_assignments"] == int(counts.sum())
    assert counted["moe.held_load_max"] == pytest.approx(
        float(counts.max()) * held / float(counts.sum()))


def test_prefill_and_decode_match_the_forward():
    """Prefill of S-1 tokens and one decode step through the caches (SSD
    states, conv tails, the attention's KV) reproduce the forward's
    logits at those positions, in float32."""
    cfg = _cfg(attn_chunk_q=64, attn_chunk_k=64)
    api = build(cfg)
    params = ref.make_params(MODEL, 9, "cpu")
    tokens = _batch(5)["tokens"][:, :24]
    with torch.inference_mode():
        full, _ = api.logits(params, {"tokens": tokens})
        cache = api.init_cache(B, 28, torch.float32)
        lp, cache = api.prefill(params, {"tokens": tokens[:, :23]}, cache)
        ld, cache = api.decode_step(params, tokens[:, 23:24], cache)
    torch.testing.assert_close(lp[:, 0], full[:, 22], atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(ld[:, 0], full[:, 23], atol=1e-4, rtol=1e-4)
    assert int(cache["pos"]) == 24


def test_residual_takes_the_multiplier_at_float32():
    """Each residual branch is scaled by 0.22 itself, not by its bfloat16
    rounding (0.2197...), and a float32 stream takes a bfloat16 branch
    into a float32 sum."""
    cfg = _cfg(dtype="bfloat16", residual_dtype="float32")
    x = torch.zeros(2, 3, 8)
    ones = torch.ones(2, 3, 8, dtype=torch.bfloat16)
    got = hybrid._residual(cfg, x, ones)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.full_like(x, 0.22))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 16, generator=g)
    y = torch.randn(4, 16, generator=g).to(torch.bfloat16)
    torch.testing.assert_close(hybrid._residual(cfg, x, y),
                               x + 0.22 * y.float(), atol=0, rtol=1e-6)


def test_a_float32_stream_routes_in_float32_and_computes_in_dtype(
        monkeypatch):
    """``residual_dtype`` float32 under a bfloat16 ``dtype``: the router
    scores the float32 norm, the mixers, the experts and the loss's
    product take bfloat16, and the hidden state leaves in bfloat16."""
    seen = {"route": set(), "mamba": set(), "expert": set()}
    route, mamba, mlp = L._route, L.mamba2_block, L.mlp

    def spy(key, fn, arg):
        def wrapped(*a, **kw):
            seen[key].add(a[arg].dtype)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(L, "_route", spy("route", route, 1))
    monkeypatch.setattr(L, "mamba2_block", spy("mamba", mamba, 1))
    monkeypatch.setattr(L, "mlp", spy("expert", mlp, 1))
    cfg = _cfg(dtype="bfloat16", residual_dtype="float32")
    params = ref.make_params(MODEL, 7, "cpu")
    batch = _batch()
    h, aux, _ = hybrid.hidden(cfg, params, batch)
    assert h.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert seen == {"route": {torch.float32}, "mamba": {torch.bfloat16},
                    "expert": {torch.bfloat16}}
    for t in _leaves(params):
        t.requires_grad_(True)
    loss, _ = build(cfg).loss(params, batch)
    grads = torch.autograd.grad(loss, _leaves(params))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    ours = ref.loss(MODEL, params, batch["tokens"], batch["labels"], F32)
    assert abs(float(loss.detach()) - float(ours.detach())) < 1e-2


def test_prefill_and_decode_match_the_forward_on_a_float32_stream():
    """The decode path takes the same float32 stream: prefill plus one
    decode step in bfloat16 with a bfloat16 cache reproduce the forward
    at the decode tests' bfloat16 tolerance (atol 5e-2, rtol 1e-2)."""
    cfg = _cfg(dtype="bfloat16", residual_dtype="float32", attn_chunk_q=64,
               attn_chunk_k=64)
    api = build(cfg)
    params = ref.make_params(MODEL, 9, "cpu")
    tokens = _batch(5)["tokens"][:, :24]
    with torch.inference_mode():
        full, _ = api.logits(params, {"tokens": tokens})
        cache = api.init_cache(B, 28, torch.bfloat16)
        lp, cache = api.prefill(params, {"tokens": tokens[:, :23]}, cache)
        ld, cache = api.decode_step(params, tokens[:, 23:24], cache)
    torch.testing.assert_close(lp[:, 0], full[:, 22], atol=5e-2, rtol=1e-2)
    torch.testing.assert_close(ld[:, 0], full[:, 23], atol=5e-2, rtol=1e-2)


# ---------------------------------------------------------------------------
# the new fields at their defaults: the same bits as before them
# ---------------------------------------------------------------------------


def _conv_before(w, x):
    """``causal_conv1d`` as it was before the bias (no tail)."""
    k = w.shape[0]
    xp = torch.cat([x.new_zeros((x.shape[0], k - 1, x.shape[2])), x], dim=1)
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]].float() * w[i]
    return F.silu(out).to(x.dtype)


def _mamba2_before(p, x, cfg):
    """``mamba2_block`` as it was before the new fields."""
    B_, S_, _ = x.shape
    H, N, G, P = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_groups, \
        cfg.ssm_head_dim
    z = x @ p["w_z"].to(x.dtype)
    xin = _conv_before(p["conv_x"], x @ p["w_x"].to(x.dtype))
    Bc = _conv_before(p["conv_B"], x @ p["w_B"].to(x.dtype))
    Cc = _conv_before(p["conv_C"], x @ p["w_C"].to(x.dtype))
    dt = F.softplus((x @ p["w_dt"].to(x.dtype)).float() + p["dt_bias"])
    y, _ = L.ssd_chunked(xin.reshape(B_, S_, H, P), dt,
                         -torch.exp(p["A_log"]), Bc.reshape(B_, S_, G, N),
                         Cc.reshape(B_, S_, G, N), p["D"],
                         chunk=cfg.ssm_chunk)
    y = L.rms_norm(p["norm"], y.reshape(B_, S_, cfg.ssm_d_inner)
                   * F.silu(z), cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


def _chunked_loss_before(table, x, labels, chunk, dtype):
    """``chunked_loss`` as it was before the logit scale."""
    Bx, Sx, _ = x.shape
    tot = torch.zeros((), dtype=torch.float32)
    for c in range(Sx // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        lf = (x[:, sl] @ table.t().to(x.dtype)).to(dtype).float()
        gold = lf.gather(-1, labels[:, sl].long()[..., None])[..., 0]
        tot = tot + (torch.logsumexp(lf, dim=-1) - gold).sum()
    return tot / (Bx * Sx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_defaults_leave_mamba2_block_and_chunked_loss_bit_identical(dtype):
    cfg = ModelConfig(name="m", family="ssm", num_layers=1, d_model=64,
                      num_heads=1, num_kv_heads=1, d_ff=0, vocab_size=256,
                      ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
    assert not cfg.ssm_conv_bias and cfg.logits_scaling == 1.0
    g = torch.Generator().manual_seed(4)
    p = L.init_mamba2(g, cfg)
    assert not any(k.endswith("_bias") and k != "dt_bias" for k in p)
    x = torch.randn(2, 40, 64, generator=g).to(dtype)
    assert torch.equal(L.mamba2_block(p, x, cfg), _mamba2_before(p, x, cfg))
    table = torch.randn(256, 64, generator=g) * 0.02
    labels = torch.randint(0, 256, (2, 40), generator=g)
    assert torch.equal(L.chunked_loss(table, x, labels, 8, torch.float32),
                       _chunked_loss_before(table, x, labels, 8,
                                            torch.float32))


# ---------------------------------------------------------------------------
# parameter counts against what init builds
# ---------------------------------------------------------------------------


def _granite_full() -> ModelConfig:
    return _cfg(dict(MODEL, num_layers=10, d_model=4096, num_heads=32,
                     num_kv_heads=8, head_dim=128, vocab_size=100352,
                     moe_num_experts=72, moe_top_k=10, moe_d_ff=768,
                     moe_experts_held=9, ssm_state=128, ssm_head_dim=64),
                ssm_chunk=128)


@pytest.mark.parametrize("which", ["tiny", "full_width", "untied_all_held"])
def test_param_counts_match_init_on_meta(which):
    """``param_counts`` counts the leaves ``hybrid.init`` builds (held
    experts, conv biases, a tied table), on the meta device; at full
    width the 2.415 B parameters of one stage and expert share."""
    cfg = {"tiny": _cfg(), "full_width": _granite_full(),
           "untied_all_held": _cfg(dict(MODEL, tie_embeddings=False,
                                        moe_experts_held=0))}[which]
    params = hybrid.init(cfg, torch.Generator(), device="meta")
    n = sum(t.numel() for t in _leaves(params))
    assert n == cfg.param_counts()["total"] == cfg.num_params()
    assert ("unembed" in params) == (not cfg.tie_embeddings)
    if which == "full_width":
        assert n == 2_414_692_992
        expert = 3 * 4096 * 768
        assert cfg.num_active_params() == round(
            n - 10 * 9 * (72 - 10) / 72 * expert)


def test_hybrid_init_builds_the_references_tree():
    """The port's own init and the reference's draw fill one tree: no
    dense MLP, the held experts, the conv biases, no untied table."""
    def shapes(t):
        return {p: tuple(v.shape) for p, v in tree.leaves(t)}
    port = hybrid.init(_cfg(), torch.Generator().manual_seed(0))
    assert shapes(port) == shapes(ref.make_params(MODEL, 1, "cpu"))
    assert port["blocks"]["moe"]["w_up"].shape[2] == MODEL["moe_experts_held"]
    assert port["blocks"]["moe"]["router"].shape[-1] == \
        MODEL["moe_num_experts"]
    assert math.prod(port["blocks"]["mamba"]["conv_x_bias"].shape[-1:]) == \
        MODEL["ssm_expand"] * MODEL["d_model"]
