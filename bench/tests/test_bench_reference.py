"""The plain references against the port at a tiny size, on the CPU:
the same weights (drawn by the benchmark) in the port's tree, the port
computing in float32."""
import pytest
import torch

from conftest import tiny_config
from bench.lib import spec, traffic
from bench.reference.common import Numerics, get_path


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_weights_fill_the_ports_tree(ref):
    from repro_torch.models import build
    conf = tiny_config(ref)
    port = build(spec.model_config(conf)).init(
        torch.Generator().manual_seed(0))
    ours = spec.reference(conf).make_params(conf["model"], 5, "cpu")
    assert _shapes(ours) == _shapes(port)


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_weights_repeat_for_a_seed(ref):
    conf = tiny_config(ref)
    mod = spec.reference(conf)
    a = mod.make_params(conf["model"], 2 ** 33 + 1, "cpu")
    b = mod.make_params(conf["model"], 2 ** 33 + 1, "cpu")
    c = mod.make_params(conf["model"], 2 ** 33 + 2, "cpu")
    for path in _shapes(a):
        assert torch.equal(get_path(a, path), get_path(b, path))
    w = "blocks.mlp.w_up" if ref == "dense" else "blocks.mamba.w_x"
    assert not torch.equal(get_path(a, w), get_path(c, w))


@pytest.mark.parametrize("ref", ["dense", "mamba2"])
def test_reference_loss_matches_the_port_in_float32(ref):
    from repro_torch.models import build
    conf = tiny_config(ref, dtype="float32", remat="none")
    m, mod = conf["model"], spec.reference(conf)
    params = mod.make_params(m, 11, "cpu")
    tr = {"kind": "train", "batch": 2, "seq_len": 64, "mean_doc_len": 16,
          "eos_id": 0, "zipf_a": 1.3, "markov_states": 8}
    batch = traffic.train_feed(tr, m["vocab_size"], 3, "cpu")(0)
    api = build(spec.model_config(conf))
    port, _ = api.loss(params, batch)
    ours = mod.loss(m, params, batch["tokens"], batch["labels"],
                    Numerics("float32"))
    assert abs(float(port) - float(ours)) < 2e-5


def test_dense_logits_match_the_ports_forward():
    from repro_torch.models import build
    conf = tiny_config("dense", dtype="float32")
    m, mod = conf["model"], spec.reference(conf)
    params = mod.make_params(m, 4, "cpu")
    toks = torch.randint(1, m["vocab_size"], (64,),
                         generator=torch.Generator().manual_seed(1))
    port, _ = build(spec.model_config(conf)).logits(params,
                                                    {"tokens": toks[None]})
    pos = torch.arange(64)
    ours = mod.logits(m, params, toks, Numerics("float32"), pos)
    assert torch.allclose(port[0], ours, atol=2e-5, rtol=1e-5)


def test_ssd_chunking_changes_no_result():
    from bench.reference import mamba2
    g = torch.Generator().manual_seed(0)
    b, l, h, p, n = 2, 128, 3, 4, 8
    X = torch.randn(b, l, h, p, generator=g, dtype=torch.float64)
    A = -torch.rand(b, l, h, generator=g, dtype=torch.float64)
    B = torch.randn(b, l, n, generator=g, dtype=torch.float64)
    C = torch.randn(b, l, n, generator=g, dtype=torch.float64)
    nm = Numerics("float32")
    y16 = mamba2.ssd(X, A, B, C, nm, chunk=16)
    y64 = mamba2.ssd(X, A, B, C, nm, chunk=64)
    # the recurrence, step by step
    hs = torch.zeros(b, h, p, n, dtype=torch.float64)
    ys = []
    for t in range(l):
        hs = hs * torch.exp(A[:, t])[..., None, None] + \
            X[:, t][..., None] * B[:, t][:, None, None, :]
        ys.append(torch.einsum("bhpn,bn->bhp", hs, C[:, t]))
    y = torch.stack(ys, 1)
    assert torch.allclose(y16, y, atol=1e-10)
    assert torch.allclose(y64, y, atol=1e-10)
