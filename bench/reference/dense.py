"""Plain reference of a dense decoder (InternLM2's equations), float32.

Pre-norm blocks: RMSNorm, grouped-query attention with rotary
embeddings (no biases), a residual; RMSNorm, a SwiGLU MLP
(``(silu(h Wg) * (h Wu)) Wd``), a residual; a final RMSNorm and an
untied (or tied) output table.  The loss is the mean next-token NLL
over every position of the batch, against the labels given.

The weights' layout is the program's tree (each layer's tensors stacked
on a leading axis); their values come from the seed here.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .common import (LeafSpec, Numerics, causal_attention, checkpointed,
                     make_tree, mean_nll, output_table, rms_norm, rope)


def leaves(m: Dict[str, Any]) -> List[LeafSpec]:
    """Every leaf of the tree, its shape and its init: normal weights
    of std 1/sqrt(fan_in), an embedding of std 0.02, norms of ones."""
    L, d, V = m["num_layers"], m["d_model"], m["vocab_size"]
    H, K, hd, ff = m["num_heads"], m["num_kv_heads"], m["head_dim"], m["d_ff"]

    def w(fan_in):
        return ("normal", 1.0 / math.sqrt(fan_in))
    out: List[LeafSpec] = [
        ("embed.table", (V, d), ("normal", 0.02)),
        ("blocks.ln1.scale", (L, d), ("ones",)),
        ("blocks.ln2.scale", (L, d), ("ones",)),
        ("blocks.attn.wq", (L, d, H * hd), w(d)),
        ("blocks.attn.wk", (L, d, K * hd), w(d)),
        ("blocks.attn.wv", (L, d, K * hd), w(d)),
        ("blocks.attn.wo", (L, H * hd, d), w(H * hd)),
        ("blocks.mlp.w_up", (L, d, ff), w(d)),
        ("blocks.mlp.w_down", (L, ff, d), w(ff)),
        ("blocks.mlp.w_gate", (L, d, ff), w(d)),
        ("final_norm.scale", (d,), ("ones",)),
    ]
    if not m.get("tie_embeddings", False):
        out.append(("unembed.table", (V, d), ("normal", 0.02)))
    return out


#: The drawn values are the initial ones.
post_init = None


def make_params(m: Dict[str, Any], seed: int, device) -> Dict[str, Any]:
    return make_tree(leaves(m), seed, device)


def _block(m, nm: Numerics, x, ln1, ln2, wq, wk, wv, wo, wu, wd, wg):
    B, S, d = x.shape
    H, K, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    eps = m["norm_eps"]
    h = rms_norm(x, ln1, eps)
    q = rope(nm.mm(h, wq).view(B, S, H, hd), m["rope_theta"])
    k = rope(nm.mm(h, wk).view(B, S, K, hd), m["rope_theta"])
    v = nm.mm(h, wv).view(B, S, K, hd)
    o = torch.stack([checkpointed(
        lambda a, b, c: causal_attention(a, b, c, nm), q[i], k[i], v[i])
        for i in range(B)])
    x = x + nm.mm(o.reshape(B, S, H * hd), wo)
    h = rms_norm(x, ln2, eps)
    return x + nm.mm(F.silu(nm.mm(h, wg)) * nm.mm(h, wu), wd)


def hidden(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
           nm: Numerics) -> torch.Tensor:
    """The final normed hidden state [B, S, d] of ``tokens``; each layer
    is recomputed in the backward."""
    x = p["embed"]["table"][tokens.long()]
    b = p["blocks"]
    for i in range(m["num_layers"]):
        x = checkpointed(
            lambda x_, *w: _block(m, nm, x_, *w), x,
            b["ln1"]["scale"][i], b["ln2"]["scale"][i],
            b["attn"]["wq"][i], b["attn"]["wk"][i], b["attn"]["wv"][i],
            b["attn"]["wo"][i], b["mlp"]["w_up"][i], b["mlp"]["w_down"][i],
            b["mlp"]["w_gate"][i])
    return rms_norm(x, p["final_norm"]["scale"], m["norm_eps"])


def loss(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
         labels: torch.Tensor, nm: Numerics) -> torch.Tensor:
    """Mean next-token NLL over every position of the batch."""
    return mean_nll(hidden(m, p, tokens, nm), output_table(p), labels, nm)


def logits(m: Dict[str, Any], p: Dict[str, Any], tokens: torch.Tensor,
           nm: Numerics, positions: torch.Tensor) -> torch.Tensor:
    """Logits [len(positions), V] of one sequence ``tokens [S]`` at the
    given positions."""
    h = hidden(m, p, tokens[None], nm)[0]
    return nm.mm(h[positions], output_table(p).t())


def train_flops(m: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6·N·tokens, N the parameters
    less an untied input embedding (a lookup), plus causal attention's
    two products, forward and backward (3 × 2·B·S²·H·hd a layer).
    Recomputation is not counted."""
    n = sum(math.prod(shape) for _, shape, _ in leaves(m))
    if not m.get("tie_embeddings", False):
        n -= m["vocab_size"] * m["d_model"]
    attn = 3 * 2 * batch * seq * seq * m["num_heads"] * m["head_dim"]
    return 6.0 * n * batch * seq + attn * m["num_layers"]


def weight_bytes(m: Dict[str, Any], itemsize: int = 2) -> int:
    """Bytes of every weight a decode step reads, once, at ``itemsize``
    bytes a value (an untied input embedding is read a row a token, and
    is not counted)."""
    n = sum(math.prod(shape) for _, shape, _ in leaves(m))
    if not m.get("tie_embeddings", False):
        n -= m["vocab_size"] * m["d_model"]
    return n * itemsize


def kv_bytes_per_token(m: Dict[str, Any], itemsize: int = 2) -> int:
    """Bytes of keys and values one cached position holds over all
    layers."""
    return 2 * m["num_layers"] * m["num_kv_heads"] * m["head_dim"] * itemsize
