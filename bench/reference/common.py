"""Plain PyTorch pieces the references share, in float32.

Nothing here imports the program: the references are written from the
published equations, and they make their own weights from the seed, in
the layout of the program's parameter tree (nested dicts, each layer's
tensors stacked on a leading axis), so that the benchmark can hand the
same weights to both.

``Numerics`` says in what precision a reference takes its products:
``float32`` (the reference; TF32 must be off, see :func:`strict_float32`)
or ``float8_e4m3`` for the control, whose operands are rounded to it
first, with a scale a tensor.  Everything else stays in float32.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Tuple

import torch

Tree = Dict[str, Any]
#: (path, shape, init) of every leaf, in a fixed order; ``init`` is
#: ``("normal", std)``, ``("uniform", lo, hi)``, ``("ones",)``,
#: ``("zeros",)`` or a name the family module resolves.
LeafSpec = Tuple[str, Tuple[int, ...], Tuple[Any, ...]]


@contextmanager
def strict_float32() -> Iterator[None]:
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


class Numerics:
    """The precision of a reference's products."""

    MODES = ("float32", "float8_e4m3")

    def __init__(self, mode: str = "float32"):
        if mode not in self.MODES:
            raise ValueError(f"unknown numerics {mode!r}; have {self.MODES}")
        self.mode = mode

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` rounded to the product precision (its gradient passes
        straight through)."""
        if self.mode == "float32":
            return x
        with torch.no_grad():
            scale = 448.0 / x.abs().amax().clamp(min=1e-30)
            r = (x * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x).detach()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.q(a) @ self.q(b)

    def einsum(self, eq: str, *xs: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *(self.q(x) for x in xs))


# ---------------------------------------------------------------------------
# weights from the seed
# ---------------------------------------------------------------------------


def leaf_seed(seed: int, index: int) -> int:
    """The generator seed of leaf ``index``: any whole ``seed`` (the
    benchmark's may pass 32 bits) mixed with the leaf's place."""
    return (int(seed) * 1_000_003 + 7919 * (index + 1)) % (2 ** 63)


def make_leaf(spec: LeafSpec, seed: int, index: int, device,
              dtype=torch.float32) -> torch.Tensor:
    """One leaf, drawn on ``device`` in one call from its own generator,
    so that it can be drawn again alone."""
    _path, shape, init = spec
    kind = init[0]
    if kind == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, index))
    if kind == "normal":
        t = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * init[1]
    elif kind == "uniform":
        lo, hi = init[1], init[2]
        t = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device) * (hi - lo) + lo
    elif kind == "log_uniform":      # exp(U(log lo, log hi))
        lo, hi = math.log(init[1]), math.log(init[2])
        t = torch.exp(torch.rand(shape, generator=gen, dtype=torch.float32,
                                 device=device) * (hi - lo) + lo)
    else:
        raise ValueError(f"unknown init {init!r}")
    return t.to(dtype)


def set_path(tree: Tree, path: str, value) -> None:
    keys = path.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def get_path(tree: Tree, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def make_tree(leaves: List[LeafSpec], seed: int, device,
              post: Callable[[str, torch.Tensor], torch.Tensor] = None
              ) -> Tree:
    """The whole parameter tree, a leaf a call."""
    tree: Tree = {}
    for i, spec in enumerate(leaves):
        t = make_leaf(spec, seed, i, device)
        set_path(tree, spec[0], post(spec[0], t) if post else t)
    return tree


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [B, S, heads, hd]`` at positions 0..S-1,
    the two halves of each head rotated together (GPT-NeoX's layout,
    which InternLM2 uses)."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64,
                                       device=x.device) / hd)
    ang = (torch.arange(S, dtype=torch.float64, device=x.device)[:, None]
           * inv[None]).float()
    cos, sin = ang.cos()[None, :, None], ang.sin()[None, :, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     nm: Numerics) -> torch.Tensor:
    """Softmax attention of one sequence: q [S, H, hd], k/v [S, K, hd]
    (head h reads kv head h // (H/K)); causal."""
    S, H, hd = q.shape
    rep = H // k.shape[1]
    kr = k.repeat_interleave(rep, dim=1)
    vr = v.repeat_interleave(rep, dim=1)
    s = nm.einsum("qhd,khd->hqk", q, kr) / math.sqrt(hd)
    keep = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, float("-inf")), dim=-1)
    return nm.einsum("hqk,khd->qhd", p, vr)


def token_nll_sum(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                  nm: Numerics) -> torch.Tensor:
    """Sum over the rows of h [T, d] of the next-token NLL under the
    logits ``h @ table.T``."""
    logits = nm.mm(h, table.t())
    return (torch.logsumexp(logits, -1)
            - logits.gather(-1, labels[:, None])[:, 0]).sum()


def mean_nll(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
             nm: Numerics, chunk: int = 1024) -> torch.Tensor:
    """Mean next-token NLL over every position of h [B, S, d], the
    logits made a chunk of ``chunk`` positions of one row at a time."""
    B, S, _ = h.shape
    tot = h.new_zeros(())
    for b in range(B):
        for s in range(0, S, chunk):
            tot = tot + checkpointed(
                lambda h_, t_, y_: token_nll_sum(h_, t_, y_, nm),
                h[b, s:s + chunk], table, labels[b, s:s + chunk].long())
    return tot / (B * S)


def output_table(p: Tree) -> torch.Tensor:
    return (p.get("unembed") or p["embed"])["table"]


def checkpointed(fn: Callable, *args):
    """``fn(*args)``, its activations recomputed in the backward."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


# ---------------------------------------------------------------------------
# AdamW with a warmup-cosine schedule and global-norm clipping
# ---------------------------------------------------------------------------


def learning_rate(opt: Dict[str, float], t: int) -> float:
    """The rate of step ``t`` (1 for the first): a linear warmup to
    ``lr`` over ``warmup_steps``, then a cosine to ``lr·min_lr_ratio``
    at ``total_steps``."""
    lr, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if t < warm:
        return lr * t / max(warm, 1)
    prog = min(max((t - warm) / max(total - warm, 1), 0.0), 1.0)
    r = opt["min_lr_ratio"]
    return lr * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def adamw_step(opt: Dict[str, float], t: int, params: List[torch.Tensor],
               grads: List[torch.Tensor], m: List[torch.Tensor],
               v: List[torch.Tensor]) -> Tuple[List[torch.Tensor], float]:
    """Clip the gradients to a global norm of ``grad_clip``, then one
    AdamW step on every leaf in place; weight decay on leaves of two or
    more dimensions as stored.  Returns the clipped gradients and the
    norm before clipping."""
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads))
    scale = min(1.0, opt["grad_clip"] / max(norm, 1e-9))
    lr = learning_rate(opt, t)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    clipped = []
    with torch.no_grad():
        for p, g, mi, vi in zip(params, grads, m, v):
            g = g * scale
            clipped.append(g)
            mi.mul_(b1).add_(g, alpha=1 - b1)
            vi.mul_(b2).addcmul_(g, g, value=1 - b2)
            upd = (mi / (1 - b1 ** t)) / ((vi / (1 - b2 ** t)).sqrt() + eps)
            if p.ndim >= 2:
                upd = upd + wd * p
            p.sub_(lr * upd)
    return clipped, norm
