"""Gradient compression with error feedback: codecs for the cross-node
gradient reduction.

The torch port of ``repro.distributed.compression``.  Where a gradient
all-reduce crosses a slow link (between nodes, over the network rather
than NVLink), compressing what crosses it is one of the standard
large-scale tricks.  Two codecs:

  * bf16: cast before the reduce (2x), error-free in practice for
    gradients feeding a float32 optimizer;
  * int8: per-block symmetric quantization (4x against float32) with
    **error feedback**: the quantization residual is carried into the
    next step's gradient, so the *accumulated* update is unbiased
    (Seide et al. / EF14).

The codecs are plain functions on trees of tensors (``models.tree``),
so a trainer composes them with its reduction: compress, all-reduce,
decompress.  ``torch.round`` rounds half to even, as ``jnp.round``
does, so every value equals the reference's bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import tree

BLOCK = 256


def bf16_compress(grads):
    return tree.map(lambda g: g.to(torch.bfloat16)
                    if g.dtype == torch.float32 else g, grads)


def bf16_decompress(grads):
    return tree.map(lambda g: g.to(torch.float32)
                    if g.dtype == torch.bfloat16 else g, grads)


def _pad_to_block(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % BLOCK
    if pad:
        flat = F.pad(flat, (0, pad))
    return flat.reshape(-1, BLOCK), pad


def int8_quantize(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-block symmetric int8: q = round(x / s), s = max|x| / 127."""
    blocks, pad = _pad_to_block(x.float())
    amax = blocks.abs().amax(dim=1, keepdim=True)
    # a tensor divisor: the card multiplies by a Python scalar divisor's
    # reciprocal, one ulp away from the division jnp and the CPU make
    scale = amax / torch.full_like(amax, 127.0)
    scale = torch.where(scale == 0.0, torch.ones_like(scale), scale)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale,
            "pad": torch.tensor(pad, dtype=torch.int32, device=x.device)}


def int8_dequantize(packed: Dict[str, torch.Tensor], shape,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    flat = (packed["q"].float() * packed["scale"]).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return flat[:n].reshape(tuple(shape)).to(dtype)


def ef_compress_tree(grads, error_state: Optional[Any] = None):
    """Error-feedback int8 compression over a gradient tree.

    Returns ``(packed_tree, new_error_state)``: each leaf's ``{"q",
    "scale", "pad"}`` and the float32 residual carried into the next
    step.  The trainer chooses where the reduction happens (between
    compress and decompress)."""
    if error_state is None:
        error_state = tree.map(lambda g: torch.zeros(
            g.shape, dtype=torch.float32, device=g.device), grads)

    def comp(g, e):
        corrected = g.float() + e
        packed = int8_quantize(corrected)
        decoded = int8_dequantize(packed, g.shape)
        return packed, corrected - decoded      # residual carried forward

    flat_g = tree.flatten(grads)
    flat_e = tree.flatten(error_state)
    packed, errs = zip(*[comp(g, e) for g, e in zip(flat_g, flat_e)]) \
        if flat_g else ((), ())
    return tree.unflatten(grads, packed), tree.unflatten(grads, errs)


def ef_decompress_tree(packed_tree, shapes_tree):
    """The decoded float32 tree: each packed leaf of ``packed_tree`` at
    the shape of the matching leaf of ``shapes_tree``."""
    flat_s = tree.flatten(shapes_tree)
    out = [int8_dequantize(p, s.shape)
           for p, s in zip(packed_leaves(packed_tree), flat_s)]
    return tree.unflatten(shapes_tree, out)


def packed_leaves(node) -> list:
    """The ``{"q", "scale", "pad"}`` leaves of a packed tree, in
    ``tree.map``'s order."""
    if isinstance(node, dict) and "q" in node:
        return [node]
    if isinstance(node, dict):
        return [p for v in node.values() for p in packed_leaves(v)]
    if isinstance(node, tuple):
        return [p for v in node for p in packed_leaves(v)]
    raise TypeError(f"not a packed leaf: {type(node).__name__}")
