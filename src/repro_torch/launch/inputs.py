"""Assigned input shapes and stand-ins for every model input.

The torch port of ``repro.launch.inputs``.  The four LM shapes of the
dry-run; ``kind`` selects which step is traced:

  * train   → train_step(state, batch)
  * prefill → prefill(params, batch, cache)
  * decode  → decode_step(params, tokens, cache)   (one token, full cache)

The reference's ``jax.ShapeDtypeStruct`` stand-ins become tensors on the
``meta`` device: a shape and a dtype, and no storage, so a full-size
configuration never allocates.  The dtypes are the reference's: int32
tokens, labels and positions, bool masks, float32 frames and vision
embeddings.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.models.config import ModelConfig


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: str) -> Tuple[bool, str]:
    """long_500k only for sub-quadratic families (brief-mandated skip)."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, ("long_500k skipped: pure full-attention architecture "
                       "(quadratic prefill at 524k); run only for "
                       "SSM/hybrid per the brief")
    return True, ""


def _struct(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_batch_structs(cfg: ModelConfig, batch: int, seq: int,
                        with_labels: bool) -> Dict[str, torch.Tensor]:
    i32 = torch.int32
    out: Dict[str, torch.Tensor] = {"tokens": _struct((batch, seq), i32)}
    if with_labels:
        out["labels"] = _struct((batch, seq), i32)
    if cfg.family == "vlm":
        out["vision_embeds"] = _struct((batch, seq, cfg.d_model),
                                       torch.float32)
        out["vision_mask"] = _struct((batch, seq), torch.bool)
        out["positions"] = _struct((3, batch, seq), i32)
    if cfg.family in ("audio", "encdec"):
        out["frames"] = _struct((batch, cfg.enc_seq, cfg.d_model),
                                torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape_name: str
                ) -> Dict[str, torch.Tensor]:
    """Stand-ins for the *batch* of the given shape (train/prefill
    kinds); for decode, the ``[B, 1]`` tokens (the cache is built
    separately)."""
    sh = SHAPES[shape_name]
    if sh.kind == "train":
        return token_batch_structs(cfg, sh.global_batch, sh.seq_len,
                                   with_labels=True)
    if sh.kind == "prefill":
        return token_batch_structs(cfg, sh.global_batch, sh.seq_len,
                                   with_labels=False)
    return {"tokens": _struct((sh.global_batch, 1), torch.int32)}


def cache_structs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """The port's ``init_cache`` for the shape, on ``meta`` (no
    allocation)."""
    from repro_torch.models.api import build
    sh = SHAPES[shape_name]
    return build(cfg).init_cache(sh.global_batch, sh.seq_len, device="meta")


def concrete_batch(cfg: ModelConfig, shape_name: str,
                   gen: Optional[torch.Generator] = None,
                   batch_override: Optional[int] = None,
                   seq_override: Optional[int] = None
                   ) -> Dict[str, torch.Tensor]:
    """A small concrete batch (CPU-size smoke tests, examples) from
    ``gen`` (default: a CPU generator seeded 0), on its device.  Tokens
    are uniform in ``[0, V)``, masks false, floats normal × 0.02,
    M-RoPE positions the text positions on all three streams."""
    if gen is None:
        gen = torch.Generator().manual_seed(0)
    sh = SHAPES[shape_name]
    B = batch_override or sh.global_batch
    S = seq_override or sh.seq_len
    structs = token_batch_structs(cfg, B, S, with_labels=(sh.kind == "train"))

    def make(s: torch.Tensor) -> torch.Tensor:
        if s.dtype == torch.int32:
            return torch.randint(0, cfg.vocab_size, s.shape, generator=gen,
                                 dtype=s.dtype, device=gen.device)
        if s.dtype == torch.bool:
            return torch.zeros(s.shape, dtype=s.dtype, device=gen.device)
        return torch.randn(s.shape, generator=gen, dtype=s.dtype,
                           device=gen.device) * 0.02

    out = {name: make(s) for name, s in sorted(structs.items())}
    if "positions" in out:
        B_, S_ = out["tokens"].shape
        out["positions"] = torch.arange(
            S_, dtype=torch.int32, device=gen.device)[None, None].expand(
                3, B_, S_).contiguous()
    return out
