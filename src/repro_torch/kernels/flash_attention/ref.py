"""Plain PyTorch version of the flash-attention kernel: the port's
``naive_attention`` (the reference's oracle,
``repro.kernels.flash_attention.ref``), whose causal mask ``k_pos <=
q_pos`` counts both positions from 0 — the Pallas kernel's convention."""
from ...models.layers import naive_attention as flash_attention_ref

__all__ = ["flash_attention_ref"]
