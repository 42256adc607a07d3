"""qwen2-vl-2b — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.  The vision tower
is a STUB per the brief: input_specs supplies precomputed patch embeddings
(vision_embeds + vision_mask) merged into the token stream; M-RoPE rotates
q/k with three position streams (t,h,w) split 24/20/20 over head_dim/2=64.
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen2-vl-2b",
    family="vlm",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    head_dim=128,
    d_ff=8960,
    vocab_size=151936,
    tie_embeddings=True,
    rope_theta=1000000.0,
    mrope_sections=(24, 20, 20),
    frontend="vision_patches",
))
