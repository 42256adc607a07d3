"""jamba-v0.1-52b — Mamba+attention 1:7 interleave, MoE [arXiv:2403.19887; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536; MoE 16 experts
top-2 on every other layer.  Period-8 superblocks: attention at block
index 4, Mamba elsewhere (1:7); no positional encoding (use_rope=False).
Jamba v0.1 uses Mamba-1 layers; we implement the Mamba-2/SSD block (same
state budget: ssm_state=16, d_inner=2*d, conv4) — deviation recorded in
DESIGN.md.  Sub-quadratic: runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=65536,
    use_rope=False,
    moe_num_experts=16,
    moe_top_k=2,
    moe_every=2,
    moe_offset=1,
    moe_d_ff=14336,
    attn_every=8,
    attn_offset=4,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv=4,
    ssm_groups=1,
))
