"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1536 attention-free, vocab 50280, ssm_state=128; expand=2 →
d_inner=3072, head_dim 64 → 48 SSD heads, 1 group, conv4.  Sub-quadratic:
runs the long_500k shape.
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="mamba2-780m",
    family="ssm",
    num_layers=48,
    d_model=1536,
    num_heads=1,           # unused (attention-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=128,
    ssm_conv=4,
    ssm_groups=1,
))
