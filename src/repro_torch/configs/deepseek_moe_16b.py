"""deepseek-moe-16b — fine-grained MoE [arXiv:2401.06066; hf].

28L d_model=2048 16H (GQA kv=16) vocab=102400; 2 shared + 64 routed
experts, top-6, per-expert d_ff=1408 (fine-grained expert segmentation).
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102400,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=2,
    moe_d_ff=1408,
    rope_theta=10000.0,
))
