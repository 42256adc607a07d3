"""moonshot-v1-16b-a3b (kimi/moonlight) [hf:moonshotai/Moonlight-16B-A3B; hf].

48L d_model=2048 16H (GQA kv=16) vocab=163840; MoE: 64 routed experts,
top-6, per-expert d_ff=1408 (fine-grained).  The brief lists exactly these
figures; every layer is MoE (no shared experts are listed, so none are
instantiated — deviation from upstream Moonlight's 2 shared experts is
noted in DESIGN.md).
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    moe_num_experts=64,
    moe_top_k=6,
    moe_num_shared=0,
    moe_d_ff=1408,
    rope_theta=50000.0,
))
