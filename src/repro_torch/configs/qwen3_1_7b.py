"""qwen3-1.7b — qk_norm, GQA [hf:Qwen/Qwen3-8B; hf].

28L d_model=2048 16H (GQA kv=8) d_ff=6144 vocab=151936; qk-norm on,
head_dim 128 (qwen3 keeps 128 regardless of d_model/H), tied embeddings.
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab_size=151936,
    qk_norm=True,
    tie_embeddings=True,
    rope_theta=1000000.0,
))
