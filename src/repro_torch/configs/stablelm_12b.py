"""stablelm-12b [hf:stabilityai/stablelm-2-12b; hf].

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352; head_dim 160
(d_model/H; not MXU-128-aligned — a deliberate roofline stressor, see
EXPERIMENTS.md §Roofline).
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="stablelm-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=13824,
    vocab_size=100352,
    rope_theta=10000.0,
))
