"""whisper-small — enc-dec, conv frontend (stub) [arXiv:2212.04356; unverified].

12L d_model=768 12H (kv=12, MHA) d_ff=3072 vocab=51865.  12 encoder +
12 decoder layers; LayerNorm + GELU, learned decoder positions, sinusoidal
encoder positions.  The mel/conv frontend is a STUB: input_specs supplies
precomputed frame embeddings [B, 1500, d].  Attention biases of the
upstream checkpoint are omitted (systems-level reproduction; noted in
DESIGN.md).
"""
from repro_torch.models.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    num_enc_layers=12,
    enc_seq=1500,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    tie_embeddings=True,
    use_rope=False,
    learned_pos=True,
    norm="layernorm",
    act="gelu",
    norm_eps=1e-5,
    frontend="audio_frames",
    max_seq=32768,
))
