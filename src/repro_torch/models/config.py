"""Model configuration — one dataclass covering every assigned family.

A copy of ``repro.models.config``, which imports no jax but lives in the
JAX package, which the port never imports.  Families: dense / moe / ssm /
hybrid / encdec / vlm / audio.  A config is a frozen value object;
``repro_torch/configs/<arch>.py`` files instantiate the exact assigned
architectures, and ``reduced()`` derives the CPU-smoke-test variants.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense|moe|ssm|hybrid|encdec|vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    # --- norms / misc ---
    qk_norm: bool = False
    norm: str = "rmsnorm"           # rmsnorm | layernorm (whisper)
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    act: str = "silu"               # silu (SwiGLU) | gelu (plain MLP)
    # muP scalars (granite): embedding × e, each residual branch × r,
    # logits ÷ l, the softmax scale a; the defaults launch nothing
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0
    logits_scaling: float = 1.0
    attention_multiplier: float = 0.0   # 0 → 1/sqrt(hd)
    max_seq: int = 32768            # learned-position table size (encdec)

    # --- rotary ---
    use_rope: bool = True           # jamba: no positional encoding at all
    rope_theta: float = 1e4
    mrope_sections: Tuple[int, ...] = ()   # qwen2-vl M-RoPE (t,h,w) split

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0               # per-expert ffn dim (fine-grained MoE)
    moe_every: int = 1              # MoE on layers where (i % moe_every)==moe_offset
    moe_offset: int = 0
    moe_first_dense: int = 0        # first k layers use a dense MLP
    moe_capacity_factor: float = 1.25
    moe_dispatch: str = "scatter"   # scatter | einsum (reference) | dropless
    moe_experts_held: int = 0       # dropless: this chip holds [0, held); 0 → all

    # --- SSM (Mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    ssm_conv: int = 4
    ssm_groups: int = 1
    ssm_conv_bias: bool = False     # a bias per conv channel, before the SiLU

    # --- hybrid (jamba) ---
    attn_every: int = 0             # attention on layers where (i % attn_every)==attn_offset
    attn_offset: int = 4

    # --- encoder-decoder (whisper) ---
    num_enc_layers: int = 0
    enc_seq: int = 1500             # precomputed-frame count (frontend stub)
    learned_pos: bool = False

    # --- modality frontend stubs ---
    frontend: str = "none"          # none | audio_frames | vision_patches

    # --- numerics / implementation knobs (perf levers, not architecture) ---
    dtype: str = "bfloat16"
    attn_impl: str = "flash_xla"    # flash_xla | naive | flash_pallas
    attn_chunk_q: int = 512
    attn_chunk_k: int = 512
    causal_skip: bool = True        # skip fully-masked k-chunks (triangular sched)
    loss_chunk: int = 0             # 0 = unchunked cross-entropy
    remat: str = "none"             # none | full | dots
    scan_layers: bool = True
    logits_dtype: str = "float32"
    residual_dtype: str = ""        # hybrid: the stream between layers; "" → dtype

    # ------------------------------------------------------------------
    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def held_experts(self) -> int:
        """The routed experts whose weights this device holds."""
        return self.moe_experts_held or self.moe_num_experts

    def is_moe_layer(self, i: int) -> bool:
        if self.moe_num_experts == 0 or i < self.moe_first_dense:
            return False
        return (i % self.moe_every) == self.moe_offset

    def is_attn_layer(self, i: int) -> bool:
        """hybrid: which layers are attention (rest are SSM)."""
        if self.family != "hybrid":
            return self.family != "ssm"
        return (i % self.attn_every) == self.attn_offset

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (SSM / hybrid / linear-attention)."""
        return self.family in ("ssm", "hybrid")

    # -- parameter counting (exact, used for 6·N·D roofline) -------------
    def param_counts(self) -> Dict[str, int]:
        d, hd = self.d_model, self.hd
        H, K, V = self.num_heads, self.num_kv_heads, self.vocab_size
        counts: Dict[str, int] = {"embed": V * d}
        if not self.tie_embeddings:
            counts["unembed"] = V * d
        attn = d * H * hd + 2 * d * K * hd + H * hd * d   # q,k,v,o
        if self.qk_norm:
            attn += 2 * hd
        dense_mlp = 3 * d * self.d_ff if self.act == "silu" else 2 * d * self.d_ff
        moe_ff = self.moe_d_ff or self.d_ff
        expert = 3 * d * moe_ff if self.act == "silu" else 2 * d * moe_ff
        moe_mlp = (self.held_experts * expert
                   + self.moe_num_shared * expert
                   + d * self.moe_num_experts)            # router
        di, N, G = self.ssm_d_inner, self.ssm_state, self.ssm_groups
        nheads = self.ssm_heads if self.ssm_state else 0
        ssm = (d * (2 * di + 2 * G * N + nheads)          # in_proj
               + self.ssm_conv * (di + 2 * G * N)         # depthwise conv
               + self.ssm_conv_bias * (di + 2 * G * N)    # its bias
               + nheads * 2                               # A_log, D
               + nheads                                   # dt_bias
               + di                                       # gated norm
               + di * d) if self.ssm_state else 0         # out_proj

        total_layers = 0
        n_layers = self.num_layers
        per_layer = []
        for i in range(n_layers):
            layer = 2 * d                                  # 2 norms
            if self.family == "ssm":
                layer += ssm
            elif self.family == "hybrid":
                layer += ssm if not self.is_attn_layer(i) else attn
                layer += moe_mlp if self.is_moe_layer(i) else dense_mlp
            else:
                layer += attn
                layer += moe_mlp if self.is_moe_layer(i) else dense_mlp
            per_layer.append(layer)
            total_layers += layer
        if self.num_enc_layers:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.num_enc_layers * (attn + dense_mlp + 2 * d)
            dec_cross = n_layers * (attn + d)
            counts["encoder"] = enc
            counts["cross_attn"] = dec_cross
            total_layers += dec_cross
            counts["enc_total"] = enc
        counts["layers"] = total_layers
        counts["final_norm"] = d
        counts["total"] = sum(v for k, v in counts.items()
                              if k not in ("layers", "enc_total", "encoder",
                                           "cross_attn", "total")) \
            + total_layers + (counts.get("encoder", 0))
        return counts

    def num_params(self) -> int:
        return self.param_counts()["total"]

    def num_active_params(self) -> int:
        """Active per-token params (MoE: top-k + shared only; of held
        experts, the top-k's expected share of them)."""
        if self.moe_num_experts == 0:
            return self.num_params()
        moe_ff = self.moe_d_ff or self.d_ff
        expert = (3 if self.act == "silu" else 2) * self.d_model * moe_ff
        E = self.moe_num_experts
        inactive_experts = self.held_experts * (E - self.moe_top_k) / E
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        return round(self.num_params()
                     - n_moe_layers * inactive_experts * expert)

    # -- reduced config for CPU smoke tests ------------------------------
    def reduced(self) -> "ModelConfig":
        small: Dict[str, object] = dict(
            num_layers=min(self.num_layers, 4 if self.family != "hybrid"
                           else max(self.attn_every, 4)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=256,
            attn_chunk_q=64, attn_chunk_k=64,
            loss_chunk=0,
        )
        if self.mrope_sections:
            # keep 3 sections summing to new head_dim/2
            half = 32 // 2
            small["mrope_sections"] = (half - 2 * (half // 3),
                                       half // 3, half // 3)
        if self.moe_num_experts:
            small.update(moe_num_experts=4, moe_top_k=2,
                         moe_num_shared=min(self.moe_num_shared, 1),
                         moe_d_ff=64 if self.moe_d_ff else 0,
                         moe_first_dense=min(self.moe_first_dense, 1))
        if self.ssm_state:
            small.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.num_enc_layers:
            small.update(num_enc_layers=2, enc_seq=32)
        if self.family == "hybrid":
            small.update(num_layers=8, attn_every=min(self.attn_every, 8))
        return replace(self, **small)

    def override(self, **kwargs) -> "ModelConfig":
        return replace(self, **kwargs)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


# Registry of architecture configs (populated by repro_torch.configs modules).
_ARCH_REGISTRY: Dict[str, ModelConfig] = {}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    if cfg.name in _ARCH_REGISTRY:
        raise ValueError(f"arch {cfg.name!r} already registered")
    _ARCH_REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    # populate lazily so `import repro_torch.models.config` stays cheap
    if not _ARCH_REGISTRY:
        import repro_torch.configs  # noqa: F401  (registers all archs)
    if name not in _ARCH_REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have "
                       f"{sorted(_ARCH_REGISTRY)}")
    return _ARCH_REGISTRY[name]


def list_archs() -> Tuple[str, ...]:
    if not _ARCH_REGISTRY:
        import repro_torch.configs  # noqa: F401
    return tuple(sorted(_ARCH_REGISTRY))
