"""Model/architecture configuration schema.

One frozen dataclass describes every architecture of the LM substrate —
dense, MoE, SSM, hybrid, VLM, audio enc-dec — plus the reduced "smoke"
variants the CPU tests use. A copy of ``repro.configs.base`` (which
imports JAX at module level), with the same fields and defaults; the
parameter counts walk the port's own `repro_torch.models.params`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 → d_model // num_heads

    # attention
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: int = 0                 # >0: sliding-window attention
    global_layers: Tuple[int, ...] = ()  # SWA archs: layers with full attention
    attention_free: bool = False    # rwkv6

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_every: int = 1              # every k-th layer is MoE
    shared_expert: bool = False

    # SSM / hybrid (mamba-in-parallel-with-attention = hymba)
    ssm_state: int = 0
    ssm_expand: int = 1
    ssm_conv: int = 4
    ssm_dt_rank: int = 0            # 0 → ceil(d_model / 16)
    hybrid_ssm: bool = False        # parallel attn + SSM heads per layer

    # rwkv6
    rwkv: bool = False
    rwkv_head_dim: int = 64
    rwkv_decay_lora: int = 64

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    decoder_layers: int = 0         # if 0 and encoder_layers>0 → num_layers
    cross_attention: bool = False
    max_source_len: int = 4096      # encoder length for serve-time specs

    # modality frontend stubs
    frontend: str = "none"          # none | patches | frames
    num_prefix_embeds: int = 0      # patch/frame embeddings per example

    # MLP
    mlp_act: str = "swiglu"         # swiglu | gelu
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    # numerics
    dtype: str = "bfloat16"
    #: keep attention logits/softmax in f32 (True = faithful default)
    attn_f32_logits: bool = True
    # sub-quadratic decode support (ssm / hybrid / linear-attn): long_500k runs
    subquadratic: bool = False

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.ssm_dt_rank == 0 and (self.ssm_state > 0):
            object.__setattr__(self, "ssm_dt_rank", -(-self.d_model // 16))
        if self.encoder_layers > 0 and self.decoder_layers == 0:
            object.__setattr__(self, "decoder_layers", self.num_layers)

    # convenience ----------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def is_moe_layer(self):
        def f(i: int) -> bool:
            return self.num_experts > 0 and ((i + 1) % self.moe_every == 0)
        return f

    def param_count(self) -> int:
        """Approximate parameter count N (reported, and used for 6·N·D)."""
        from repro_torch.models.params import param_count
        return param_count(self)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed experts count)."""
        from repro_torch.models.params import param_count
        return param_count(self, active=True)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests."""
    return dataclasses.replace(
        cfg,
        num_layers=max(2, min(cfg.num_layers, 2 if cfg.encoder_layers == 0 else 2)),
        encoder_layers=min(cfg.encoder_layers, 2),
        decoder_layers=min(cfg.decoder_layers, 2) if cfg.encoder_layers else 0,
        d_model=128,
        num_heads=4,
        num_kv_heads=max(1, min(cfg.num_kv_heads, 2)) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        window=min(cfg.window, 32) if cfg.window else 0,
        global_layers=tuple(i for i in cfg.global_layers if i < 2),
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_dt_rank=8 if cfg.ssm_state else 0,
        rwkv_head_dim=32 if cfg.rwkv else 64,
        rwkv_decay_lora=16 if cfg.rwkv else 64,
        num_prefix_embeds=min(cfg.num_prefix_embeds, 8),
        max_source_len=64 if cfg.encoder_layers else 4096,
        dtype="float32",
    )
