"""Architecture registry: the published configs of the LM substrate.

A copy of ``repro.configs.registry``: the same ten configs, sources in
brackets. :func:`get_config` resolves an architecture id,
:func:`get_smoke_config` its reduced CPU variant.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig, smoke_variant

# [arXiv:2411.13676; hf] — hybrid: parallel attn+mamba heads, SWA everywhere
# except 3 global-attention layers (first/middle/last per the Hymba paper).
HYMBA_1_5B = ModelConfig(
    name="hymba-1.5b", family="hybrid",
    num_layers=32, d_model=1600, num_heads=25, num_kv_heads=5,
    d_ff=5504, vocab_size=32001, head_dim=64,
    window=1024, global_layers=(0, 15, 31),
    hybrid_ssm=True, ssm_state=16, ssm_expand=2,
    subquadratic=True,
)

# [hf:Qwen/Qwen1.5-0.5B; hf] — dense, QKV bias.
QWEN15_0_5B = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=2816, vocab_size=151936, qkv_bias=True,
)

# [arXiv:2401.02385; hf] — llama2-arch small.
TINYLLAMA_1_1B = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    num_layers=22, d_model=2048, num_heads=32, num_kv_heads=4,
    d_ff=5632, vocab_size=32000,
)

# [arXiv:2402.19173; hf] — GQA kv=4, RoPE.
STARCODER2_15B = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4,
    d_ff=24576, vocab_size=49152, mlp_act="gelu",
)

# [arXiv:2404.14219; unverified] — RoPE SwiGLU, kv=32 ⇒ MHA-equivalent.
PHI3_MINI_3_8B = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
)

# [arXiv:2404.05892; hf] — Finch: attention-free, data-dependent decay.
RWKV6_3B = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560, num_heads=40, num_kv_heads=40,
    d_ff=8960, vocab_size=65536,
    attention_free=True, rwkv=True, rwkv_head_dim=64,
    subquadratic=True,
)

# [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified] — Mistral-7B backbone,
# anyres patch embeddings via stub frontend (2880 image tokens).
LLAVA_NEXT_MISTRAL_7B = ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    frontend="patches", num_prefix_embeds=2880,
)

# [hf:meta-llama/Llama-4-Scout-17B-16E; unverified] — MoE 128e top-1 +
# shared expert, interleaved every other layer, early fusion (stub frontend).
LLAMA4_MAVERICK_400B = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048,
    num_experts=128, experts_per_token=1, moe_every=2, shared_expert=True,
    frontend="patches", num_prefix_embeds=0,  # early-fusion stub, text cells
)

# [hf:xai-org/grok-1; unverified] — all layers MoE, 8 experts top-2.
# Gated (3-matrix) expert FFN: with d_ff=32768 this yields ≈316B params,
# matching the published 314B within 1% (a 2-matrix GeLU FFN would be 214B).
GROK1_314B = ModelConfig(
    name="grok-1-314b", family="moe",
    num_layers=64, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=32768, vocab_size=131072,
    num_experts=8, experts_per_token=2, moe_every=1, mlp_act="swiglu",
)

# [arXiv:2212.04356; unverified] — enc-dec; conv frontend STUBBED: input_specs
# provides precomputed frame embeddings.
WHISPER_SMALL = ModelConfig(
    name="whisper-small", family="audio",
    num_layers=12, d_model=768, num_heads=12, num_kv_heads=12,
    d_ff=3072, vocab_size=51865, mlp_act="gelu",
    encoder_layers=12, decoder_layers=12, cross_attention=True,
    frontend="frames", rope_theta=10000.0,
)

ARCHS = {
    c.name: c for c in (
        HYMBA_1_5B, QWEN15_0_5B, TINYLLAMA_1_1B, STARCODER2_15B,
        PHI3_MINI_3_8B, RWKV6_3B, LLAVA_NEXT_MISTRAL_7B,
        LLAMA4_MAVERICK_400B, GROK1_314B, WHISPER_SMALL,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_smoke_config(name: str) -> ModelConfig:
    return smoke_variant(get_config(name))
