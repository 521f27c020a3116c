"""Model assembly for the dense family: full forward, prefill and cached
decode.

The port of ``repro.models.transformer`` for the architectures made of
attention and MLP layers alone: tinyllama, qwen1.5 (QKV bias), phi3 (MHA),
starcoder2 (GELU MLP) and llava-next's Mistral backbone with its
prefix-embedding adapter. Every attention runs the port's attention kernel
(`repro_torch.models.layers.attend`). The other families raise
`NotImplementedError` naming the ROADMAP item that ports them.

Paths:
  * ``forward_logits`` — full-sequence logits, the reference the cache is
    checked against.
  * ``prefill``        — a prompt's last-token logits and its KV cache, in
    the reference's ring layout (slot = position mod W).
  * ``decode_step``    — one token per sequence against the cache.

Unlike the reference, whose arrays are immutable, ``decode_step`` writes
the new token's K/V into the cache's tensors in place (a serving cache is
too large to copy every step) and returns the cache with ``pos`` advanced;
``pos`` is a host integer, so no step waits on the device for it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as LY

#: families that wait for later slices, with the ROADMAP item (queue 1)
#: that ports them
_LATER = (
    (lambda c: c.num_experts > 0, "MoE layers (grok-1, llama4)", 15),
    (lambda c: c.rwkv, "RWKV6 time and channel mixing", 17),
    (lambda c: c.hybrid_ssm or c.family == "ssm",
     "Mamba / hybrid SSM layers (hymba)", 16),
    (lambda c: c.encoder_layers > 0 or c.cross_attention,
     "the whisper encoder-decoder", 18),
)


def _require_dense(cfg: ModelConfig) -> None:
    for test, what, item in _LATER:
        if test(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet (ROADMAP queue 1 "
                f"item {item}); the port serves the dense family")
    if not cache_is_uniform(cfg):
        raise NotImplementedError(
            f"{cfg.name}: layers with different windows need per-layer ring "
            f"caches (ROADMAP queue 1 item 16)")


# ----------------------------------------------------------------------------
# per-layer metadata (per-layer window values for SWA archs)
# ----------------------------------------------------------------------------

def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """window per layer: 0 ⇒ full attention; >0 ⇒ SWA width."""
    L = cfg.num_layers if cfg.encoder_layers == 0 else cfg.decoder_layers
    if cfg.num_experts > 0 and cfg.moe_every == 2:
        L = cfg.num_layers // 2
    w = np.full((L,), cfg.window, np.int32)
    for g in cfg.global_layers:
        if g < L:
            w[g] = 0
    return w


def cache_is_uniform(cfg: ModelConfig) -> bool:
    """True when every layer's cache has identical shapes (⇒ stackable).

    Only per-layer window heterogeneity (hymba's 3 global-attention layers
    among SWA layers) breaks uniformity."""
    w = layer_windows(cfg)
    return bool((w == w[0]).all())


def _layer(blocks: dict, li: int) -> dict:
    """Layer ``li``'s slice of the stacked per-layer parameters (views)."""
    return {k: _layer(v, li) if isinstance(v, dict) else v[li]
            for k, v in blocks.items()}


# ----------------------------------------------------------------------------
# embedding / head
# ----------------------------------------------------------------------------

def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _rope(cfg: ModelConfig, positions):
    return LY.rope(positions, cfg.head_dim, cfg.rope_theta)


def embed_tokens(params, cfg: ModelConfig, tokens, prefix_embeds=None):
    x = params["embed"][tokens].to(_dtype(cfg))
    if prefix_embeds is not None and cfg.num_prefix_embeds > 0:
        pe = torch.matmul(prefix_embeds.to(x.dtype),
                          params["frontend_proj"].to(x.dtype))
        P = pe.shape[1]
        x = torch.cat([pe, x[:, P:]], dim=1)
    return x


def lm_head(params, cfg: ModelConfig, x):
    x = LY.rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["head"]
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


# ----------------------------------------------------------------------------
# block bodies
# ----------------------------------------------------------------------------

def _mixer(x, p, cfg: ModelConfig, cs, window):
    """Sequence mixer for one layer: attention (the dense family's only)."""
    return LY.attention(x, p["attn"], cfg, cs=cs, window=window)


def _ffn(x, p, cfg: ModelConfig):
    return LY.mlp(x, p["mlp"], cfg.mlp_act)


def block(x, p, cfg: ModelConfig, *, cs, window):
    """One transformer layer: pre-norm attention and pre-norm MLP, each
    added to the residual stream; ``cs``: the RoPE tables
    (`layers.rope`) of the positions."""
    x = x + _mixer(LY.rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg, cs, window)
    return x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)


# ----------------------------------------------------------------------------
# full forward
# ----------------------------------------------------------------------------

def forward_logits(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence logits [B, S, V] f32 (validation + serving prefill
    comparisons). ``batch``: ``tokens`` [B, S] and, for a prefix adapter,
    ``prefix_embeds`` [B, P, d]."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens, batch.get("prefix_embeds"))
    cs = _rope(cfg, torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :])
    for li, w in enumerate(layer_windows(cfg)):
        x = block(x, _layer(params["blocks"], li), cfg, cs=cs, window=int(w))
    return lm_head(params, cfg, x)


# ----------------------------------------------------------------------------
# decode caches
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCache:
    """K/V cache of every layer, stacked: k and v [L, B, W, Hkv, hd] in
    the reference's ring layout (position p at slot p mod W), kpos [L, W]
    the absolute position held by each slot (−1 empty). The reference's
    SSM, RWKV and cross-attention fields come with their families."""
    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor


@dataclasses.dataclass
class DecodeCache:
    layers: LayerCache
    pos: int                                  # next position (host int)


def _cache_len(cfg: ModelConfig, max_len: int) -> int:
    w = int(layer_windows(cfg)[0])
    return w if w > 0 else max_len


def make_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: D.DeviceLike = None) -> DecodeCache:
    """An empty cache of ``cfg.dtype`` for ``batch`` sequences:
    full-attention layers hold ``max_len`` positions, windowed layers a
    ring of ``window``."""
    _require_dense(cfg)
    dtype, device = _dtype(cfg), D.resolve(device)
    L, W = len(layer_windows(cfg)), _cache_len(cfg, max_len)
    shape = (L, batch, W, cfg.num_kv_heads, cfg.head_dim)
    return DecodeCache(
        layers=LayerCache(k=torch.zeros(shape, dtype=dtype, device=device),
                          v=torch.zeros(shape, dtype=dtype, device=device),
                          kpos=torch.full((L, W), -1, dtype=torch.int32,
                                          device=device)),
        pos=0)


# ----------------------------------------------------------------------------
# prefill: process a full prompt, emit the decode cache
# ----------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, prefix_embeds=None,
            max_new_tokens: int = 64):
    """Process a prompt ``tokens`` [B, S] and return (last-token logits
    [B, 1, V], DecodeCache). Full-attention caches are sized ``S +
    max_new_tokens`` and hold ``cfg.dtype``; each layer's K/V are written
    (the last W positions, slot = position mod W) as attention used them,
    rounded to the cache's dtype."""
    _require_dense(cfg)
    B, S = tokens.shape
    dev = tokens.device
    cs = _rope(cfg, torch.arange(S, dtype=torch.int32, device=dev)[None, :])
    x = embed_tokens(params, cfg, tokens, prefix_embeds)
    cache = make_decode_cache(cfg, B, max_len=S + max_new_tokens, device=dev)
    c = cache.layers
    W = c.k.shape[2]
    take = min(W, S)
    ppos = torch.arange(S - take, S, dtype=torch.int32, device=dev)
    slots = (ppos % W).long()
    for li, w in enumerate(layer_windows(cfg)):
        p = _layer(params["blocks"], li)
        h = LY.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = LY.qkv(h, p["attn"], cfg, cs)
        x = x + LY.attn_out(LY.attend(q, k, v, causal=True, window=int(w)), p["attn"])
        c.k[li][:, slots] = k[:, S - take:].to(c.k.dtype)
        c.v[li][:, slots] = v[:, S - take:].to(c.v.dtype)
        c.kpos[li][slots] = ppos
        x = x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)
    cache.pos = S
    return lm_head(params, cfg, x[:, -1:]), cache


# ----------------------------------------------------------------------------
# decode (one token per sequence)
# ----------------------------------------------------------------------------

def _decode_attention(x, p, cfg, c: LayerCache, li: int, pos: int, cs):
    """One-token attention of layer ``li`` against its cache. The token's
    K/V go into slot pos mod W first, rounded to the cache's dtype; the
    query then attends every filled slot, [0, min(pos + 1, W)), with no
    causal mask: a full cache holds positions 0 … pos there, a ring the
    last W, so this is the reference's ``kv_valid`` mask (key order does
    not matter to attention)."""
    W = c.k.shape[2]
    slot, n = pos % W, min(pos + 1, W)
    q, k, v = LY.qkv(x, p, cfg, cs)
    c.k[li, :, slot] = k[:, 0].to(c.k.dtype)
    c.v[li, :, slot] = v[:, 0].to(c.v.dtype)
    out = LY.attend(q, c.k[li, :, :n], c.v[li, :, :n], causal=False)
    return LY.attn_out(out, p)


def _decode_layer(x, p, c: LayerCache, li: int, cfg: ModelConfig, pos: int, cs):
    """One layer of single-token decode; updates layer ``li`` of the cache
    in place and returns x."""
    x = x + _decode_attention(LY.rms_norm(x, p["ln1"], cfg.norm_eps),
                              p["attn"], cfg, c, li, pos, cs)
    return x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)


def decode_step(params, cfg: ModelConfig, cache: DecodeCache, tokens):
    """tokens: [B, 1] → (logits [B, 1, V], the cache advanced one
    position). The cache's tensors are updated in place."""
    _require_dense(cfg)
    pos = cache.pos
    c = cache.layers
    x = embed_tokens(params, cfg, tokens)
    cs = _rope(cfg, torch.full((1, 1), pos, dtype=torch.int32, device=x.device))
    for li in range(c.k.shape[0]):
        x = _decode_layer(x, _layer(params["blocks"], li), c, li, cfg, pos, cs)
    c.kpos[:, pos % c.k.shape[2]] = pos
    return lm_head(params, cfg, x), DecodeCache(layers=c, pos=pos + 1)
