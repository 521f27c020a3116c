"""Model assembly: full forward, prefill and cached decode.

The port of ``repro.models.transformer`` for the dense family (tinyllama,
qwen1.5's QKV bias, phi3's MHA, starcoder2's GELU MLP, llava-next's
Mistral backbone with its prefix-embedding adapter), hymba's hybrid layers
(attention ∥ a Mamba SSM, `repro_torch.models.ssm`, sliding-window layers
among full-attention ones) and whisper's encoder–decoder (a non-causal
encoder; decoder layers with cross-attention to its output). Every
attention runs the port's attention kernel
(`repro_torch.models.layers.attend`). MoE and RWKV6 raise
`NotImplementedError` naming the ROADMAP item that ports them.

Paths:
  * ``forward_logits`` — full-sequence logits, the reference the cache is
    checked against.
  * ``prefill``        — a prompt's last-token logits and its decode cache:
    K/V in the reference's ring layout (slot = position mod W, per layer),
    the SSM state, the cross-attention K/V.
  * ``decode_step``    — one token per sequence against the cache.

Unlike the reference, whose arrays are immutable, ``decode_step`` writes
the new token's K/V into the cache's tensors in place (a serving cache is
too large to copy every step) and returns the cache with ``pos`` advanced;
``pos`` is a host integer, so no step waits on the device for it. The SSM
state is small and is replaced, not written in place: its conv tail keeps
the stream's dtype, as in the reference, whatever the cache's.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as LY
from repro_torch.models import ssm as SM

#: families that wait for later slices, with the ROADMAP item (queue 1)
#: that ports them
_LATER = (
    (lambda c: c.num_experts > 0, "MoE layers (grok-1, llama4)", 2, "MoE layers"),
    (lambda c: c.rwkv, "RWKV6 time and channel mixing", 3, "RWKV6"),
)


def _require_ported(cfg: ModelConfig) -> None:
    for test, what, item, title in _LATER:
        if test(cfg):
            raise NotImplementedError(
                f"{cfg.name}: {what} are not ported yet (ROADMAP queue 1 "
                f"item {item}, \"{title}\")")


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

def _mixer(x, p, cfg: ModelConfig, cs, window, causal=True):
    """Sequence mixer for one layer: attention, or (hymba) attention and
    the SSM in parallel from zero state, fused with learned per-channel
    scales."""
    att = LY.attention(x, p["attn"], cfg, cs=cs, causal=causal, window=window)
    if not cfg.hybrid_ssm:
        return att
    sout, _ = SM.mamba(x, p["ssm"], cfg)
    return att * p["mix_attn"] + sout * p["mix_ssm"]


def _ffn(x, p, cfg: ModelConfig):
    return LY.mlp(x, p["mlp"], cfg.mlp_act)


def block(x, p, cfg: ModelConfig, *, cs, window, causal=True, enc_out=None):
    """One transformer layer: pre-norm mixer, then (a decoder layer given
    ``enc_out``) pre-norm cross-attention to it, then pre-norm MLP, each
    added to the residual stream; ``cs``: the RoPE tables (`layers.rope`)
    of the positions."""
    x = x + _mixer(LY.rms_norm(x, p["ln1"], cfg.norm_eps), p, cfg, cs, window, causal)
    if enc_out is not None:
        x = x + LY.attention(LY.rms_norm(x, p["ln_x"], cfg.norm_eps), p["xattn"],
                             cfg, kv=enc_out, causal=False)
    return x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)


def encode(params, cfg: ModelConfig, frames):
    """whisper's encoder: ``frames`` [B, S_src, d] in ``cfg.dtype`` plus the
    learned positions, a non-causal stack of full attention, ``ln_enc``."""
    S_src, dt = frames.shape[1], _dtype(cfg)
    x = frames.to(dt) + params["enc_pos"][:S_src].to(dt)
    cs = _rope(cfg, torch.arange(S_src, dtype=torch.int32, device=frames.device)[None, :])
    for li in range(cfg.encoder_layers):
        x = block(x, _layer(params["enc_blocks"], li), cfg, cs=cs, window=0, causal=False)
    return LY.rms_norm(x, params["ln_enc"], cfg.norm_eps)


def _decoder(params, cfg: ModelConfig) -> dict:
    """The stacked parameters of the layers a token runs through."""
    return params["dec_blocks"] if cfg.encoder_layers > 0 else params["blocks"]


# ----------------------------------------------------------------------------
# full forward
# ----------------------------------------------------------------------------

def forward_logits(params, cfg: ModelConfig, batch) -> torch.Tensor:
    """Full-sequence logits [B, S, V] f32 (validation + serving prefill
    comparisons). ``batch``: ``tokens`` [B, S] and, for a prefix adapter,
    ``prefix_embeds`` [B, P, d]; for an encoder–decoder, ``frames`` [B,
    S_src, d] and ``target_tokens`` [B, S]."""
    _require_ported(cfg)
    if cfg.encoder_layers > 0:
        enc_out = encode(params, cfg, batch["frames"])
        tokens = batch["target_tokens"]
        x = embed_tokens(params, cfg, tokens)
    else:
        enc_out = None
        tokens = batch["tokens"]
        x = embed_tokens(params, cfg, tokens, batch.get("prefix_embeds"))
    cs = _rope(cfg, torch.arange(tokens.shape[1], dtype=torch.int32,
                                 device=tokens.device)[None, :])
    for li, w in enumerate(layer_windows(cfg)):
        x = block(x, _layer(_decoder(params, cfg), li), cfg, cs=cs, window=int(w),
                  enc_out=enc_out)
    return lm_head(params, cfg, x)


# ----------------------------------------------------------------------------
# decode caches
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCache:
    """One layer's cache, or every layer's stacked along a leading [L]
    axis. k and v [B, W, Hkv, hd] in the reference's ring layout (position
    p at slot p mod W; W = the window, or the full length), kpos [W] the
    absolute position held by each slot (−1 empty); hymba's SSM state,
    ssm_h [B, di, st] f32 and ssm_tail [B, K − 1, di]; whisper's
    cross-attention xk, xv [B, S_src, Hkv, hd]. The reference's RWKV and
    second-attention fields come with their families."""
    k: torch.Tensor
    v: torch.Tensor
    kpos: torch.Tensor
    ssm_h: Optional[torch.Tensor] = None
    ssm_tail: Optional[torch.Tensor] = None
    xk: Optional[torch.Tensor] = None
    xv: Optional[torch.Tensor] = None


@dataclasses.dataclass
class DecodeCache:
    #: one stacked LayerCache when every layer's shapes agree
    #: (`cache_is_uniform`), else one LayerCache per layer (hymba)
    layers: Union[LayerCache, Tuple[LayerCache, ...]]
    pos: int                                  # next position (host int)


def _layer_cache(cfg: ModelConfig, B: int, W: int, S_src: int, dtype, dev,
                 lead: tuple = ()) -> LayerCache:
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    zeros = lambda *shape, dt=dtype: torch.zeros(lead + shape, dtype=dt, device=dev)
    c = LayerCache(k=zeros(B, W, Hkv, hd), v=zeros(B, W, Hkv, hd),
                   kpos=torch.full(lead + (W,), -1, dtype=torch.int32, device=dev))
    if cfg.hybrid_ssm:
        c.ssm_h = zeros(B, cfg.ssm_inner, cfg.ssm_state, dt=torch.float32)
        c.ssm_tail = zeros(B, cfg.ssm_conv - 1, cfg.ssm_inner)
    if cfg.cross_attention:
        c.xk, c.xv = zeros(B, S_src, Hkv, hd), zeros(B, S_src, Hkv, hd)
    return c


def make_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device: D.DeviceLike = None,
                      source_len: Optional[int] = None) -> DecodeCache:
    """An empty cache of ``cfg.dtype`` for ``batch`` sequences:
    full-attention layers hold ``max_len`` positions, windowed layers a
    ring of their window; cross-attention K/V hold ``source_len`` encoder
    positions (default ``cfg.max_source_len``). Stacked when every layer's
    shapes agree, else a tuple of per-layer caches (the reference's
    layouts)."""
    _require_ported(cfg)
    dtype, dev = _dtype(cfg), D.resolve(device)
    lens = [int(w) if w > 0 else max_len for w in layer_windows(cfg)]
    S_src = cfg.max_source_len if source_len is None else source_len
    if cache_is_uniform(cfg):
        layers = _layer_cache(cfg, batch, lens[0], S_src, dtype, dev, lead=(len(lens),))
    else:
        layers = tuple(_layer_cache(cfg, batch, W, S_src, dtype, dev) for W in lens)
    return DecodeCache(layers=layers, pos=0)


def _per_layer(layers) -> Tuple[LayerCache, ...]:
    """Each layer's cache: the tuple's own, or views into the stacked one
    (writes into their tensors write the cache; a stacked cache holds no
    SSM state, whose fields are replaced, since only hymba has one)."""
    if isinstance(layers, tuple):
        return layers
    fields = [f.name for f in dataclasses.fields(LayerCache)]
    return tuple(LayerCache(**{f: None if getattr(layers, f) is None else getattr(layers, f)[li]
                               for f in fields})
                 for li in range(layers.k.shape[0]))


# ----------------------------------------------------------------------------
# prefill: process a full prompt, emit the decode cache
# ----------------------------------------------------------------------------

def prefill(params, cfg: ModelConfig, tokens, prefix_embeds=None, frames=None,
            max_new_tokens: int = 64):
    """Process a prompt ``tokens`` [B, S] (an encoder–decoder: the target
    prefix, with ``frames`` [B, S_src, d] for the encoder) and return
    (last-token logits [B, 1, V], DecodeCache). Full-attention caches are
    sized ``S + max_new_tokens`` and hold ``cfg.dtype``; each layer's K/V
    are written (its last W positions, slot = position mod W) as attention
    used them, rounded to the cache's dtype; cross-attention K/V at the
    encoder's length, likewise rounded (prefill attends them unrounded).
    The SSM starts from zero state."""
    _require_ported(cfg)
    B, S = tokens.shape
    dev = tokens.device
    enc_out = None
    if cfg.encoder_layers > 0:
        if frames is None:
            raise ValueError(f"{cfg.name}: prefill needs the encoder's frames")
        enc_out = encode(params, cfg, frames)
    cs = _rope(cfg, torch.arange(S, dtype=torch.int32, device=dev)[None, :])
    x = embed_tokens(params, cfg, tokens, prefix_embeds)
    cache = make_decode_cache(cfg, B, max_len=S + max_new_tokens, device=dev,
                              source_len=None if enc_out is None else enc_out.shape[1])
    for li, (w, c) in enumerate(zip(layer_windows(cfg), _per_layer(cache.layers))):
        p = _layer(_decoder(params, cfg), li)
        h = LY.rms_norm(x, p["ln1"], cfg.norm_eps)
        q, k, v = LY.qkv(h, p["attn"], cfg, cs)
        mix = LY.attn_out(LY.attend(q, k, v, causal=True, window=int(w)), p["attn"])
        W = c.k.shape[1]
        take = min(W, S)
        ppos = torch.arange(S - take, S, dtype=torch.int32, device=dev)
        slots = (ppos % W).long()
        c.k[:, slots] = k[:, S - take:].to(c.k.dtype)
        c.v[:, slots] = v[:, S - take:].to(c.v.dtype)
        c.kpos[slots] = ppos
        if cfg.hybrid_ssm:
            sout, (c.ssm_h, c.ssm_tail) = SM.mamba(h, p["ssm"], cfg)
            mix = mix * p["mix_attn"] + sout * p["mix_ssm"]
        x = x + mix
        if enc_out is not None:
            hx = LY.rms_norm(x, p["ln_x"], cfg.norm_eps)
            xk, xv = LY.kv_proj(enc_out, p["xattn"], cfg)
            xo = LY.attend(LY.query(hx, p["xattn"], cfg), xk, xv, causal=False)
            x = x + LY.attn_out(xo, p["xattn"])
            c.xk.copy_(xk)
            c.xv.copy_(xv)
        x = x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)
    cache.pos = S
    return lm_head(params, cfg, x[:, -1:]), cache


# ----------------------------------------------------------------------------
# decode (one token per sequence)
# ----------------------------------------------------------------------------

def _decode_attention(x, p, cfg, c: LayerCache, pos: int, cs):
    """One-token attention against one layer's cache. The token's K/V go
    into slot pos mod W first, rounded to the cache's dtype; the query
    then attends every filled slot, [0, min(pos + 1, W)), with no causal
    mask: a full cache holds positions 0 … pos there, a ring the last W,
    so this is the reference's ``kv_valid`` mask (key order does not
    matter to attention)."""
    W = c.k.shape[1]
    slot, n = pos % W, min(pos + 1, W)
    q, k, v = LY.qkv(x, p, cfg, cs)
    c.k[:, slot] = k[:, 0].to(c.k.dtype)
    c.v[:, slot] = v[:, 0].to(c.v.dtype)
    return LY.attn_out(LY.attend(q, c.k[:, :n], c.v[:, :n], causal=False), p)


def _decode_layer(x, p, c: LayerCache, cfg: ModelConfig, pos: int, cs):
    """One layer of single-token decode; updates its cache and returns x.
    The SSM runs `ssm.mamba` on the one token from the cached state, as
    the reference's decode does; cross-attention reads the cached (rounded)
    K/V with an unrotated query."""
    h = LY.rms_norm(x, p["ln1"], cfg.norm_eps)
    mix = _decode_attention(h, p["attn"], cfg, c, pos, cs)
    if cfg.hybrid_ssm:
        sout, (c.ssm_h, c.ssm_tail) = SM.mamba(h, p["ssm"], cfg, state=c.ssm_h,
                                               conv_tail=c.ssm_tail)
        mix = mix * p["mix_attn"] + sout * p["mix_ssm"]
    x = x + mix
    if c.xk is not None:
        hx = LY.rms_norm(x, p["ln_x"], cfg.norm_eps)
        xo = LY.attend(LY.query(hx, p["xattn"], cfg), c.xk, c.xv, causal=False)
        x = x + LY.attn_out(xo, p["xattn"])
    return x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg)


def decode_step(params, cfg: ModelConfig, cache: DecodeCache, tokens):
    """tokens: [B, 1] → (logits [B, 1, V], the cache advanced one
    position). The cache's tensors are updated in place."""
    _require_ported(cfg)
    pos = cache.pos
    x = embed_tokens(params, cfg, tokens)
    cs = _rope(cfg, torch.full((1, 1), pos, dtype=torch.int32, device=x.device))
    for li, c in enumerate(_per_layer(cache.layers)):
        x = _decode_layer(x, _layer(_decoder(params, cfg), li), c, cfg, pos, cs)
    # each layer's slot pos mod W now holds pos (one write for a stacked cache)
    for c in cache.layers if isinstance(cache.layers, tuple) else (cache.layers,):
        c.kpos[..., pos % c.kpos.shape[-1]] = pos
    return lm_head(params, cfg, x), DecodeCache(layers=cache.layers, pos=pos + 1)
