"""Model assembly: full forward, prefill and cached decode.

The port of ``repro.models.transformer`` for every family of the registry:
the dense family (tinyllama, qwen1.5's QKV bias, phi3's MHA, starcoder2's
GELU MLP, llava-next's Mistral backbone with its prefix-embedding
adapter), MoE (grok-1's MoE FFN in every layer; llama4's interleaved
pairs: a dense layer, then a second attention and an MoE FFN, with a
shared expert; `repro_torch.models.layers.moe`), hymba's hybrid layers
(attention ∥ a Mamba SSM, `repro_torch.models.ssm`, sliding-window layers
among full-attention ones), RWKV6 (attention-free: time mix and channel
mix, `ssm.rwkv_time_mix`, `ssm.rwkv_channel_mix`) and whisper's
encoder–decoder (a non-causal encoder; decoder layers with
cross-attention to its output). Every attention runs the port's attention
kernel (`repro_torch.models.layers.attend`).

Paths:
  * ``forward_train``  — the training loss (token-mean cross-entropy, the
    head fused with it in sequence chunks), every layer recomputed in the
    backward (``torch.utils.checkpoint``, the reference's remat); MoE
    layers through capacity dispatch. Its gradient runs the attention
    kernel's backward (`repro_torch.kernels.ops.FlashAttention`).
  * ``forward_logits`` — full-sequence logits, the reference the cache is
    checked against.
  * ``prefill``        — a prompt's last-token logits and its decode cache:
    K/V in the reference's ring layout (slot = position mod W, per layer;
    a pair's second attention in k2/v2), the SSM and RWKV states, the
    cross-attention K/V.
  * ``decode_step``    — one token per sequence against the cache. MoE
    layers run dense (every expert, gate-weighted), as the reference's.

MoE capacity depends on the tokens of a call (`layers.moe`): a prompt and
the full sequence drop different slots, so prefill and decode agree with
``forward_logits`` only with ``moe_dense=True`` on both sides.

Unlike the reference, whose arrays are immutable, ``decode_step`` writes
the new token's K/V into the cache's tensors in place (a serving cache is
too large to copy every step) and returns the cache with ``pos`` advanced;
``pos`` is a host integer, so no step waits on the device for it. The SSM
state is small and is replaced, not written in place: its conv tail keeps
the stream's dtype, as in the reference, whatever the cache's. RWKV6's
state is written in place (a stacked cache holds it): its token-shift
inputs in the cache's dtype, the WKV state in float32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch.utils import checkpoint as CK

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as LY
from repro_torch.models import ssm as SM

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


@dataclasses.dataclass
class MoECall:
    """A layer's MoE call on rows that are part of a larger microbatch
    (`Routing`): C's token count and the [E] int64 offsets it reads
    (`layers.moe`); ``counts`` is set to the call's [E] slot counts when
    it runs."""
    tokens: int
    offset: torch.Tensor
    counts: Optional[torch.Tensor] = None


def _moe(x, p, cfg: ModelConfig, moe_dense: bool, call: Optional[MoECall]):
    if call is None:
        return LY.moe(x, p, cfg, dense=moe_dense)
    y, call.counts = LY.moe(x, p, cfg, tokens=call.tokens, offset=call.offset,
                            return_counts=True)
    return y


def _ffn(x, p, cfg: ModelConfig, moe_dense: bool = False, moe_call: Optional[MoECall] = None):
    """A layer's FFN: the MLP, or (grok-1) the MoE FFN."""
    if "moe" in p and "mlp" not in p:
        return _moe(x, p["moe"], cfg, moe_dense, moe_call)
    return LY.mlp(x, p["mlp"], cfg.mlp_act)


def block(x, p, cfg: ModelConfig, *, cs, window, causal=True, enc_out=None,
          moe_dense: bool = False, moe_call: Optional[MoECall] = None):
    """One transformer layer, or one llama4 pair: pre-norm mixer, then (a
    decoder layer given ``enc_out``) pre-norm cross-attention to it, then
    pre-norm FFN, each added to the residual stream; a pair continues with
    pre-norm ``attn2`` and pre-norm MoE. RWKV6: time mix, then channel mix.
    ``cs``: the RoPE tables (`layers.rope`) of the positions; ``moe_call``:
    the layer's MoE call on rows of a larger microbatch (`MoECall`)."""
    h = LY.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.rwkv:
        x = x + SM.rwkv_time_mix(h, p, cfg)[0]
        return x + SM.rwkv_channel_mix(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p)[0]
    x = x + _mixer(h, p, cfg, cs, window, causal)
    if enc_out is not None:
        x = x + LY.attention(LY.rms_norm(x, p["ln_x"], cfg.norm_eps), p["xattn"],
                             cfg, kv=enc_out, causal=False)
    x = x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg, moe_dense, moe_call)
    if "ln3" in p:  # interleaved dense + MoE pair (llama4)
        x = x + LY.attention(LY.rms_norm(x, p["ln3"], cfg.norm_eps), p["attn2"], cfg,
                             cs=cs, causal=causal, window=window)
        x = x + _moe(LY.rms_norm(x, p["ln4"], cfg.norm_eps), p["moe"], cfg, moe_dense, moe_call)
    return x


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

def forward_logits(params, cfg: ModelConfig, batch, moe_dense: bool = False) -> torch.Tensor:
    """Full-sequence logits [B, S, V] f32 (validation + serving prefill
    comparisons). ``batch``: ``tokens`` [B, S] and, for a prefix adapter,
    ``prefix_embeds`` [B, P, d]; for an encoder–decoder, ``frames`` [B,
    S_src, d] and ``target_tokens`` [B, S]. ``moe_dense``: MoE layers run
    every expert (`layers.moe`)."""
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
                  enc_out=enc_out, moe_dense=moe_dense)
    return lm_head(params, cfg, x)


# ----------------------------------------------------------------------------
# training forward
# ----------------------------------------------------------------------------

def _ce_sums(logits, labels):
    """(Σ of the masked token NLLs, the count of labels ≥ 0), float32."""
    mask = (labels >= 0).to(torch.float32)
    safe = labels.clamp_min(0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    return nll.sum(), mask.sum()


def cross_entropy(logits, labels):
    """Masked token-mean CE; labels < 0 are ignored."""
    nll, cnt = _ce_sums(logits, labels)
    return nll / cnt.clamp_min(1.0)


#: sequence-chunk size for the fused head+CE loss; keeps the [tokens, V]
#: logits of a chunk, not of the sequence, live in the forward
_CE_CHUNK = 512


def head_loss_chunked(params, cfg: ModelConfig, x, labels):
    """Fused final-norm → head-matmul → CE over sequence chunks of
    `_CE_CHUNK` (when it divides S and S > `_CE_CHUNK`; else one chunk),
    in float32. Returns (nll_sum, count), summed chunk by chunk."""
    B, S, d = x.shape
    x = LY.rms_norm(x, params["ln_f"], cfg.norm_eps)
    w = (params["embed"].T if cfg.tie_embeddings else params["head"]).to(torch.float32)
    chunk = _CE_CHUNK if (S % _CE_CHUNK == 0 and S > _CE_CHUNK) else S
    nll = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        logits = torch.matmul(x[:, c0:c0 + chunk].to(torch.float32), w)
        lc = labels[:, c0:c0 + chunk]
        mask = (lc >= 0).to(torch.float32)
        gold = logits.gather(-1, lc.clamp_min(0).long()[..., None])[..., 0]
        nll = nll + ((torch.logsumexp(logits, dim=-1) - gold) * mask).sum()
        cnt = cnt + mask.sum()
    return nll, cnt


#: matrix products, whose outputs ``remat_policy="dots"`` keeps
_DOTS = frozenset(getattr(torch.ops.aten, n).default
                  for n in ("mm", "bmm", "addmm", "baddbmm"))


def _save_dots(ctx, op, *args, **kwargs):
    """Selective checkpointing's policy for ``"dots"``: keep the outputs of
    the matrix products, recompute the rest (JAX's ``dots_saveable``)."""
    policy = CK.CheckpointPolicy
    return policy.MUST_SAVE if op in _DOTS else policy.PREFER_RECOMPUTE


def _remat(fn, remat_policy: str):
    """``fn(*inputs)`` recomputed in the backward (the reference's
    per-layer ``jax.checkpoint``): ``"nothing"`` saves only its inputs,
    ``"dots"`` also the outputs of its products. The numbers are the same
    either way."""
    if remat_policy == "nothing":
        return lambda *a: CK.checkpoint(fn, *a, use_reentrant=False)
    if remat_policy == "dots":
        ctx = functools.partial(CK.create_selective_checkpoint_contexts, _save_dots)
        return lambda *a: CK.checkpoint(fn, *a, use_reentrant=False, context_fn=ctx)
    raise ValueError(f"remat_policy {remat_policy!r}: one of 'nothing', 'dots'")


class Routing:
    """A microbatch's MoE routing record, for its rows split over data
    replicas that run one after another (`train.train_step.
    accumulate_grads_mesh`): ``tokens``, the microbatch's token count,
    which sets every MoE call's capacity (`layers.capacity`), and
    ``counts``, one [E] int64 vector per MoE call in call order: the slots
    the replicas run so far sent to each expert, dropped ones included.

    Replica r's rows follow replicas 0 … r−1's in the microbatch's (token,
    k) order, so a slot's place in its expert's queue over the whole
    microbatch is its place among replica r's slots plus that offset: each
    replica keeps and drops the slots the one-device forward does."""

    def __init__(self, tokens: int):
        self.tokens = tokens
        self.counts: list = []

    def offset(self, call: int, E: int, dev) -> torch.Tensor:
        """MoE call ``call``'s offset on ``dev``: the counts so far (zeros
        before any replica has run)."""
        if call < len(self.counts):
            return self.counts[call].to(dev)
        return torch.zeros((E,), dtype=torch.int64, device=dev)

    def add(self, call: int, counts: torch.Tensor) -> None:
        """Add one replica's counts at MoE call ``call``; a new tensor, so
        an offset read before (held for a layer's recomputation) never
        changes."""
        if call == len(self.counts):
            self.counts.append(counts)
        else:
            self.counts[call] = self.counts[call].to(counts.device) + counts

    def dropped(self, K: int, E: int, capacity_factor: float = 1.25) -> list:
        """Slots each MoE call dropped over the replicas run so far: an
        expert keeps its first C."""
        C = LY.capacity(self.tokens, E, K, capacity_factor)
        return [(c - C).clamp_min(0).sum() for c in self.counts]


def _train_blocks(x, blocks, cfg: ModelConfig, cs, *, causal=True, enc_out=None,
                  remat_policy: str = "nothing", routing: Optional[Routing] = None):
    """The layer stack for training, each layer (a llama4 pair) recomputed
    in the backward; each layer keeps its own window (hymba's global
    layers among windowed ones; an encoder: full attention). MoE layers
    run capacity dispatch; with ``routing``, as rows of its microbatch: a
    layer reads its offset before it runs, as an input of the recomputed
    function, so its recomputation reads the same one, and its counts are
    added once, from the forward's output."""
    windows = (layer_windows(cfg) if causal
               else np.zeros((cfg.encoder_layers,), np.int32))
    for li, (w, p) in enumerate(zip(windows, _unbind_layers(blocks))):
        fn = functools.partial(block, p=p, cfg=cfg, cs=cs, window=int(w), causal=causal,
                               enc_out=enc_out)
        if routing is None or "moe" not in p:
            x = _remat(fn, remat_policy)(x)
            continue

        def routed(x, offset, fn=fn):
            call = MoECall(routing.tokens, offset)
            return fn(x, moe_call=call), call.counts

        x, counts = _remat(routed, remat_policy)(
            x, routing.offset(li, cfg.num_experts, x.device))
        routing.add(li, counts)
    return x


def _unbind_layers(blocks: dict) -> list:
    """Every layer's parameters, as views cut from the stacked tensors at
    once (``torch.unbind``): their gradient stacks the layers' gradients
    in one write, where one slice a layer (`_layer`) would add a zero-filled
    full-size gradient per layer, L² of the leaf's bytes."""
    per = {k: _unbind_layers(v) if isinstance(v, dict) else torch.unbind(v)
           for k, v in blocks.items()}
    L = len(next(iter(per.values())))
    return [{k: v[li] for k, v in per.items()} for li in range(L)]


def _positions(S: int, dev):
    return torch.arange(S, dtype=torch.int32, device=dev)[None, :]


def forward_train(params, cfg: ModelConfig, batch, remat_policy: str = "nothing"):
    """The training loss, a float32 scalar: the masked token mean of
    `loss_sums`. ``batch``: ``tokens`` [B, S], ``labels`` [B, S] (< 0
    ignored) and, for a prefix adapter, ``prefix_embeds`` [B, P, d]; an
    encoder–decoder takes ``frames`` [B, S_src, d], ``target_tokens`` and
    ``target_labels`` [B, S] instead (and its layers are recomputed with
    ``"nothing"``, as the reference's)."""
    nll, cnt = loss_sums(params, cfg, batch, remat_policy)
    return nll / cnt.clamp_min(1.0)


def label_key(cfg: ModelConfig) -> str:
    """The batch entry whose entries ≥ 0 the loss counts."""
    return "target_labels" if cfg.encoder_layers > 0 else "labels"


def loss_sums(params, cfg: ModelConfig, batch, remat_policy: str = "nothing",
              routing: Optional[Routing] = None):
    """(Σ of the token NLLs over the labels ≥ 0, their count), float32:
    the loss of rows that are part of a larger batch, combined by sums.
    ``routing``: the microbatch's MoE routing record, which these rows
    read and add to (`Routing`; a decoder-only config)."""
    if cfg.encoder_layers > 0:
        return _encdec_sums(params, cfg, batch)
    tokens = batch["tokens"]
    x = embed_tokens(params, cfg, tokens, batch.get("prefix_embeds"))
    cs = _rope(cfg, _positions(tokens.shape[1], tokens.device))
    x = _train_blocks(x, params["blocks"], cfg, cs, remat_policy=remat_policy,
                      routing=routing)
    return head_loss_chunked(params, cfg, x, batch["labels"])


def _encdec_sums(params, cfg: ModelConfig, batch):
    frames = batch["frames"]
    S_src, dt = frames.shape[1], _dtype(cfg)
    x = frames.to(dt) + params["enc_pos"][:S_src].to(dt)
    x = _train_blocks(x, params["enc_blocks"], cfg, _rope(cfg, _positions(S_src, x.device)),
                      causal=False)
    enc_out = LY.rms_norm(x, params["ln_enc"], cfg.norm_eps)
    tgt = batch["target_tokens"]
    y = embed_tokens(params, cfg, tgt)
    y = _train_blocks(y, params["dec_blocks"], cfg, _rope(cfg, _positions(tgt.shape[1], y.device)),
                      enc_out=enc_out)
    return _ce_sums(lm_head(params, cfg, y), batch["target_labels"])


# ----------------------------------------------------------------------------
# decode caches
# ----------------------------------------------------------------------------

@dataclasses.dataclass
class LayerCache:
    """One layer's cache, or every layer's stacked along a leading [L]
    axis; a field a family does not use is None. k and v [B, W, Hkv, hd]
    in the reference's ring layout (position p at slot p mod W; W = the
    window, or the full length), kpos [W] the absolute position held by
    each slot (−1 empty); k2, v2, kpos2 the same for a llama4 pair's second
    attention; hymba's SSM state, ssm_h [B, di, st] f32 and ssm_tail [B,
    K − 1, di]; RWKV6's WKV state rwkv_s [B, H, hd, hd] f32 and its time-
    and channel-mix token-shift inputs rwkv_prev_tm, rwkv_prev_cm [B, 1,
    d]; whisper's cross-attention xk, xv [B, S_src, Hkv, hd]."""
    k: Optional[torch.Tensor] = None
    v: Optional[torch.Tensor] = None
    kpos: Optional[torch.Tensor] = None
    k2: Optional[torch.Tensor] = None
    v2: Optional[torch.Tensor] = None
    kpos2: Optional[torch.Tensor] = None
    ssm_h: Optional[torch.Tensor] = None
    ssm_tail: Optional[torch.Tensor] = None
    rwkv_s: Optional[torch.Tensor] = None
    rwkv_prev_tm: Optional[torch.Tensor] = None
    rwkv_prev_cm: Optional[torch.Tensor] = None
    xk: Optional[torch.Tensor] = None
    xv: Optional[torch.Tensor] = None

    def tensors(self):
        """(field name, tensor) of every field that is set."""
        return [(f.name, getattr(self, f.name)) for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None]


@dataclasses.dataclass
class DecodeCache:
    #: one stacked LayerCache when every layer's shapes agree
    #: (`cache_is_uniform`), else one LayerCache per layer (hymba)
    layers: Union[LayerCache, Tuple[LayerCache, ...]]
    pos: int                                  # next position (host int)


def _layer_cache(cfg: ModelConfig, B: int, W: int, S_src: int, dtype, dev,
                 lead: tuple = ()) -> LayerCache:
    Hkv, hd, d = cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    zeros = lambda *shape, dt=dtype: torch.zeros(lead + shape, dtype=dt, device=dev)
    ring = lambda: (zeros(B, W, Hkv, hd), zeros(B, W, Hkv, hd),
                    torch.full(lead + (W,), -1, dtype=torch.int32, device=dev))
    c = LayerCache()
    if cfg.rwkv:
        H, rhd = d // cfg.rwkv_head_dim, cfg.rwkv_head_dim
        c.rwkv_s = zeros(B, H, rhd, rhd, dt=torch.float32)
        c.rwkv_prev_tm, c.rwkv_prev_cm = zeros(B, 1, d), zeros(B, 1, d)
        return c
    c.k, c.v, c.kpos = ring()
    if cfg.num_experts > 0 and cfg.moe_every == 2:   # llama4's (dense, MoE) pairs
        c.k2, c.v2, c.kpos2 = ring()
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
    positions (default ``cfg.max_source_len``); RWKV6 layers hold their
    state, the WKV's in float32. Stacked when every layer's shapes agree,
    else a tuple of per-layer caches (the reference's layouts)."""
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
    Mamba state, whose fields are replaced, since only hymba has one)."""
    if isinstance(layers, tuple):
        return layers
    fields = layers.tensors()
    return tuple(LayerCache(**{f: t[li] for f, t in fields})
                 for li in range(fields[0][1].shape[0]))


def _write_ring(k_c, v_c, kpos_c, k, v):
    """Write a prompt's K/V [B, S, Hkv, hd] into a ring (or full) cache:
    its last W positions at slot = position mod W, rounded to the cache's
    dtype."""
    S, W = k.shape[1], k_c.shape[1]
    take = min(W, S)
    ppos = torch.arange(S - take, S, dtype=torch.int32, device=k.device)
    slots = (ppos % W).long()
    k_c[:, slots] = k[:, S - take:].to(k_c.dtype)
    v_c[:, slots] = v[:, S - take:].to(v_c.dtype)
    kpos_c[slots] = ppos


# ----------------------------------------------------------------------------
# prefill: process a full prompt, emit the decode cache
# ----------------------------------------------------------------------------

def _prefill_attention(h, p, cfg: ModelConfig, cs, window: int, k_c, v_c, kpos_c):
    """Self-attention of a prompt that also writes its K/V into a cache."""
    q, k, v = LY.qkv(h, p, cfg, cs)
    _write_ring(k_c, v_c, kpos_c, k, v)
    return LY.attn_out(LY.attend(q, k, v, causal=True, window=window), p)


def prefill(params, cfg: ModelConfig, tokens, prefix_embeds=None, frames=None,
            max_new_tokens: int = 64, moe_dense: bool = False):
    """Process a prompt ``tokens`` [B, S] (an encoder–decoder: the target
    prefix, with ``frames`` [B, S_src, d] for the encoder) and return
    (last-token logits [B, 1, V], DecodeCache). Full-attention caches are
    sized ``S + max_new_tokens`` and hold ``cfg.dtype``; each attention's
    K/V are written (its last W positions, slot = position mod W) as
    attention used them, rounded to the cache's dtype; cross-attention K/V
    at the encoder's length, likewise rounded (prefill attends them
    unrounded). The SSM and RWKV6 start from zero state. ``moe_dense``: MoE
    layers run every expert (`layers.moe`)."""
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
        if cfg.rwkv:
            mix, (prev_tm, s) = SM.rwkv_time_mix(h, p, cfg)
            x = x + mix
            out, prev_cm = SM.rwkv_channel_mix(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p)
            x = x + out
            c.rwkv_s.copy_(s)
            c.rwkv_prev_tm.copy_(prev_tm)
            c.rwkv_prev_cm.copy_(prev_cm)
            continue
        mix = _prefill_attention(h, p["attn"], cfg, cs, int(w), c.k, c.v, c.kpos)
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
        x = x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg, moe_dense)
        if "ln3" in p:  # the pair's second attention, cached in k2/v2, then MoE
            x = x + _prefill_attention(LY.rms_norm(x, p["ln3"], cfg.norm_eps), p["attn2"],
                                       cfg, cs, int(w), c.k2, c.v2, c.kpos2)
            x = x + LY.moe(LY.rms_norm(x, p["ln4"], cfg.norm_eps), p["moe"], cfg,
                           dense=moe_dense)
    cache.pos = S
    return lm_head(params, cfg, x[:, -1:]), cache


# ----------------------------------------------------------------------------
# decode (one token per sequence)
# ----------------------------------------------------------------------------

def _decode_attention(x, p, cfg, k_c, v_c, pos: int, cs):
    """One-token attention against one layer's (ring or full) K/V cache.
    The token's K/V go into slot pos mod W first, rounded to the cache's
    dtype; the query then attends every filled slot, [0, min(pos + 1, W)),
    with no causal mask: a full cache holds positions 0 … pos there, a ring
    the last W, so this is the reference's ``kv_valid`` mask (key order
    does not matter to attention)."""
    W = k_c.shape[1]
    slot, n = pos % W, min(pos + 1, W)
    q, k, v = LY.qkv(x, p, cfg, cs)
    k_c[:, slot] = k[:, 0].to(k_c.dtype)
    v_c[:, slot] = v[:, 0].to(v_c.dtype)
    return LY.attn_out(LY.attend(q, k_c[:, :n], v_c[:, :n], causal=False), p)


def _decode_layer(x, p, c: LayerCache, cfg: ModelConfig, pos: int, cs):
    """One layer of single-token decode; updates its cache and returns x.
    The SSM runs `ssm.mamba` on the one token from the cached state, and
    RWKV6 its time and channel mix from the cached state, as the
    reference's decode does; cross-attention reads the cached (rounded) K/V
    with an unrotated query; MoE runs dense."""
    h = LY.rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.rwkv:
        mix, (prev_tm, s) = SM.rwkv_time_mix(h, p, cfg, prev_x=c.rwkv_prev_tm,
                                             state=c.rwkv_s)
        x = x + mix
        out, prev_cm = SM.rwkv_channel_mix(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p,
                                           prev_x=c.rwkv_prev_cm)
        c.rwkv_s.copy_(s)
        c.rwkv_prev_tm.copy_(prev_tm)
        c.rwkv_prev_cm.copy_(prev_cm)
        return x + out
    mix = _decode_attention(h, p["attn"], cfg, c.k, c.v, pos, cs)
    if cfg.hybrid_ssm:
        sout, (c.ssm_h, c.ssm_tail) = SM.mamba(h, p["ssm"], cfg, state=c.ssm_h,
                                               conv_tail=c.ssm_tail)
        mix = mix * p["mix_attn"] + sout * p["mix_ssm"]
    x = x + mix
    if c.xk is not None:
        hx = LY.rms_norm(x, p["ln_x"], cfg.norm_eps)
        xo = LY.attend(LY.query(hx, p["xattn"], cfg), c.xk, c.xv, causal=False)
        x = x + LY.attn_out(xo, p["xattn"])
    x = x + _ffn(LY.rms_norm(x, p["ln2"], cfg.norm_eps), p, cfg, moe_dense=True)
    if "ln3" in p:  # llama4 pair: second attention + MoE
        x = x + _decode_attention(LY.rms_norm(x, p["ln3"], cfg.norm_eps), p["attn2"], cfg,
                                  c.k2, c.v2, pos, cs)
        x = x + LY.moe(LY.rms_norm(x, p["ln4"], cfg.norm_eps), p["moe"], cfg, dense=True)
    return x


def decode_step(params, cfg: ModelConfig, cache: DecodeCache, tokens):
    """tokens: [B, 1] → (logits [B, 1, V], the cache advanced one
    position). The cache's tensors are updated in place."""
    pos = cache.pos
    x = embed_tokens(params, cfg, tokens)
    cs = _rope(cfg, torch.full((1, 1), pos, dtype=torch.int32, device=x.device))
    for li, c in enumerate(_per_layer(cache.layers)):
        x = _decode_layer(x, _layer(_decoder(params, cfg), li), c, cfg, pos, cs)
    # each ring's slot pos mod W now holds pos (one write for a stacked cache)
    for c in cache.layers if isinstance(cache.layers, tuple) else (cache.layers,):
        for kpos in (c.kpos, c.kpos2):
            if kpos is not None:
                kpos[..., pos % kpos.shape[-1]] = pos
    return lm_head(params, cfg, x), DecodeCache(layers=cache.layers, pos=pos + 1)
