"""Transformer building blocks: norms, RoPE, GQA attention, MLP, MoE.

Plain functions over parameter subtrees of `repro_torch.models.params`, as
``repro.models.layers`` is. Attention runs the port's attention kernel
through `repro_torch.kernels.ops.flash_attention`: the Hopper kernel for
CUDA tensors, its plain twin for CPU tensors.

JAX promotes a bfloat16 operand of a product with a float32 one to float32;
``torch.matmul`` refuses mixed dtypes, so `matmul` makes that promotion
explicit, at the places the reference's einsums make it. Elementwise
operations promote the same way in both frameworks. Left out: the mesh
constraints (``act_constrain``, a no-op without a mesh) and the
query-chunked and local-window XLA attention paths, which the kernel
replaces. RoPE's tables are computed once a forward (`rope`) and
applied per layer (`apply_rope`), where the reference's ``rotary`` does
both per layer; the numbers are the same.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as a JAX einsum."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def rms_norm(x, scale, eps=1e-5):
    var = x.to(torch.float32).square().mean(-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope(positions, head_dim: int, theta=10000.0):
    """RoPE's (cos, sin) for ``positions`` [..., S], each [..., S, 1,
    head_dim / 2] (broadcast over heads). A forward computes them once for
    all its layers."""
    half = head_dim // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].to(torch.float32) * freq  # [..., S, half]
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def apply_rope(x, cs):
    """Rotate x [..., S, H, hd] by the RoPE tables ``cs`` from `rope`."""
    cos, sin = cs
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


def qkv(x, p, cfg, cs):
    """Self-attention projections of x [B, S, d]: q [B, S, H, hd] and k, v
    [B, S, Hkv, hd], q and k rotated by the RoPE tables ``cs`` (`rope`)."""
    k, v = kv_proj(x, p, cfg)
    return apply_rope(query(x, p, cfg), cs), apply_rope(k, cs), v


def kv_proj(src, p, cfg):
    """The K and V projections of ``src`` [B, Sk, d], each [B, Sk, Hkv,
    hd], unrotated (a cross-attention source, or `qkv`'s before RoPE)."""
    B, Sk, _ = src.shape
    Hkv, hd = cfg.num_kv_heads, cfg.head_dim
    k, v = matmul(src, p["wk"]), matmul(src, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    return k.reshape(B, Sk, Hkv, hd), v.reshape(B, Sk, Hkv, hd)


def query(x, p, cfg):
    """The unrotated query projection of x [B, S, d]: [B, S, H, hd] (a
    cross-attention's query)."""
    B, S, _ = x.shape
    q = matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    return q.reshape(B, S, cfg.num_heads, cfg.head_dim)


def attention(x, p, cfg, *, cs=None, kv=None, causal=True, window=0):
    """Multi-head/GQA attention. x: [B, S, d] → [B, S, d].

    ``kv``: the cross-attention source [B, Sk, d] (whisper's decoder),
    unrotated; None ⇒ self-attention, q and k rotated by ``cs``, the RoPE
    tables of the positions (`rope`). ``causal=False`` ⇒ every key (the
    encoder, cross-attention). ``window``: 0 ⇒ full attention; > 0 ⇒ the
    last ``window`` positions."""
    if kv is None:
        q, k, v = qkv(x, p, cfg, cs)
    else:
        q, (k, v) = query(x, p, cfg), kv_proj(kv, p, cfg)
    return attn_out(attend(q, k, v, causal=causal, window=window), p)


def attn_out(out, p):
    """The output projection of attend's [B, S, H, hd]."""
    B, S, H, hd = out.shape
    return matmul(out.reshape(B, S, H * hd), p["wo"])


def attend(q, k, v, *, causal=True, window=0):
    """Core masked GQA attention on already-projected heads.

    q: [B, S, H, hd]; k/v: [B, Sk, Hkv, hd] → [B, S, H, hd], query s at
    position Sk − S + s (the keys' positions are 0 … Sk − 1). One launch of
    the attention kernel over strided views: no transposed copy."""
    out = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal, window=window)
    return out.transpose(1, 2)


def mlp(x, p, act: str = "swiglu"):
    h = matmul(x, p["w_in"])
    if act == "swiglu":
        h = F.silu(matmul(x, p["w_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")   # jax.nn.gelu's default
    return matmul(h, p["w_out"])


# ----------------------------------------------------------------------------
# Mixture of Experts (capacity dispatch, top-1 and top-2, shared expert)
# ----------------------------------------------------------------------------

#: the dense path runs its experts in groups of at most this many
#: [tokens, d_ff] elements a group (one group at decode's few tokens)
_DENSE_GROUP_ELEMS = 1 << 28


def router(xt, w, K: int):
    """Top-``K`` gates of tokens xt [T, d]: the router's logits in float32
    whatever the stream's dtype, softmax, the K largest probabilities
    renormalised by their sum (clamped at 1e-9). Returns (gates [T, K] f32,
    experts [T, K] int64). Ties go to the lower expert index, as
    ``jax.lax.top_k`` breaks them: a stable descending sort."""
    probs = torch.softmax(torch.matmul(xt.to(torch.float32), w.to(torch.float32)), -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :K], idx[:, :K]
    return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), idx


def capacity(tokens: int, E: int, K: int, capacity_factor: float = 1.25) -> int:
    """Slots an expert takes from a call over ``tokens`` tokens:
    max(int(capacity_factor · K · tokens / E), 1)."""
    return max(int(capacity_factor * K * tokens / E), 1)


def slots(experts, E: int, C: int, offset=None):
    """Capacity dispatch of the (token, k) slots ``experts`` [T, K]: each
    slot's place in its expert's queue is the running count over the flat
    (t, k) order, and a place at or past ``C`` is dropped. ``offset`` [E]
    int64 (default: zeros): slots each queue holds ahead of this call's,
    so a slot is kept while its place plus ``offset[e]`` is below ``C``;
    its column in this call's table is its own place, so the table never
    overflows. Returns (the (E, C) token table, sentinel T where no slot
    landed; each slot's row in the flattened [E·C] expert outputs, E·C
    where dropped; the kept mask [T, K])."""
    T, K = experts.shape
    e = experts.reshape(-1)
    onehot = F.one_hot(e, E)                                          # [T·K, E]
    pos = onehot.cumsum(0).gather(1, e[:, None])[:, 0] - 1
    keep = pos < C if offset is None else pos + offset[e] < C
    c = torch.where(keep, pos, C)
    table = torch.full((E, C + 1), T, dtype=torch.int64, device=e.device)
    # the dropped slots all land in column C, which is cut off
    table[e, c] = torch.arange(T, device=e.device).repeat_interleave(K)
    row = torch.where(keep, e * C + pos, E * C)
    return table[:, :C], row.reshape(T, K), keep.reshape(T, K)


def _experts(xin, p, act: str):
    """Every expert's FFN over its rows xin [E, N, d] → [E, N, d]."""
    h = matmul(xin, p["we_in"])
    if "we_gate" in p:
        h = F.silu(matmul(xin, p["we_gate"])) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return matmul(h, p["we_out"])


def _shared(p) -> dict:
    return {k[len("shared_"):]: v for k, v in p.items() if k.startswith("shared_")}


def moe(x, p, cfg, *, capacity_factor: float = 1.25, dense: bool = False,
        dispatch: str = "gather", tokens: Optional[int] = None,
        offset: Optional[torch.Tensor] = None, return_counts: bool = False):
    """Mixture-of-experts FFN. x: [B, S, d] → [B, S, d].

    * ``dispatch="gather"`` (default): the (E, C) token table of `slots`,
      C = `capacity` (``tokens``) = max(int(capacity_factor · K · tokens /
      E), 1); each expert's rows gathered, its three products, each slot's
      output scaled by its gate; a token sums its K slots in k order
      through its slot rows (no scatter-add, so no order set by atomics).
    * ``dispatch="einsum"``: the reference's one-hot formulation, [T, E, C]
      dispatch and combine tensors; it drops the same slots.
    * ``dense=True``: every expert on every token, gate-weighted, no drops
      (decode's choice); experts in groups of `_DENSE_GROUP_ELEMS`.

    A dropped slot adds nothing: the token keeps its residual only. A
    shared expert (llama4) is a dense `mlp` added on top.

    x as rows of a larger call (a data replica's rows of a microbatch):
    ``tokens`` the larger call's token count (default: this call's T) and
    ``offset`` [E] int64 the slots its earlier rows sent to each expert
    (default: none), so each slot keeps or drops as in the larger call
    (`slots`). ``return_counts``: also return this call's [E] int64 slot
    counts, dropped slots included: the next rows' offset is this one plus
    them."""
    B, S, d = x.shape
    E, K = cfg.num_experts, cfg.experts_per_token
    T = B * S
    xt = x.reshape(T, d)
    gates, experts = router(xt, p["router"], K)
    act = cfg.mlp_act
    if dense:
        full = torch.zeros((T, E), dtype=torch.float32, device=x.device)
        full = full.scatter_(1, experts, gates).to(x.dtype)
        G = max(1, min(E, _DENSE_GROUP_ELEMS // max(T * cfg.d_ff, 1)))
        y = None
        for e0 in range(0, E, G):
            grp = {k: v[e0:e0 + G] for k, v in p.items() if k.startswith("we_")}
            yo = _experts(xt[None], grp, act)                            # [G, T, d]
            part = (yo * full[:, e0:e0 + G].T[..., None]).sum(0)
            y = part if y is None else y + part
    else:
        C = capacity(T if tokens is None else tokens, E, K, capacity_factor)
        table, row, keep = slots(experts, E, C, offset)
        if dispatch == "einsum":
            dt = x.dtype
            # a kept slot's place in its expert's queue is its row mod C
            pos_oh = F.one_hot(torch.where(keep, row % C, C), C + 1)[..., :C].to(dt)
            e_oh = F.one_hot(experts, E).to(dt)                           # [T, K, E]
            disp = torch.einsum("tke,tkc->tec", e_oh, pos_oh)
            comb = torch.einsum("tke,tkc,tk->tec", e_oh, pos_oh, gates.to(dt))
            yout = _experts(torch.einsum("tec,td->ecd", disp, xt), p, act)
            y = torch.einsum("tec,ecd->td", comb.to(yout.dtype), yout)
        else:
            xin = torch.cat([xt, xt.new_zeros((1, d))])[table]           # [E, C, d]
            yout = _experts(xin, p, act).reshape(E * C, d)
            yout = torch.cat([yout, yout.new_zeros((1, d))])              # row E·C: dropped
            contrib = yout[row] * gates.to(yout.dtype)[..., None]         # [T, K, d]
            y = contrib[:, 0]
            for k in range(1, K):
                y = y + contrib[:, k]
    y = y.reshape(B, S, d)
    if "shared_w_in" in p:
        y = y + mlp(x, _shared(p), act)
    if return_counts:
        return y, F.one_hot(experts.reshape(-1), E).sum(0)
    return y


def moe_aux_loss(x, p, cfg):
    """Load-balancing auxiliary loss (Switch): E · Σ_e f_e · p̄_e, f_e the
    share of tokens whose top expert is e, p̄_e the mean router
    probability."""
    logits = torch.matmul(x.to(torch.float32), p["router"].to(torch.float32))
    probs = torch.softmax(logits, -1)
    f = F.one_hot(probs.argmax(-1), cfg.num_experts).to(torch.float32).mean((0, 1))
    return cfg.num_experts * (f * probs.mean((0, 1))).sum()
