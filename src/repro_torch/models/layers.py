"""Transformer building blocks: norms, RoPE, GQA attention, MLP.

Plain functions over parameter subtrees of `repro_torch.models.params`, as
``repro.models.layers`` is. Attention runs the port's attention kernel
through `repro_torch.kernels.ops.flash_attention`: the Hopper kernel for
CUDA tensors, its plain twin for CPU tensors.

JAX promotes a bfloat16 operand of a product with a float32 one to float32;
``torch.matmul`` refuses mixed dtypes, so `matmul` makes that promotion
explicit, at the places the reference's einsums make it. Elementwise
operations promote the same way in both frameworks. Left out: the mesh
constraints (``act_constrain``, a no-op without a mesh), MoE, and the
query-chunked and local-window XLA attention paths, which the kernel
replaces. RoPE's tables are computed once a forward (`rope`) and
applied per layer (`apply_rope`), where the reference's ``rotary`` does
both per layer; the numbers are the same.
"""
from __future__ import annotations

import math

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
