"""Mamba-style selective SSM: hymba's parallel head.

The port of the Mamba half of ``repro.models.ssm``, in the reference's
chunked form: projections, discretisation (the ``[B, c, di, state]``
tensors) and the scan all happen inside a loop over sequence chunks that
carries the state, so peak memory is O(B · chunk · di · state) whatever
the length. The reference's ``jax.lax.associative_scan`` over a chunk
becomes a log-step (Hillis–Steele) doubling with the same combine,
`_doubling_scan`; it differs from XLA's tree only in rounding order.

Plain PyTorch: the reference computes all of this outside any Pallas
kernel. RWKV6's time and channel mixing are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import matmul


def _softplus(x):
    """``jax.nn.softplus``: log(1 + eˣ) as logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x, w):
    """Depthwise causal conv. x: [B, S, di], w: [K, di] (K small, unrolled)."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(1, K):
        shifted = F.pad(x, (0, 0, i, 0))[:, : x.shape[1]]
        out = out + shifted * w[K - 1 - i]
    return out


def _doubling_scan(a, b):
    """Inclusive scan along dim 1 of the affine maps h ↦ a·h + b: returns
    (A, B) with (A[:, t], B[:, t]) the composition of steps 0 … t, the
    reference's combine (a_l·a_r, a_r·b_l + b_r) applied in ⌈log2 c⌉
    doubling steps. Ping-pongs between the inputs and two buffers of their
    size (which it overwrites), so a step reads each operand once and
    writes each result once."""
    c, d = a.shape[1], 1
    if c > 1:
        a2, b2 = torch.empty_like(a), torch.empty_like(b)
    while d < c:
        a2[:, :d], b2[:, :d] = a[:, :d], b[:, :d]
        torch.addcmul(b[:, d:], a[:, d:], b[:, :-d], out=b2[:, d:])
        torch.mul(a[:, d:], a[:, :-d], out=a2[:, d:])
        a, b, a2, b2 = a2, b2, a, b
        d *= 2
    return a, b


def _chunk_step(h, x_c, p, cfg, A):
    """One chunk x_c [B, c, di]: project, discretise, scan; returns the
    state after it [B, di, st] and its outputs [B, c, di] (f32)."""
    st, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    proj = matmul(x_c, p["x_proj"])
    dt, Bc, Cc = torch.split(proj, [dtr, st, st], dim=-1)
    dt = _softplus(matmul(dt, p["dt_proj"]) + p["dt_bias"])
    a_c = (dt.to(torch.float32)[..., None] * A).exp_()                   # [B, c, di, st]
    b_c = (dt * x_c).to(torch.float32)[..., None] * Bc.to(torch.float32)[:, :, None, :]
    a_s, b_s = _doubling_scan(a_c, b_c)
    h_c = b_s.addcmul_(a_s, h[:, None])                                   # [B, c, di, st]
    y_c = torch.matmul(h_c, Cc.to(torch.float32)[..., None])[..., 0]
    return h_c[:, -1].clone(), y_c     # a copy: a view would keep h_c alive


def _ssm_inner(xz, p, cfg, h0, conv_tail, chunk: int):
    """Shared selective-scan core. xz: [B, S, 2·di] (after in_proj) →
    (y [B, S, di] in xz's dtype, the last state, the new conv tail)."""
    B, S, _ = xz.shape
    x, z = torch.chunk(xz, 2, dim=-1)
    # causal depthwise conv with carry-in tail from the previous segment
    K = cfg.ssm_conv
    xc = torch.cat([conv_tail, x], dim=1)
    x = _causal_conv(xc, p["conv_w"])[:, K - 1:]
    new_tail = xc[:, -(K - 1):].clone() if K > 1 else conv_tail
    x = F.silu(x)
    A = -torch.exp(p["a_log"].to(torch.float32))                          # [di, st]
    h, ys = h0, []
    for c0 in range(0, S, chunk):
        h, y_c = _chunk_step(h, x[:, c0:c0 + chunk], p, cfg, A)
        ys.append(y_c)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    y = (y + x.to(torch.float32) * p["d_skip"].to(torch.float32)).to(xz.dtype)
    return y * F.silu(z), h, new_tail


def mamba(x, p, cfg, *, chunk: int = 256, state=None, conv_tail=None):
    """Full-sequence selective SSM. x: [B, S, d] → (y, (h, conv_tail)): h
    [B, di, st] f32, the conv tail [B, K − 1, di] in the stream's dtype
    (the promoted dtype of the carried-in tail and x)."""
    B, S, _ = x.shape
    di, st, K = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_conv
    if state is None:
        state = torch.zeros((B, di, st), dtype=torch.float32, device=x.device)
    if conv_tail is None:
        conv_tail = torch.zeros((B, K - 1, di), dtype=x.dtype, device=x.device)
    chunk = min(chunk, S)
    if S % chunk:
        chunk = S  # a length the chunk does not divide runs as one chunk
    xz = matmul(x, p["in_proj"])
    y, h, tail = _ssm_inner(xz, p, cfg, state, conv_tail, chunk)
    return matmul(y, p["out_proj"]), (h, tail)


def mamba_step(x1, p, cfg, state):
    """Single-token step. x1: [B, 1, d]; state = (h [B, di, st], tail
    [B, K − 1, di]) → (y [B, 1, d], (h, tail)). The reference's decode
    runs `mamba` on the one token instead, and so does the port's."""
    h, tail = state
    st, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    xz = matmul(x1, p["in_proj"])
    x, z = torch.chunk(xz, 2, dim=-1)                                    # [B, 1, di]
    window = torch.cat([tail, x], dim=1)                                 # [B, K, di]
    xconv = (window * p["conv_w"]).sum(1)[:, None]
    new_tail = window[:, 1:]
    xa = F.silu(xconv)
    proj = matmul(xa, p["x_proj"])
    dt, Bc, Cc = torch.split(proj, [dtr, st, st], dim=-1)
    dt = _softplus(matmul(dt, p["dt_proj"]) + p["dt_bias"])
    A = -torch.exp(p["a_log"].to(torch.float32))
    dA = torch.exp(dt.to(torch.float32)[..., None] * A)[:, 0]
    dBx = ((dt * xa).to(torch.float32)[..., None]
           * Bc.to(torch.float32)[:, :, None, :])[:, 0]
    h = dA * h + dBx                                                     # [B, di, st]
    y = torch.matmul(h, Cc[:, 0].to(torch.float32)[..., None])[..., 0]
    y = y + xa[:, 0].to(torch.float32) * p["d_skip"].to(torch.float32)
    y = y[:, None].to(x1.dtype) * F.silu(z)
    return matmul(y, p["out_proj"]), (h, new_tail)
