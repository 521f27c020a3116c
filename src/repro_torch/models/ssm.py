"""State-space sequence mixers: hymba's Mamba-style selective SSM and
RWKV6.

The port of ``repro.models.ssm``, in the reference's chunked forms. Mamba: projections, discretisation (the ``[B, c, di, state]``
tensors) and the scan all happen inside a loop over sequence chunks that
carries the state, so peak memory is O(B · chunk · di · state) whatever
the length. The reference's ``jax.lax.associative_scan`` over a chunk
becomes a log-step (Hillis–Steele) doubling with the same combine,
`_doubling_scan`; it differs from XLA's tree only in rounding order. RWKV6: a loop over
sequence chunks carries the [B, H, hd, hd] WKV state; inside a chunk the
work is decay-matrix linear attention (`_rwkv_wkv_chunk`).

Plain PyTorch: the reference computes all of this outside any Pallas
kernel, in einsums and ``lax.scan``.
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
    doubling steps. Serving ping-pongs between the inputs and two buffers
    of their size (which it overwrites), so a step reads each operand once
    and writes each result once. Where autograd records (training: grad
    on and an input requiring it), it refuses writes through ``out=``, so
    each step makes new tensors of the same operations in the same order:
    the values are bit-identical."""
    c, d = a.shape[1], 1
    if a.requires_grad or b.requires_grad:
        while d < c:
            b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], 1)
            a = torch.cat([a[:, :d], torch.mul(a[:, d:], a[:, :-d])], 1)
            d *= 2
        return a, b
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
    state after it [B, di, st] and its outputs [B, c, di] (f32). In place
    when serving, out of place where autograd records (the same values)."""
    st, dtr = cfg.ssm_state, cfg.ssm_dt_rank
    proj = matmul(x_c, p["x_proj"])
    dt, Bc, Cc = torch.split(proj, [dtr, st, st], dim=-1)
    dt = _softplus(matmul(dt, p["dt_proj"]) + p["dt_bias"])
    a_c = dt.to(torch.float32)[..., None] * A                             # [B, c, di, st]
    a_c = a_c.exp() if a_c.requires_grad else a_c.exp_()
    b_c = (dt * x_c).to(torch.float32)[..., None] * Bc.to(torch.float32)[:, :, None, :]
    a_s, b_s = _doubling_scan(a_c, b_c)
    taped = a_s.requires_grad or b_s.requires_grad or h.requires_grad
    h_c = (b_s.addcmul(a_s, h[:, None]) if taped
           else b_s.addcmul_(a_s, h[:, None]))                            # [B, c, di, st]
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


# ----------------------------------------------------------------------------
# RWKV6 ("Finch") time mix + channel mix
# ----------------------------------------------------------------------------

def _token_shift(x, prev):
    """x: [B, S, d]; prev: [B, 1, d] (last token of the previous segment),
    in the promoted dtype of the two (as JAX's concatenate)."""
    dt = torch.promote_types(x.dtype, prev.dtype)
    return torch.cat([prev.to(dt), x[:, :-1].to(dt)], dim=1)


def _rwkv_wkv_chunk(r, k, v, logw, u, S0, chunk: int):
    """Chunked WKV6 linear attention with data-dependent per-channel decay.

    r/k/v: [B, T, H, hd]; logw: [B, T, H, hd] (≤ 0); u: [H, hd]; S0: [B,
    H, hd, hd] carry. Returns y [B, T, H, hd] and the final state. The
    reference's chunk rule: c = min(chunk, T), and one chunk of T when c
    does not divide T (a [B, T, T, H, hd] pair tensor: keep long inputs to
    multiples of ``chunk``)."""
    B, T, H, hd = r.shape
    c = min(chunk, T)
    if T % c:
        c = T
    ar = torch.arange(c, device=r.device)
    later = (ar[:, None] > ar[None, :])[None, :, :, None, None]          # i < t
    S, ys = S0, []
    for c0 in range(0, T, c):
        rc, kc, vc, lwc = (t[:, c0:c0 + c] for t in (r, k, v, logw))
        P = torch.cumsum(lwc, dim=1) - lwc                               # Σ_{j<t}
        Pw = P + lwc                                                     # Σ_{j≤t}
        Ptot = Pw[:, -1]
        # inter-chunk: y_t += (r_t ⊙ e^{P_t}) · S
        y = torch.einsum("bthi,bhij->bthj", rc * torch.exp(P), S)
        # intra-chunk: pair (t, i < t) decays by e^{P_t − (P_i + w_i)}
        dec = torch.exp(torch.where(later, P[:, :, None] - Pw[:, None, :], -torch.inf))
        # in place when serving; exp's backward reads its output, so out
        # of place where autograd records (the same values)
        taped = dec.requires_grad or kc.requires_grad or rc.requires_grad
        scores = (dec * kc[:, None] * rc[:, :, None] if taped
                  else dec.mul_(kc[:, None]).mul_(rc[:, :, None])).sum(-1)  # [B, t, i, H]
        y = y + torch.einsum("btih,bihd->bthd", scores, vc)
        # bonus diagonal: (r_t · (u ⊙ k_t)) v_t
        y = y + (rc * u * kc).sum(-1, keepdim=True) * vc
        # S' = e^{Ptot} ⊙ S + Σ_i e^{Ptot − P_{i+1}} k_i v_iᵀ
        decs = torch.exp(Ptot[:, None] - Pw)
        S = torch.exp(Ptot)[..., None] * S + torch.einsum("bihd,bihe->bhde", kc * decs, vc)
        ys.append(y)
    return (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)), S


def rwkv_time_mix(x, p, cfg, *, prev_x=None, state=None, chunk: int = 64):
    """RWKV6 time mix over a sequence x [B, S, d] from ``prev_x`` [B, 1,
    d] (the previous segment's last input) and the WKV ``state`` [B, H,
    hd, hd] f32 (zeros by default) → (out [B, S, d], (x's last token, the
    new state)). The decay LoRA and the WKV in float32, logw = −exp(lw);
    a per-head group norm (eps 64e-5) and the SiLU gate."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    if prev_x is None:
        prev_x = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    if state is None:
        state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=x.device)
    xx = _token_shift(x, prev_x)

    def mix(mu):
        return x + (xx - x) * mu

    f32 = torch.float32
    r = matmul(mix(p["mu_r"]), p["wr"]).reshape(B, S, H, hd)
    k = matmul(mix(p["mu_k"]), p["wk_"]).reshape(B, S, H, hd)
    v = matmul(mix(p["mu_v"]), p["wv_"]).reshape(B, S, H, hd)
    g = F.silu(matmul(mix(p["mu_g"]), p["wg"]))
    lw = p["decay_w0"] + torch.einsum("bsd,dl,le->bse", torch.tanh(mix(p["mu_w"]).to(f32)),
                                      p["decay_w1"].to(f32), p["decay_w2"].to(f32))
    logw = -torch.exp(lw.to(f32)).reshape(B, S, H, hd)                   # log decay ≤ 0
    y, S_fin = _rwkv_wkv_chunk(r.to(f32), k.to(f32), v.to(f32), logw,
                               p["bonus_u"].to(f32), state, chunk)
    # per-head group norm (ln_x) + output gating
    var, mu = torch.var_mean(y, -1, correction=0, keepdim=True)
    y = ((y - mu) * torch.rsqrt(var + 64e-5)).reshape(B, S, d) * p["ln_x"]
    y = y.to(x.dtype) * g
    return matmul(y, p["w_out"]), (x[:, -1:], S_fin)


def rwkv_channel_mix(x, p, *, prev_x=None):
    """RWKV6 channel mix of x [B, S, d] from ``prev_x`` [B, 1, d] →
    (out, x's last token): squared-ReLU key, sigmoid receptance."""
    B, S, d = x.shape
    if prev_x is None:
        prev_x = torch.zeros((B, 1, d), dtype=x.dtype, device=x.device)
    xx = _token_shift(x, prev_x)
    k = torch.relu(matmul(x + (xx - x) * p["cm_mu_k"], p["cm_wk"])).square()
    kv = matmul(k, p["cm_wv"])
    r = torch.sigmoid(matmul(x + (xx - x) * p["cm_mu_r"], p["cm_wr"]))
    return r * kv, x[:, -1:]
