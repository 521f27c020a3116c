"""The port's MoE (grok-1: an MoE FFN in every layer, top-2; llama4:
interleaved dense/MoE pairs, top-1 with a shared expert) and RWKV6 serving
against the JAX package on the CPU, at smoke size: the router, capacity
dispatch (its slot table and drop set exactly), the three MoE modes, the
load-balancing loss, the WKV recurrence, time and channel mix, and for
each architecture the full forward, prefill (logits and every cache
field) and greedy decode. The same numpy-seeded inputs and the
reference's own parameters (converted bit for bit) go through both.

The reference's bfloat16 configs raise where it scans over layers (its
scan carry changes dtype after the first layer's float32 norm scale), so
the bf16 cases hold the port to the reference's layers run unrolled on
the same inputs (`_unrolled_reference`): llama4, rwkv6 and whisper.

Tolerances: layers within 1e-5; float32 logits and caches within 2e-4
(summation order differs between XLA's einsums and torch's matmuls);
bfloat16 within the reference's bf16 2e-2; integers exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import params as JP
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import lm_batch
from repro_torch.models import layers as LY
from repro_torch.models import params as P
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as T

MOE = ("grok-1-314b", "llama4-maverick-400b-a17b")
ARCHS = MOE + ("rwkv6-3b",)
TOL = 2e-4
BF16_TOL = 2e-2
LAYER_TOL = 1e-5
B, STEPS = 2, 3
#: prompt tokens: rwkv6's cover two WKV chunks of 64
PROMPT = {"rwkv6-3b": 128}
FIELDS = tuple(f.name for f in dataclasses.fields(T.LayerCache))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _close(tol):
    return lambda a, b, what="": np.testing.assert_allclose(
        _np(a), _np(b), rtol=tol, atol=tol, err_msg=what)


def _both(arch, **changes):
    """(reference config, port config, reference params, port params)."""
    cfg_j = dataclasses.replace(JR.get_smoke_config(arch), **changes)
    cfg_t = dataclasses.replace(R.get_smoke_config(arch), **changes)
    ref = JP.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, ref, convert.lm_params_from_reference(
        jax.tree.map(np.asarray, ref), "cpu")


def _first_layer(ref, mine, key=None):
    """Layer 0's parameters (``key``'s subtree) in both packages."""
    p_j = jax.tree.map(lambda a: a[0], ref["blocks"])
    p_t = T._layer(mine["blocks"], 0)
    return (p_j, p_t) if key is None else (p_j[key], p_t[key])


def _x(rng, cfg, seq=16):
    return rng.normal(size=(B, seq, cfg.d_model)).astype(np.float32)


# ----------------------------------------------------------------------------
# MoE
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("mode, capacity_factor", [
    ("gather", 1.25), ("gather", 0.5), ("einsum", 0.5), ("dense", 1.25)])
def test_moe_matches_reference(arch, mode, capacity_factor):
    """x [2, 16, d]: at capacity factor 0.5 about half of the slots drop."""
    cfg_j, cfg_t, ref, mine = _both(arch)
    p_j, p_t = _first_layer(ref, mine, "moe")
    x = _x(np.random.default_rng(len(arch) + int(4 * capacity_factor)), cfg_t)
    kw = dict(capacity_factor=capacity_factor, dense=mode == "dense",
              dispatch="einsum" if mode == "einsum" else "gather")
    got = LY.moe(torch.from_numpy(x), p_t, cfg_t, **kw)
    want = JL.moe(jnp.asarray(x), p_j, cfg_j, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    _close(LAYER_TOL)(got, want)


def _reference_dispatch(x, p_j, cfg, capacity_factor):
    """The reference's gate indices, its (E, C) token table and its kept
    mask, by `repro.models.layers.moe`'s own lines."""
    T_, E, K = x.shape[0] * x.shape[1], cfg.num_experts, cfg.experts_per_token
    xt = jnp.asarray(x).reshape(T_, -1)
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xt, p_j["router"]), -1)
    _, gate_idx = jax.lax.top_k(probs, K)
    C = max(int(capacity_factor * K * T_ / E), 1)
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(T_ * K, E)
    pos = (jnp.cumsum(flat, axis=0) * flat - 1).reshape(T_, K, E).max(-1)
    keep = (pos < C) & (pos >= 0)
    c_flat = jnp.where(keep, pos, C).reshape(-1)
    idx = jnp.full((E, C + 1), T_, jnp.int32)
    idx = idx.at[gate_idx.reshape(-1), c_flat].set(
        jnp.repeat(jnp.arange(T_, dtype=jnp.int32), K), mode="drop")[:, :C]
    return np.asarray(gate_idx), np.asarray(idx), np.asarray(keep), C


@pytest.mark.parametrize("arch", MOE)
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_slot_table_and_drops_match_reference(arch, capacity_factor):
    """The router's experts, the (E, C) table and the drop set: equal."""
    cfg_j, cfg_t, ref, mine = _both(arch)
    p_j, p_t = _first_layer(ref, mine, "moe")
    x = _x(np.random.default_rng(7), cfg_t)
    want_e, want_table, want_keep, C = _reference_dispatch(x, p_j, cfg_j, capacity_factor)
    gates, experts = LY.router(torch.from_numpy(x).reshape(-1, cfg_t.d_model),
                               p_t["router"], cfg_t.experts_per_token)
    np.testing.assert_array_equal(experts.numpy(), want_e)
    assert gates.dtype == torch.float32
    table, row, keep = LY.slots(experts, cfg_t.num_experts, C)
    np.testing.assert_array_equal(table.numpy(), want_table)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    # each kept slot's output row is its (expert, place) cell of the table
    e, r = experts.numpy(), row.numpy()
    t = np.arange(e.shape[0])[:, None].repeat(e.shape[1], 1)
    assert (r[~want_keep] == cfg_t.num_experts * C).all()
    np.testing.assert_array_equal(want_table.reshape(-1)[r[want_keep]], t[want_keep])
    assert (r[want_keep] // C == e[want_keep]).all()
    if capacity_factor < 1:
        assert (~want_keep).sum() > 0


@pytest.mark.parametrize("arch", MOE)
def test_zero_router_ties_pick_the_reference_experts(arch):
    """A zero router ties every probability: the lowest expert indices win,
    as with ``jax.lax.top_k``, and the layer equals the reference's."""
    cfg_j, cfg_t, ref, mine = _both(arch)
    p_j, p_t = _first_layer(ref, mine, "moe")
    p_j = dict(p_j, router=jnp.zeros_like(p_j["router"]))
    p_t = dict(p_t, router=torch.zeros_like(p_t["router"]))
    x = _x(np.random.default_rng(3), cfg_t)
    gates, experts = LY.router(torch.from_numpy(x).reshape(-1, cfg_t.d_model),
                               p_t["router"], cfg_t.experts_per_token)
    K = cfg_t.experts_per_token
    assert (experts == torch.arange(K)).all() and torch.allclose(gates, torch.full_like(gates, 1 / K))
    for kw in (dict(), dict(capacity_factor=0.5), dict(dense=True)):
        _close(LAYER_TOL)(LY.moe(torch.from_numpy(x), p_t, cfg_t, **kw),
                          JL.moe(jnp.asarray(x), p_j, cfg_j, **kw), str(kw))


@pytest.mark.parametrize("arch", MOE)
def test_moe_aux_loss_matches_reference(arch):
    cfg_j, cfg_t, ref, mine = _both(arch)
    p_j, p_t = _first_layer(ref, mine, "moe")
    x = _x(np.random.default_rng(5), cfg_t)
    got = LY.moe_aux_loss(torch.from_numpy(x), p_t, cfg_t)
    _close(LAYER_TOL)(got, JL.moe_aux_loss(jnp.asarray(x), p_j, cfg_j))
    assert got.dtype == torch.float32 and got.shape == ()


# ----------------------------------------------------------------------------
# RWKV6
# ----------------------------------------------------------------------------

def _wkv_inputs(rng, seq, H=4, hd=8, carried=True):
    r, k, v = (rng.normal(size=(B, seq, H, hd)).astype(np.float32) for _ in range(3))
    logw = -np.exp(rng.normal(scale=0.5, size=(B, seq, H, hd))).astype(np.float32)
    u = rng.normal(size=(H, hd)).astype(np.float32)
    S0 = (rng.normal(size=(B, H, hd, hd)) if carried
          else np.zeros((B, H, hd, hd))).astype(np.float32)
    return r, k, v, logw, u, S0


@pytest.mark.parametrize("seq, chunk, carried", [
    (48, 16, False),     # three chunks from zero state
    (48, 16, True),      # three chunks from a carried state
    (40, 16, True),      # a length the chunk does not divide: one chunk
])
def test_wkv_chunk_matches_reference(seq, chunk, carried):
    """In float64 in both packages (the reference under
    ``jax.enable_x64``), within 1e-10. In float32 the two differ by the
    rounding of the running log-decay sums, whose differences it
    exponentiates (XLA's cumsum associates otherwise than torch's): ≈ 5e-5
    on outputs of ≈ 30 over a 40-token chunk here, each package as far
    from the float64 value as the other."""
    args = [a.astype(np.float64) for a in
            _wkv_inputs(np.random.default_rng(seq + chunk), seq, carried=carried)]
    y_t, s_t = SM._rwkv_wkv_chunk(*map(torch.from_numpy, args), chunk)
    with jax.enable_x64(True):
        y_j, s_j = JS._rwkv_wkv_chunk(*map(jnp.asarray, args), chunk)
        assert y_j.dtype == jnp.float64
        y_j, s_j = np.asarray(y_j), np.asarray(s_j)
    assert y_t.dtype == s_t.dtype == torch.float64
    for got, want in ((y_t, y_j), (s_t, s_j)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


def test_wkv_chunk_is_the_sequential_recurrence():
    """y_t = r_t · (S + diag(u) k_t v_tᵀ), S ← diag(e^{logw_t}) S + k_t v_tᵀ,
    token by token in float64 from a carried state."""
    r, k, v, logw, u, S0 = (a.astype(np.float64) for a in
                            _wkv_inputs(np.random.default_rng(11), 37))
    for chunk in (64, 8, 1):     # one chunk of 37; chunks of 8 cannot divide 37
        y_t, s_t = SM._rwkv_wkv_chunk(*map(torch.from_numpy, (r, k, v, logw, u, S0)), chunk)
        S = S0.copy()
        for t in range(r.shape[1]):
            kv = k[:, t, :, :, None] * v[:, t, :, None, :]           # [B, H, hd, hd]
            y = np.einsum("bhi,bhij->bhj", r[:, t], S + u[None, :, :, None] * kv)
            np.testing.assert_allclose(y_t[:, t].numpy(), y, rtol=1e-10, atol=1e-10)
            S = np.exp(logw[:, t])[..., None] * S + kv
        np.testing.assert_allclose(s_t.numpy(), S, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("part", ["time", "channel"])
@pytest.mark.parametrize("carried", [False, True])
def test_rwkv_mixes_match_reference(part, carried):
    """Time mix over 128 tokens in eight WKV chunks of 16 and channel mix,
    from zero state or from the token-shift input and WKV state that a
    previous segment leaves. Channel mix within 1e-5 elementwise; time mix
    within 1e-5 of its largest output: it computes its WKV in float32
    whatever the input, and two float32 evaluations of it differ by ≈ 1e-5
    at outputs of ≈ 0.3 (the port 1.3e-5 from a float64 evaluation of the
    same formulas where the reference is 0.8e-5, and elsewhere the other
    way round); at the default 64-token chunks the running log-decay
    sums' rounding (`test_wkv_chunk_matches_reference`) reaches 2e-5–8e-5
    of outputs of ≈ 3; the serving tests run 64."""
    cfg_j, cfg_t, ref, mine = _both("rwkv6-3b")
    p_j, p_t = _first_layer(ref, mine)
    rng = np.random.default_rng(int(carried))
    x = _x(rng, cfg_t, seq=128)
    kw_j, kw_t = {}, {}
    if carried:
        # the state a previous 16-token segment leaves, by the reference
        x0 = jnp.asarray(_x(rng, cfg_t))
        if part == "time":
            _, (prev, s) = JS.rwkv_time_mix(x0, p_j, cfg_j)
            kw_j, kw_t = dict(state=s), dict(state=torch.from_numpy(np.array(s)))
        else:
            _, prev = JS.rwkv_channel_mix(x0, p_j)
        kw_j["prev_x"], kw_t["prev_x"] = prev, torch.from_numpy(np.array(prev))
    close = _close(LAYER_TOL)
    if part == "time":
        y_t, (last_t, s_t) = SM.rwkv_time_mix(torch.from_numpy(x), p_t, cfg_t, chunk=16,
                                              **kw_t)
        y_j, (last_j, s_j) = JS.rwkv_time_mix(jnp.asarray(x), p_j, cfg_j, chunk=16, **kw_j)
        close(s_t, s_j, "state")
        assert s_t.dtype == torch.float32
    else:
        y_t, last_t = SM.rwkv_channel_mix(torch.from_numpy(x), p_t, **kw_t)
        y_j, last_j = JS.rwkv_channel_mix(jnp.asarray(x), p_j, **kw_j)
    if part == "time":
        err = np.abs(_np(y_t) - _np(y_j)).max() / np.abs(_np(y_j)).max()
        assert err <= LAYER_TOL, err
    else:
        close(y_t, y_j, "y")
    np.testing.assert_array_equal(last_t.numpy(), np.asarray(last_j))


# ----------------------------------------------------------------------------
# serving
# ----------------------------------------------------------------------------

def _unrolled_blocks(x, blocks, cfg, positions, *, causal=True, enc_out=None,
                     enc_positions=None, remat=True, moe_dense=False,
                     remat_policy="nothing"):
    """``repro.models.transformer._scan_blocks`` run layer by layer (its own
    branch for heterogeneous windows), so a bf16 stream may change dtype."""
    windows = (JT.layer_windows(cfg) if causal
               else np.zeros((cfg.encoder_layers,), np.int32))
    for li in range(windows.shape[0]):
        x, _ = JT.block(x, jax.tree.map(lambda a: a[li], blocks), cfg, positions=positions,
                        window=int(windows[li]), causal=causal, enc_out=enc_out,
                        enc_positions=enc_positions, moe_dense=moe_dense)
    return x


def _unrolled_reference(monkeypatch):
    """The reference's layers run unrolled: its forward and encoder loop
    over layers, and its caches stay per-layer tuples, which its
    ``decode_step`` decodes layer by layer."""
    monkeypatch.setattr(JT, "_scan_blocks", _unrolled_blocks)
    monkeypatch.setattr(JT, "cache_is_uniform", lambda cfg: False)


def _near_tie(logits: np.ndarray, tol: float) -> np.ndarray:
    top2 = np.sort(logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= tol


def _compare_caches(c_t, c_j, close, what, same_dtypes=True):
    """Every field of every layer, with its shape (and, unless told
    otherwise, its dtype). The layouts agree, or the reference's is a
    tuple of layers where the port's is stacked (the unrolled reference)."""
    lt, lj = c_t.layers, c_j.layers
    if isinstance(lt, tuple) == isinstance(lj, tuple):
        pairs = list(zip(lt, lj, strict=True)) if isinstance(lt, tuple) else [(lt, lj)]
    else:
        assert isinstance(lj, tuple), what
        pairs = list(zip(T._per_layer(lt), lj, strict=True))
    for li, (a, b) in enumerate(pairs):
        for f in FIELDS:
            got, want = getattr(a, f), getattr(b, f)
            assert (got is None) == (want is None), (what, f)
            if got is None:
                continue
            if same_dtypes:
                assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (what, f, li)
            assert tuple(got.shape) == want.shape, (what, f, li)
            if f.startswith("kpos"):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), (what, li))
            else:
                close(got, want, f"{what} {f}, layer {li}")


def _serve_both(arch, tol, monkeypatch=None, **changes):
    """Full forward, prefill and STEPS greedy decode steps through both
    packages on the same inputs and parameters (whisper: ``lm_batch``'s
    frames and target tokens); the reference's greedy token feeds both at
    each step. MoE: forward and prefill with gather dispatch (the same
    tokens, so the same capacity and drops) and prefill with
    ``moe_dense=True``; decode (dense) from the gather prefill's cache.
    Logits and every cache field after prefill and after the steps. With
    ``monkeypatch``, against the reference's layers run unrolled."""
    unrolled = monkeypatch is not None
    if unrolled:
        _unrolled_reference(monkeypatch)
    cfg_j, cfg_t, ref, mine = _both(arch, **changes)
    S = PROMPT.get(arch, 24)
    batch = lm_batch(cfg_t, B, S, seed=0, step=0)
    close = _close(tol)
    if cfg_t.encoder_layers:
        toks, frames = batch["target_tokens"][0], batch["frames"][0]
        kw_j, kw_t = dict(frames=jnp.asarray(frames)), dict(frames=torch.from_numpy(frames))
        fb_j, fb_t = dict(target_tokens=jnp.asarray(toks), **kw_j), \
            dict(target_tokens=torch.from_numpy(toks), **kw_t)
    else:
        toks = batch["tokens"][0]
        kw_j, kw_t = {}, {}
        fb_j, fb_t = dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(toks))

    full_t = T.forward_logits(mine, cfg_t, fb_t)
    close(full_t, JT.forward_logits(ref, cfg_j, fb_j), "forward_logits")

    if cfg_t.num_experts:
        lg_j, c_j = JT.prefill(ref, cfg_j, jnp.asarray(toks), max_new_tokens=STEPS + 1,
                               moe_dense=True)
        lg_t, c_t = T.prefill(mine, cfg_t, torch.from_numpy(toks), max_new_tokens=STEPS + 1,
                              moe_dense=True)
        close(lg_t, lg_j, "dense prefill logits")
        _compare_caches(c_t, c_j, close, "dense prefill cache", not unrolled)
    lg_j, c_j = JT.prefill(ref, cfg_j, jnp.asarray(toks), max_new_tokens=STEPS + 1, **kw_j)
    lg_t, c_t = T.prefill(mine, cfg_t, torch.from_numpy(toks), max_new_tokens=STEPS + 1,
                          **kw_t)
    close(lg_t, lg_j, "prefill logits")
    close(lg_t[:, 0], full_t[:, -1], "prefill logits against the port's forward")
    assert c_t.pos == int(c_j.pos) == S
    _compare_caches(c_t, c_j, close, "prefill cache", not unrolled)

    lg_j, lg_t = np.asarray(lg_j[:, -1]), lg_t[:, -1]
    for step in range(STEPS):
        want_tok = lg_j.argmax(-1)
        tie = _near_tie(lg_j, tol)
        assert (lg_t.argmax(-1).numpy()[~tie] == want_tok[~tie]).all(), step
        cur = want_tok[:, None].astype(np.int32)
        lg_j, c_j = JT.decode_step(ref, cfg_j, c_j, jnp.asarray(cur))
        lg_t, c_t = T.decode_step(mine, cfg_t, c_t, torch.from_numpy(cur))
        close(lg_t, lg_j, f"decode step {step}")
        lg_j, lg_t = np.asarray(lg_j[:, -1]), lg_t[:, -1]
        assert c_t.pos == int(c_j.pos) == S + step + 1
    _compare_caches(c_t, c_j, close, "decoded cache", not unrolled)
    return c_t


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(arch):
    _serve_both(arch, TOL)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "rwkv6-3b", "whisper-small"])
def test_bf16_serving_matches_unrolled_reference(arch, monkeypatch):
    """The smoke configs in bfloat16 against the reference's layers run
    unrolled (its scans over layers raise on a bf16 stream): bf16 K/V and
    token-shift caches; RWKV6's WKV state float32."""
    c = _serve_both(arch, BF16_TOL, monkeypatch, dtype="bfloat16")
    for f, t in c.layers.tensors():
        want = torch.int32 if f.startswith("kpos") else (
            torch.float32 if f == "rwkv_s" else torch.bfloat16)
        assert t.dtype == want, f


@pytest.mark.parametrize("arch", MOE)
def test_dense_prefill_and_decode_match_forward(arch):
    """The reference's cache check on the port: with ``moe_dense=True``
    on both sides, prefill and decode logits equal the full forward's."""
    cfg = R.get_smoke_config(arch)
    prm = P.init_params(cfg, seed=1, device="cpu")
    toks = torch.from_numpy(lm_batch(cfg, B, 24 + STEPS, seed=1, step=0)["tokens"][0])
    full = T.forward_logits(prm, cfg, {"tokens": toks}, moe_dense=True)
    lg, cache = T.prefill(prm, cfg, toks[:, :24], max_new_tokens=STEPS, moe_dense=True)
    close = _close(TOL)
    close(lg[:, 0], full[:, 23], "prefill")
    for t in range(STEPS):
        lg, cache = T.decode_step(prm, cfg, cache, toks[:, 24 + t:25 + t])
        close(lg[:, 0], full[:, 24 + t], f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_layout(arch):
    """Stacked caches: grok-1 one K/V ring a layer; llama4 two a pair
    (k2/v2/kpos2); rwkv6 no K/V, its WKV state float32 and its token-shift
    inputs in the cache's dtype."""
    cfg_t, cfg_j = R.get_smoke_config(arch), JR.get_smoke_config(arch)
    c_t = T.make_decode_cache(cfg_t, batch=3, max_len=20, device="cpu")
    c_j = JT.make_decode_cache(cfg_j, 3, 20)
    assert T.cache_is_uniform(cfg_t) == JT.cache_is_uniform(cfg_j) is True
    _compare_caches(c_t, c_j, _close(0), "empty cache")
    assert c_t.pos == 0
    names = [f for f, _ in c_t.layers.tensors()]
    if arch == "rwkv6-3b":
        H, hd = cfg_t.d_model // cfg_t.rwkv_head_dim, cfg_t.rwkv_head_dim
        assert names == ["rwkv_s", "rwkv_prev_tm", "rwkv_prev_cm"]
        assert c_t.layers.rwkv_s.shape == (2, 3, H, hd, hd)
        assert c_t.layers.rwkv_prev_tm.shape == (2, 3, 1, cfg_t.d_model)
        bf = T.make_decode_cache(dataclasses.replace(cfg_t, dtype="bfloat16"), 3, 20,
                                 device="cpu").layers
        assert (bf.rwkv_s.dtype, bf.rwkv_prev_cm.dtype) == (torch.float32, torch.bfloat16)
    elif arch == "grok-1-314b":
        assert names == ["k", "v", "kpos"]
    else:
        assert names == ["k", "v", "kpos", "k2", "v2", "kpos2"]
        assert c_t.layers.k2.shape == (1, 3, 20, cfg_t.num_kv_heads, cfg_t.head_dim)


@pytest.mark.parametrize("arch", ["llama4-maverick-400b-a17b", "rwkv6-3b"])
def test_param_conversion_is_exact(arch):
    cfg = JR.get_smoke_config(arch)
    ref = JP.init_params(cfg, jax.random.PRNGKey(0))
    mine = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == sum(1 for _ in P._leaves(P.param_specs(R.get_smoke_config(arch))))
    for path, leaf in flat:
        t = mine
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
