"""The port's hybrid (hymba: attention ∥ Mamba SSM, sliding-window layers
among global ones) and encoder–decoder (whisper) serving against the JAX
package on the CPU, at smoke size: the SSM, cross-attention, the per-layer
and cross-attention caches, and for each architecture the full forward,
prefill (logits and every cache field) and greedy decode. The same
numpy-seeded inputs and the reference's own parameters (converted bit for
bit) go through both.

Tolerances: the SSM and attention layers within 1e-5; float32 logits and
caches within 2e-4 (summation order differs between XLA's einsums and
torch's matmuls, and XLA's associative scan from the port's doubling
scan); bfloat16 within the reference's bf16 2e-2.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.data.pipeline import lm_batch as j_lm_batch
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

ARCHS = ("hymba-1.5b", "whisper-small")
TOL = 2e-4
BF16_TOL = 2e-2
LAYER_TOL = 1e-5
#: a prompt longer than the smoke configs' 32-wide window, so hymba's
#: ring wraps in prefill; and greedy decode steps
B, S, STEPS = 2, 40, 3
FIELDS = ("k", "v", "kpos", "ssm_h", "ssm_tail", "xk", "xv")


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


def _ssm_layer(ref, mine):
    return (jax.tree.map(lambda a: a[0], ref["blocks"]["ssm"]),
            T._layer(mine["blocks"], 0)["ssm"])


@pytest.mark.parametrize("seq, chunk, carried", [
    (48, 16, False),     # three chunks from zero state
    (48, 16, True),      # three chunks from a carried-in state and conv tail
    (40, 16, True),      # a length the chunk does not divide: one chunk
])
def test_mamba_matches_reference(seq, chunk, carried):
    cfg_j, cfg_t, ref, mine = _both("hymba-1.5b")
    p_j, p_t = _ssm_layer(ref, mine)
    rng = np.random.default_rng(seq + chunk)
    x = rng.normal(size=(B, seq, cfg_t.d_model)).astype(np.float32)
    kw_j, kw_t = {}, {}
    if carried:
        h = rng.normal(size=(B, cfg_t.ssm_inner, cfg_t.ssm_state)).astype(np.float32)
        tail = rng.normal(size=(B, cfg_t.ssm_conv - 1, cfg_t.ssm_inner)).astype(np.float32)
        kw_j = dict(state=jnp.asarray(h), conv_tail=jnp.asarray(tail))
        kw_t = dict(state=torch.from_numpy(h), conv_tail=torch.from_numpy(tail))
    y_j, (h_j, t_j) = JS.mamba(jnp.asarray(x), p_j, cfg_j, chunk=chunk, **kw_j)
    y_t, (h_t, t_t) = SM.mamba(torch.from_numpy(x), p_t, cfg_t, chunk=chunk, **kw_t)
    close = _close(LAYER_TOL)
    close(y_t, y_j, "y")
    close(h_t, h_j, "state")
    close(t_t, t_j, "conv tail")
    assert h_t.dtype == torch.float32 and tuple(t_t.shape) == t_j.shape


def test_mamba_step_matches_reference_and_mamba():
    """Four single-token steps from a carried state: the reference's
    ``mamba_step``, and the port's ``mamba`` on one token (what decode
    runs)."""
    cfg_j, cfg_t, ref, mine = _both("hymba-1.5b")
    p_j, p_t = _ssm_layer(ref, mine)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, cfg_t.ssm_inner, cfg_t.ssm_state)).astype(np.float32)
    tail = rng.normal(size=(B, cfg_t.ssm_conv - 1, cfg_t.ssm_inner)).astype(np.float32)
    st_j = (jnp.asarray(h), jnp.asarray(tail))
    st_t = (torch.from_numpy(h), torch.from_numpy(tail))
    st_m = st_t
    close = _close(LAYER_TOL)
    for step in range(4):
        x = rng.normal(size=(B, 1, cfg_t.d_model)).astype(np.float32)
        y_j, st_j = JS.mamba_step(jnp.asarray(x), p_j, cfg_j, st_j)
        y_t, st_t = SM.mamba_step(torch.from_numpy(x), p_t, cfg_t, st_t)
        y_m, st_m = SM.mamba(torch.from_numpy(x), p_t, cfg_t, state=st_m[0],
                             conv_tail=st_m[1])
        for got in ((y_t, st_t), (y_m, st_m)):
            close(got[0], y_j, f"y, step {step}")
            close(got[1][0], st_j[0], f"state, step {step}")
            close(got[1][1], st_j[1], f"conv tail, step {step}")


def test_doubling_scan_is_the_sequential_recurrence():
    """h_t = a_t·h_{t−1} + b_t from h_{−1} = 0, step by step in float64."""
    rng = np.random.default_rng(2)
    for c in (1, 2, 7, 16, 37):
        a = rng.uniform(0.2, 1.0, size=(2, c, 3, 4))
        b = rng.normal(size=(2, c, 3, 4))
        a_s, b_s = SM._doubling_scan(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()))
        h, pa = np.zeros((2, 3, 4)), np.ones((2, 3, 4))
        for t in range(c):
            h, pa = a[:, t] * h + b[:, t], pa * a[:, t]
            np.testing.assert_allclose(b_s[:, t].numpy(), h, rtol=1e-12, atol=1e-12)
            np.testing.assert_allclose(a_s[:, t].numpy(), pa, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["cross", "encoder"])
def test_cross_and_encoder_attention_match_reference(kind):
    """Cross-attention (40 queries on 56 unrotated encoder states) and the
    encoder's non-causal self-attention (rotated), against
    ``repro.models.layers.attention``."""
    cfg_j, cfg_t, ref, mine = _both("whisper-small")
    blocks, key = ("dec_blocks", "xattn") if kind == "cross" else ("enc_blocks", "attn")
    p_j = jax.tree.map(lambda a: a[0], ref[blocks][key])
    p_t = T._layer(mine[blocks], 0)[key]
    rng = np.random.default_rng(3)
    x = rng.normal(size=(B, S, cfg_t.d_model)).astype(np.float32)
    pos = jnp.arange(S, dtype=jnp.int32)[None]
    if kind == "cross":
        src = rng.normal(size=(B, 56, cfg_t.d_model)).astype(np.float32)
        got = LY.attention(torch.from_numpy(x), p_t, cfg_t, kv=torch.from_numpy(src),
                           causal=False)
        want = JL.attention(jnp.asarray(x), p_j, cfg_j, positions=pos, kv=jnp.asarray(src),
                            kv_positions=jnp.arange(56, dtype=jnp.int32)[None],
                            causal=False)
    else:
        cs = LY.rope(torch.arange(S)[None], cfg_t.head_dim, cfg_t.rope_theta)
        got = LY.attention(torch.from_numpy(x), p_t, cfg_t, cs=cs, causal=False)
        want = JL.attention(jnp.asarray(x), p_j, cfg_j, positions=pos, causal=False)
    _close(LAYER_TOL)(got, want)


def _near_tie(logits: np.ndarray, tol: float) -> np.ndarray:
    top2 = np.sort(logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= tol


def _compare_caches(c_t, c_j, close, what):
    """Every field of every layer, with its dtype and shape; the layout
    (stacked or a tuple of layers) the same in both."""
    lt, lj = c_t.layers, c_j.layers
    assert isinstance(lt, tuple) == isinstance(lj, tuple), what
    pairs = list(zip(lt, lj, strict=True)) if isinstance(lt, tuple) else [(lt, lj)]
    for li, (a, b) in enumerate(pairs):
        for f in FIELDS:
            got, want = getattr(a, f), getattr(b, f)
            assert (got is None) == (want is None), (what, f)
            if got is None:
                continue
            assert str(got.dtype).removeprefix("torch.") == str(want.dtype), (what, f, li)
            assert tuple(got.shape) == want.shape, (what, f, li)
            if f == "kpos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want), (what, li))
            else:
                close(got, want, f"{what} {f}, layer {li}")


def _serve_both(arch, tol, **changes):
    """Full forward, prefill and STEPS greedy decode steps through both
    packages on the same inputs and parameters (whisper: ``lm_batch``'s
    frames and target tokens); the reference's greedy token feeds both at
    each step. Logits and every cache field after prefill and after the
    steps."""
    cfg_j, cfg_t, ref, mine = _both(arch, **changes)
    batch = lm_batch(cfg_t, B, S, seed=0, step=0)
    close = _close(tol)
    if cfg_t.encoder_layers:
        toks, frames = batch["target_tokens"][0], batch["frames"][0]
        assert frames.shape == (B, S, cfg_t.d_model)
        kw_j, kw_t = dict(frames=jnp.asarray(frames)), dict(frames=torch.from_numpy(frames))
        fb_j, fb_t = dict(target_tokens=jnp.asarray(toks), **kw_j), \
            dict(target_tokens=torch.from_numpy(toks), **kw_t)
    else:
        toks = batch["tokens"][0]
        kw_j, kw_t = {}, {}
        fb_j, fb_t = dict(tokens=jnp.asarray(toks)), dict(tokens=torch.from_numpy(toks))

    full_t = T.forward_logits(mine, cfg_t, fb_t)
    close(full_t, JT.forward_logits(ref, cfg_j, fb_j), "forward_logits")

    lg_j, c_j = JT.prefill(ref, cfg_j, jnp.asarray(toks), max_new_tokens=STEPS + 1, **kw_j)
    lg_t, c_t = T.prefill(mine, cfg_t, torch.from_numpy(toks), max_new_tokens=STEPS + 1,
                          **kw_t)
    close(lg_t, lg_j, "prefill logits")
    close(lg_t[:, 0], full_t[:, -1], "prefill logits against the port's forward")
    assert c_t.pos == int(c_j.pos) == S
    _compare_caches(c_t, c_j, close, "prefill cache")

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
    _compare_caches(c_t, c_j, close, "decoded cache")
    return c_t


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_matches_reference(arch):
    _serve_both(arch, TOL)


def test_hymba_bf16_serving_matches_reference():
    """hymba's smoke config in bfloat16 (the reference runs its
    heterogeneous layers unrolled): bf16 K/V caches; the SSM state and its
    conv tail stay float32, the stream's dtype, as in the reference."""
    c = _serve_both("hymba-1.5b", BF16_TOL, dtype="bfloat16")
    for layer in c.layers:
        assert layer.k.dtype == torch.bfloat16
        assert layer.ssm_h.dtype == layer.ssm_tail.dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_layout(arch):
    """hymba: a tuple of per-layer caches (a global layer of max_len, a
    32-wide ring; SSM state); whisper: one stacked cache with cross K/V of
    ``max_source_len``, or of the encoder's length from prefill."""
    cfg_t, cfg_j = R.get_smoke_config(arch), JR.get_smoke_config(arch)
    c_t = T.make_decode_cache(cfg_t, batch=3, max_len=20, device="cpu")
    c_j = JT.make_decode_cache(cfg_j, 3, 20)
    assert T.cache_is_uniform(cfg_t) == JT.cache_is_uniform(cfg_j) == (arch == "whisper-small")
    _compare_caches(c_t, c_j, _close(0), "empty cache")
    assert c_t.pos == 0
    if arch == "hymba-1.5b":
        assert [c.k.shape[1] for c in c_t.layers] == [20, 32]
    else:
        assert T.make_decode_cache(cfg_t, 3, 20, device="cpu",
                                   source_len=7).layers.xk.shape == (2, 3, 7, 4, 32)


@pytest.mark.parametrize("arch", ARCHS)
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


@pytest.mark.parametrize("arch, seq", [("whisper-small", 24), ("whisper-small", 500),
                                       ("hymba-1.5b", 24)])
def test_lm_batch_matches_reference(arch, seq):
    """whisper's batch: frames and target tokens (cut to its 448-token text
    context past 448), as the reference's."""
    mine = lm_batch(R.get_smoke_config(arch), 4, seq, seed=3, step=5, microbatches=2)
    ref = j_lm_batch(JR.get_smoke_config(arch), 4, seq, seed=3, step=5, microbatches=2)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])
    if arch == "whisper-small":
        assert mine["target_tokens"].shape[-1] == min(seq, 448)


def test_prefill_needs_frames():
    cfg = R.get_smoke_config("whisper-small")
    prm = P.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="frames"):
        T.prefill(prm, cfg, torch.zeros((1, 4), dtype=torch.int32))
