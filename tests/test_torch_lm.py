"""The port's LM substrate (dense family) against the JAX package on the
CPU, at smoke size: configs, parameter counts and conversion, the layers,
and for each dense architecture the full forward, prefill (logits and
cache) and greedy decode. The same numpy-seeded tokens and the reference's
own parameters (converted bit for bit) go through both.

Tolerances: float32 logits within 2e-4 (summation order differs between
XLA's einsums and torch's matmuls); bfloat16 configs within the
reference's bf16 2e-2; layers within 1e-5.
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
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import lm_batch
from repro_torch.models import layers as LY
from repro_torch.models import params as P
from repro_torch.models import transformer as T

DENSE = ("tinyllama-1.1b", "qwen1.5-0.5b", "phi3-mini-3.8b", "starcoder2-15b",
         "llava-next-mistral-7b")
TOL = 2e-4
BF16_TOL = 2e-2
B, S, STEPS = 2, 16, 3


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _ref_params(cfg):
    return JP.init_params(cfg, jax.random.PRNGKey(0))


def _port_params(ref):
    return convert.lm_params_from_reference(jax.tree.map(np.asarray, ref), "cpu")


def test_configs_and_param_counts_match_reference():
    assert sorted(R.ARCHS) == sorted(JR.ARCHS)
    for name in R.ARCHS:
        mine, ref = R.get_config(name), JR.get_config(name)
        assert dataclasses.asdict(mine) == dataclasses.asdict(ref), name
        assert (dataclasses.asdict(R.get_smoke_config(name))
                == dataclasses.asdict(JR.get_smoke_config(name))), name
        assert mine.param_count() == ref.param_count(), name
        assert mine.active_param_count() == ref.active_param_count(), name
        assert (mine.q_dim, mine.kv_dim, mine.is_moe_layer(1)) == \
            (ref.q_dim, ref.kv_dim, ref.is_moe_layer(1))
    with pytest.raises(KeyError):
        R.get_config("no-such-arch")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "llava-next-mistral-7b"])
def test_lm_batch_matches_reference(arch):
    cfg = R.get_smoke_config(arch)
    mine = lm_batch(cfg, 4, 24, seed=3, step=5, microbatches=2)
    ref = j_lm_batch(JR.get_smoke_config(arch), 4, 24, seed=3, step=5,
                     microbatches=2)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k])


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b",
                                  "llava-next-mistral-7b", "grok-1-314b"])
def test_param_conversion_is_exact(arch):
    cfg = JR.get_smoke_config(arch)
    ref = _ref_params(cfg)
    mine = _port_params(ref)
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert len(flat) == sum(1 for _ in P._leaves(P.param_specs(R.get_smoke_config(arch))))
    for path, leaf in flat:
        t = mine
        for k in path:
            t = t[k.key]
        assert t.dtype == torch.float32 and tuple(t.shape) == leaf.shape
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))


def test_init_params_draws_the_reference_scales():
    """Same tree, shapes and f32; normal leaves with std scale/√fan_in
    (embeddings 0.02), zeros and ones where the specs say."""
    cfg = dataclasses.replace(R.get_smoke_config("qwen1.5-0.5b"), d_model=256,
                              d_ff=512)
    mine = P.init_params(cfg, seed=1, device="cpu")
    again = P.init_params(cfg, seed=1, device="cpu")
    for path, spec in P._leaves(P.param_specs(cfg)):
        t, t2 = mine, again
        for k in path:
            t, t2 = t[k], t2[k]
        assert t.dtype == torch.float32 and tuple(t.shape) == spec.shape
        assert torch.equal(t, t2)
        if spec.init in ("zeros", "ones"):
            assert torch.equal(t, torch.full_like(t, spec.init == "ones"))
            continue
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 0.02 * spec.scale if spec.init == "embed" else spec.scale / np.sqrt(fan_in)
        assert abs(float(t.std()) / std - 1) < 0.05, path
    assert not torch.equal(mine["embed"],
                           P.init_params(cfg, seed=2, device="cpu")["embed"])


def test_layers_match_reference():
    cfg = JR.get_smoke_config("qwen1.5-0.5b")      # QKV bias
    ref = _ref_params(cfg)
    mine = _port_params(ref)
    p_ref = jax.tree.map(lambda a: a[0], ref["blocks"])
    p = T._layer(mine["blocks"], 0)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    xt, xj = torch.from_numpy(x), jnp.asarray(x)
    close = lambda a, b: np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    scale = rng.normal(size=cfg.d_model).astype(np.float32)
    close(LY.rms_norm(xt, torch.from_numpy(scale)), JL.rms_norm(xj, jnp.asarray(scale)))
    # a bf16 input is rounded to bf16 before the f32 scale, as in the reference
    xb = LY.rms_norm(xt.to(torch.bfloat16), torch.from_numpy(scale))
    assert xb.dtype == torch.float32
    close(xb, JL.rms_norm(xj.astype(jnp.bfloat16), jnp.asarray(scale)))
    pos = np.arange(S, dtype=np.int32)[None] + 7
    heads = x.reshape(B, S, 4, 32)
    close(LY.apply_rope(torch.from_numpy(heads), LY.rope(torch.from_numpy(pos), 32, 1e6)),
          JL.rotary(jnp.asarray(heads), jnp.asarray(pos), 1e6))
    posj = jnp.arange(S, dtype=jnp.int32)[None]
    close(LY.attention(xt, p["attn"], cfg,
                       cs=LY.rope(torch.arange(S)[None], cfg.head_dim, cfg.rope_theta)),
          JL.attention(xj, p_ref["attn"], cfg, positions=posj))
    close(LY.mlp(xt, p["mlp"], "swiglu"), JL.mlp(xj, p_ref["mlp"], "swiglu"))
    w = {k: torch.from_numpy(rng.normal(size=s).astype(np.float32) / 8)
         for k, s in (("w_in", (cfg.d_model, 64)), ("w_out", (64, cfg.d_model)))}
    close(LY.mlp(xt, w, "gelu"),
          JL.mlp(xj, {k: jnp.asarray(v.numpy()) for k, v in w.items()}, "gelu"))


def _near_tie(logits: np.ndarray, tol: float) -> np.ndarray:
    """Rows whose two largest logits lie within ``tol`` of each other."""
    top2 = np.sort(logits, -1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= tol


def _unstacked(cache):
    """The reference's stacked cache as one LayerCache per layer, which
    its ``decode_step`` runs unrolled instead of under ``lax.scan``."""
    L = cache.layers.k.shape[0]
    return dataclasses.replace(cache, layers=tuple(
        jax.tree.map(lambda a: a[li], cache.layers) for li in range(L)))


def _restacked(cache):
    return dataclasses.replace(cache, layers=jax.tree.map(
        lambda *xs: jnp.stack(xs), *cache.layers))


def _serve_both(cfg_j, cfg_t, tol, max_new=STEPS + 1, scanned=True):
    """Full forward, prefill and STEPS greedy decode steps through both
    packages on the same tokens and parameters; the reference's greedy
    token feeds both at each step. ``scanned=False`` skips the full
    forward and runs the reference's decode unrolled: its ``lax.scan``
    paths refuse a bf16 config, whose residual stream turns f32 in the
    first layer."""
    ref = _ref_params(cfg_j)
    mine = _port_params(ref)
    batch = lm_batch(cfg_t, B, S, seed=0, step=0)
    toks = batch["tokens"][0]
    pe = batch.get("prefix_embeds")
    pe_j = None if pe is None else jnp.asarray(pe[0])
    pe_t = None if pe is None else torch.from_numpy(pe[0])
    close = lambda a, b, what: np.testing.assert_allclose(
        _np(a), _np(b), rtol=tol, atol=tol, err_msg=what)

    full_t = T.forward_logits(mine, cfg_t, {"tokens": torch.from_numpy(toks)}
                              | ({} if pe is None else {"prefix_embeds": pe_t}))
    if scanned:
        full_j = JT.forward_logits(ref, cfg_j, {"tokens": jnp.asarray(toks)}
                                   | ({} if pe is None else {"prefix_embeds": pe_j}))
        close(full_t, full_j, "forward_logits")

    lg_j, c_j = JT.prefill(ref, cfg_j, jnp.asarray(toks), prefix_embeds=pe_j,
                           max_new_tokens=max_new)
    lg_t, c_t = T.prefill(mine, cfg_t, torch.from_numpy(toks), prefix_embeds=pe_t,
                          max_new_tokens=max_new)
    close(lg_t, lg_j, "prefill logits")
    assert c_t.pos == int(c_j.pos) == S
    for f in ("k", "v"):
        got, want = getattr(c_t.layers, f), getattr(c_j.layers, f)
        assert got.dtype == getattr(torch, cfg_t.dtype)
        assert tuple(got.shape) == want.shape
        close(got, want, f"prefill cache {f}")
    np.testing.assert_array_equal(c_t.layers.kpos.numpy(), np.asarray(c_j.layers.kpos))

    close(lg_t[:, 0], full_t[:, -1], "prefill logits against the port's forward")
    if not scanned:
        c_j = _unstacked(c_j)
    lg_j, lg_t = np.asarray(lg_j[:, -1]), lg_t[:, -1]
    for step in range(STEPS):
        want_tok = lg_j.argmax(-1)
        got_tok = lg_t.argmax(-1).numpy()
        tie = _near_tie(lg_j, tol)
        assert (got_tok[~tie] == want_tok[~tie]).all(), step
        cur = want_tok[:, None].astype(np.int32)
        lg_j, c_j = JT.decode_step(ref, cfg_j, c_j, jnp.asarray(cur))
        lg_t, c_t = T.decode_step(mine, cfg_t, c_t, torch.from_numpy(cur))
        close(lg_t, lg_j, f"decode step {step}")
        lg_j, lg_t = np.asarray(lg_j[:, -1]), lg_t[:, -1]
        assert c_t.pos == int(c_j.pos) == S + step + 1
    if not scanned:
        c_j = _restacked(c_j)
    for f in ("k", "v"):
        close(getattr(c_t.layers, f), getattr(c_j.layers, f), f"decoded cache {f}")
    np.testing.assert_array_equal(c_t.layers.kpos.numpy(), np.asarray(c_j.layers.kpos))


@pytest.mark.parametrize("arch", DENSE)
def test_dense_serving_matches_reference(arch):
    _serve_both(JR.get_smoke_config(arch), R.get_smoke_config(arch), TOL)


def test_bf16_serving_matches_reference():
    """tinyllama's smoke config in bfloat16: bf16 embeddings and cache, the
    stream f32 after the first norm, as in the reference."""
    _serve_both(dataclasses.replace(JR.get_smoke_config("tinyllama-1.1b"), dtype="bfloat16"),
                dataclasses.replace(R.get_smoke_config("tinyllama-1.1b"), dtype="bfloat16"),
                BF16_TOL, scanned=False)


def test_windowed_ring_cache_matches_reference():
    """A uniform 8-wide window on a 16-token prompt: the prefill ring holds
    the last 8 positions and decode wraps it."""
    w = dict(window=8)
    _serve_both(dataclasses.replace(JR.get_smoke_config("tinyllama-1.1b"), **w),
                dataclasses.replace(R.get_smoke_config("tinyllama-1.1b"), **w), TOL)


def test_decode_cache_layout():
    cfg = R.get_smoke_config("phi3-mini-3.8b")
    c = T.make_decode_cache(cfg, batch=3, max_len=20, device="cpu")
    ref = JT.make_decode_cache(JR.get_smoke_config("phi3-mini-3.8b"), 3, 20)
    assert tuple(c.layers.k.shape) == ref.layers.k.shape
    assert c.layers.k.dtype == torch.float32 and c.pos == 0
    assert (c.layers.kpos == -1).all()
    assert T.cache_is_uniform(cfg)
    np.testing.assert_array_equal(T.layer_windows(R.get_config("hymba-1.5b")),
                                  JT.layer_windows(JR.get_config("hymba-1.5b")))


def test_entry_points_need_a_device_without_cuda(monkeypatch):
    cfg = R.get_smoke_config("tinyllama-1.1b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        P.init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA"):
        T.make_decode_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.lm_params_from_reference({"ln_f": np.ones(4, np.float32)})
