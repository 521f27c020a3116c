"""The port's training forward (`transformer.forward_train`) against the
JAX package's on the CPU, for every family of the registry at smoke size:
the loss and the gradient of every parameter leaf against
``jax.value_and_grad`` of ``repro.models.transformer.forward_train``, on
the same numpy-seeded batch (`lm_batch`, B = 2, S = 64) and the
reference's own parameters (converted bit for bit). Also the chunked head
at S = 1024 (two 512-token chunks), hymba's scan with grad on against its
serving form, and RWKV6's WKV gradient in float64.

Tolerances: the loss within 2e-5 relative; each gradient leaf within 2e-4
of its largest entry (≈ 2e-6 is what summation order leaves here), with
two reasons for another bound:

  * rwkv6: 1e-3. Its WKV exponentiates differences of running log-decay
    sums, which XLA's cumsum and torch's associate differently; in float32
    that moves its gradients by ≈ 2e-4 of the largest (≈ 5e-5 on the
    WKV's outputs alone, `test_torch_moe_rwkv.py`).
    `test_wkv_gradient_matches_reference_in_float64` holds the WKV's
    gradient to the reference's within 1e-10 in float64, where that
    conditioning vanishes.
  * llama4's router: top-1 routing renormalises one gate by itself, so
    the gate is 1 and the router's gradient is 0 up to rounding (≈ 3e-9
    on both sides); both must stay below 1e-6 of the model's largest
    gradient entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import params as JP
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import lm_batch
from repro_torch.models import ssm as SM
from repro_torch.models import transformer as T
from repro_torch.train import optimizer as OPT

LOSS_TOL = 2e-5
GRAD_TOL = {"rwkv6-3b": 1e-3}
DEFAULT_GRAD_TOL = 2e-4
B, S = 2, 64


def _loss_and_grads(arch, batch_size, seq, **overrides):
    """(reference loss, its gradient leaves by path, port loss, port
    gradients by path) on one seeded batch."""
    jcfg = dataclasses.replace(JR.get_smoke_config(arch), **overrides)
    cfg = dataclasses.replace(R.get_smoke_config(arch), **overrides)
    ref = JP.init_params(jcfg, jax.random.PRNGKey(0))
    batch = {k: v[0] for k, v in lm_batch(cfg, batch_size, seq, seed=1, step=0).items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(lambda p, b: JT.forward_train(p, jcfg, b)))(
        ref, {k: jnp.asarray(v) for k, v in batch.items()})
    want = {tuple(k.key for k in path): np.asarray(g)
            for path, g in jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    params = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    items = list(OPT.tree_items(params))
    for _, t in items:
        t.requires_grad_()
    loss = T.forward_train(params, cfg, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, [t for _, t in items], allow_unused=True)
    got = {path: (np.zeros(t.shape, np.float32) if g is None else g.numpy())
           for (path, t), g in zip(items, grads)}
    return float(jloss), want, float(loss.detach()), got


def _rel(got, want) -> float:
    return float(np.abs(got.astype(np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("arch", sorted(R.ARCHS))
def test_forward_train_loss_and_grads_match_reference(arch):
    jloss, want, loss, got = _loss_and_grads(arch, B, S)
    assert np.isfinite(loss) and abs(loss - jloss) <= LOSS_TOL * abs(jloss), (loss, jloss)
    assert sorted(got) == sorted(want)
    top = max(np.abs(w).max() for w in want.values())
    tol = GRAD_TOL.get(arch, DEFAULT_GRAD_TOL)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape and np.isfinite(g).all(), path
        if arch.startswith("llama4") and path[-1] == "router":
            assert max(np.abs(g).max(), np.abs(w).max()) <= 1e-6 * top, path
            continue
        assert _rel(g, w) <= tol, (path, _rel(g, w))


def test_chunked_head_at_1024_matches_reference():
    """S = 1024: the head and CE run as two 512-token chunks on both sides
    (`head_loss_chunked`); labels with an ignored tail."""
    jloss, want, loss, got = _loss_and_grads("tinyllama-1.1b", 1, 1024)
    assert T._CE_CHUNK == 512 and 1024 % T._CE_CHUNK == 0
    assert abs(loss - jloss) <= LOSS_TOL * abs(jloss)
    for path, w in want.items():
        assert _rel(got[path], w) <= DEFAULT_GRAD_TOL, path


def test_head_loss_chunked_sums_chunk_by_chunk():
    """(nll, count) over chunks equals one chunk's, the ignored labels
    counted out, and forward_train's loss is their ratio."""
    cfg = R.get_smoke_config("tinyllama-1.1b")
    rng = np.random.default_rng(3)
    params = {"ln_f": torch.ones(cfg.d_model),
              "head": torch.from_numpy(rng.normal(size=(cfg.d_model, cfg.vocab_size))
                                       .astype(np.float32) * 0.05)}
    x = torch.from_numpy(rng.normal(size=(2, 1024, cfg.d_model)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1024)).astype(np.int32))
    labels[:, -7:] = -1
    nll, cnt = T.head_loss_chunked(params, cfg, x, labels)
    assert float(cnt) == 2 * (1024 - 7)
    logits = T.lm_head(params, cfg, x)
    want = T.cross_entropy(logits, labels)
    assert abs(float(nll / cnt) - float(want)) <= 1e-6 * abs(float(want))


def test_hymba_scan_with_grad_is_bit_equal_to_serving():
    """`ssm.mamba` where autograd records (its out-of-place scan) gives
    exactly the serving form's output and state (ping-pong buffers, in
    place), over several 16-token chunks."""
    cfg = R.get_smoke_config("hymba-1.5b")
    params = convert.lm_params_from_reference(
        jax.tree.map(np.asarray, JP.init_params(JR.get_smoke_config("hymba-1.5b"),
                                                jax.random.PRNGKey(4))), "cpu")
    p = {k: v[0] for k, v in params["blocks"]["ssm"].items()}
    x = torch.from_numpy(np.random.default_rng(5).normal(size=(2, 64, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        y0, (h0, t0) = SM.mamba(x, p, cfg, chunk=16)
    xg = x.clone().requires_grad_()
    y1, (h1, t1) = SM.mamba(xg, p, cfg, chunk=16)
    assert y1.requires_grad
    assert torch.equal(y0, y1) and torch.equal(h0, h1) and torch.equal(t0, t1)
    y1.sum().backward()
    assert torch.isfinite(xg.grad).all() and xg.grad.abs().max() > 0
    gen = torch.Generator().manual_seed(6)
    a = torch.rand(2, 13, 3, 4, generator=gen) + 0.5
    b = torch.randn(2, 13, 3, 4, generator=gen)
    with torch.no_grad():
        want = SM._doubling_scan(a.clone(), b.clone())
    got = SM._doubling_scan(a.clone().requires_grad_(), b.clone().requires_grad_())
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wkv_gradient_matches_reference_in_float64():
    """The WKV chunk's gradient (r, k, v, log-decay, bonus, carried state)
    against ``jax.vjp`` of the reference's, both in float64, within
    1e-10: three 16-token chunks from a carried state."""
    rng = np.random.default_rng(8)
    Bw, seq, H, hd = 2, 48, 4, 8
    args = [rng.normal(size=(Bw, seq, H, hd)) for _ in range(3)]
    args.append(-np.exp(rng.normal(scale=0.5, size=(Bw, seq, H, hd))))
    args.append(rng.normal(size=(H, hd)))
    args.append(rng.normal(size=(Bw, H, hd, hd)))
    cot_y = rng.normal(size=(Bw, seq, H, hd))
    cot_s = rng.normal(size=(Bw, H, hd, hd))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    y, s = SM._rwkv_wkv_chunk(*leaves, 16)
    torch.autograd.backward([y, s], [torch.from_numpy(cot_y), torch.from_numpy(cot_s)])
    with jax.enable_x64(True):
        _, vjp = jax.vjp(lambda *a: JS._rwkv_wkv_chunk(*a, 16), *map(jnp.asarray, args))
        want = [np.asarray(g) for g in vjp((jnp.asarray(cot_y), jnp.asarray(cot_s)))]
    for leaf, w in zip(leaves, want):
        assert leaf.grad.dtype == torch.float64
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=1e-10, atol=1e-10)
