"""The port's AdamW and train step (`repro_torch.train`) against the JAX
package's (`repro.train`) on the CPU, at smoke size, on the same inputs:
the schedule, the global norm and clipping, `apply` fed the reference's own
gradients, and `make_train_step` for two steps on tinyllama and qwen with
1 and 4 microbatches, from the reference's initial state (converted bit for
bit). Then the port's counterparts of the reference's training tests
(`tests/test_train.py`): microbatch equivalence, determinism across
restarts (bit-equal here), the memorisable batch, and the remat policies.

Tolerances: optimizer quantities within 1e-6 (relative); through the
train step the loss within 2e-5 relative, the gradient norm 1e-5, the
rate 1e-6, each moment leaf within 2e-4 of its largest entry (the
gradients' tolerance, `test_torch_train_families.py`) and the parameters
within 1e-6. The step tests run AdamW with ``eps=1e-3``: at its first
step AdamW's update is g / (|g| + eps), with the default eps ≈ sign(g), so
a gradient entry at rounding level (summation order differs between XLA
and torch) could flip its parameter's update by 2·lr between two correct
implementations; with eps = 1e-3 the update is smooth in g and a rounding
difference in g stays a rounding difference in the parameter.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.models import params as JP
from repro.models import transformer as JT
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import lm_batch
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

OPT_TOL = 1e-6
LOSS_TOL, NORM_TOL, LR_TOL, MOMENT_TOL, PARAM_TOL = 2e-5, 1e-5, 1e-6, 2e-4, 1e-6


def _by_path(tree) -> dict:
    return {tuple(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np_tree(tree) -> dict:
    return {path: t.detach().numpy() for path, t in OPT.tree_items(tree)}


def _learnable_batch(B, S, n_mb=1):
    """The reference test's memorisable pattern: tokens = position mod 17."""
    toks = (np.arange(S)[None, :].repeat(B, 0) % 17).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((B, 1), -1, np.int32)], 1)
    return {"tokens": toks.reshape(n_mb, B // n_mb, S),
            "labels": labels.reshape(n_mb, B // n_mb, S)}


@pytest.mark.parametrize("kw", [dict(lr=1e-3, warmup_steps=10, total_steps=100,
                                     min_lr_ratio=0.1), {}])
def test_schedule_matches_reference(kw):
    jc, pc = JO.AdamWConfig(**kw), OPT.AdamWConfig(**kw)
    for step in list(range(0, 130, 3)) + [10000, 10001]:
        want = float(JO.schedule(jc, jnp.asarray(step, jnp.int32)))
        got = OPT.schedule(pc, step)
        assert got.dtype == np.float32
        assert abs(float(got) - want) <= OPT_TOL * jc.lr, step
    # the reference test's three points
    c = OPT.AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    assert float(OPT.schedule(c, 0)) == 0.0
    assert abs(float(OPT.schedule(c, 10)) - 1e-3) < 1e-9
    assert float(OPT.schedule(c, 100)) == pytest.approx(1e-4, rel=1e-3)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(0)
    tree = {"b": {"w": rng.normal(size=(7, 5)).astype(np.float32)},
            "a": rng.normal(size=(300,)).astype(np.float32) * 3}
    mine = {"b": {"w": torch.from_numpy(tree["b"]["w"])}, "a": torch.from_numpy(tree["a"])}
    want = float(JO.global_norm(tree))
    assert abs(float(OPT.global_norm(mine)) - want) <= OPT_TOL * want
    for max_norm in (1.0, 1e3):
        jc, jn = JO.clip_by_global_norm(tree, max_norm)
        pc, pn = OPT.clip_by_global_norm(mine, max_norm)
        assert abs(float(pn) - float(jn)) <= OPT_TOL * float(jn)
        for path, w in _by_path(jc).items():
            assert _rel(_np_tree(pc)[path], w) <= OPT_TOL, path
    # the reference test: a norm of 316 clipped to 1
    clipped, norm = OPT.clip_by_global_norm({"w": torch.full((10,), 100.0)}, 1.0)
    assert abs(float(OPT.global_norm(clipped)) - 1.0) < 1e-5 and float(norm) > 100


def test_adamw_step_math():
    """The reference's: a first step of ≈ −lr·sign(g), the step counted."""
    params = {"w": torch.tensor([1.0, -2.0])}
    st = OPT.init(params)
    cfg = OPT.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.0, grad_clip=1e9)
    newp, st2, m = OPT.apply(params, {"w": torch.tensor([0.1, 0.1])}, st, cfg)
    np.testing.assert_allclose(newp["w"].numpy(), [0.9, -2.1], atol=1e-3)
    assert st2.step == 1 and st2.mu["w"].dtype == torch.float32


def test_apply_matches_reference_with_its_gradients():
    """Two AdamW steps at the default config (eps 1e-8, clipping to 1)
    fed the reference's gradients of tinyllama's smoke loss: parameters,
    moments, norm and rate within 1e-6."""
    jcfg = JR.get_smoke_config("tinyllama-1.1b")
    ref = JP.init_params(jcfg, jax.random.PRNGKey(0))
    b = lm_batch(R.get_smoke_config("tinyllama-1.1b"), 2, 32, seed=5, step=0)
    grads = jax.jit(jax.grad(lambda p, bb: JT.forward_train(p, jcfg, bb)))(
        ref, {k: jnp.asarray(v[0]) for k, v in b.items()})
    jc = JO.AdamWConfig(warmup_steps=1)
    jp, jst = ref, JO.init(ref)
    japply = jax.jit(JO.apply, static_argnums=3)
    mine = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    pst = OPT.init(mine)
    for scale in (1.0, 0.5):     # a second step with other gradients
        g = jax.tree.map(lambda x: x * scale, grads)
        jp, jst, jm = japply(jp, g, jst, jc)
        mine, pst, pm = OPT.apply(mine, convert.lm_params_from_reference(
            jax.tree.map(np.asarray, g), "cpu"), pst, OPT.AdamWConfig(warmup_steps=1))
        assert pst.step == int(jst.step)
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= \
            OPT_TOL * float(jm["grad_norm"])
        assert abs(float(pm["lr"]) - float(jm["lr"])) <= OPT_TOL * float(jm["lr"])
        for got, want in ((mine, jp), (pst.mu, jst.mu), (pst.nu, jst.nu)):
            got = _np_tree(got)
            for path, w in _by_path(want).items():
                assert np.abs(got[path] - w).max() <= OPT_TOL * max(np.abs(w).max(), 1e-3), path


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b"])
@pytest.mark.parametrize("n_mb", [1, 4])
def test_train_step_matches_reference(arch, n_mb):
    jcfg, cfg = JR.get_smoke_config(arch), R.get_smoke_config(arch)
    kw = dict(lr=1e-3, warmup_steps=0, eps=1e-3)
    js = JTS.init_state(jcfg, jax.random.PRNGKey(0))
    ps = convert.train_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    jstep = jax.jit(JTS.make_train_step(
        jcfg, JTS.TrainConfig(microbatches=n_mb, opt=JO.AdamWConfig(**kw))))
    pstep = TS.make_train_step(cfg, TS.TrainConfig(microbatches=n_mb, opt=OPT.AdamWConfig(**kw)))
    for s in range(2):
        b = lm_batch(cfg, 8, 32, seed=3, step=s, microbatches=n_mb)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        ps, pm = pstep(ps, b)
        assert ps.step == int(js.step) == ps.opt.step == s + 1
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= LOSS_TOL * float(jm["loss"])
        assert abs(float(pm["grad_norm"]) - float(jm["grad_norm"])) <= \
            NORM_TOL * float(jm["grad_norm"])
        assert abs(float(pm["lr"]) - float(jm["lr"])) <= LR_TOL * float(jm["lr"])
        for got, want in ((ps.opt.mu, js.opt.mu), (ps.opt.nu, js.opt.nu)):
            got = _np_tree(got)
            for path, w in _by_path(want).items():
                assert _rel(got[path], w) <= MOMENT_TOL, (s, path)
        got = _np_tree(ps.params)
        for path, w in _by_path(js.params).items():
            assert got[path].dtype == np.float32
            assert np.abs(got[path] - w).max() <= PARAM_TOL, (s, path)


def test_remat_policies_are_bit_equal():
    """``remat_policy="dots"`` (products kept) and ``"nothing"``
    (everything recomputed) give the same loss and gradients bit for bit."""
    cfg = R.get_smoke_config("tinyllama-1.1b")
    out = []
    for policy in ("nothing", "dots"):
        state = TS.init_state(cfg, 3, device="cpu")
        step = TS.make_train_step(cfg, TS.TrainConfig(microbatches=2, remat_policy=policy))
        state, m = step(state, lm_batch(cfg, 4, 32, seed=1, step=0, microbatches=2))
        out.append((state, m))
    (a, ma), (b, mb) = out
    assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"], mb["grad_norm"])
    for (_, x), (_, y) in zip(OPT.tree_items(a.params), OPT.tree_items(b.params)):
        assert torch.equal(x, y)
    for (_, x), (_, y) in zip(OPT.tree_items(a.opt.nu), OPT.tree_items(b.opt.nu)):
        assert torch.equal(x, y)


def test_microbatch_equivalence():
    """1 microbatch against 4: the same averaged gradients, so the same
    parameters (the reference test's bounds)."""
    cfg = R.get_smoke_config("tinyllama-1.1b")
    opt = OPT.AdamWConfig(lr=1e-3, warmup_steps=0)
    batch1 = _learnable_batch(8, 32, n_mb=1)
    batch4 = {k: v.reshape(4, 2, *v.shape[2:]) for k, v in batch1.items()}
    outs = []
    for n_mb, batch in ((1, batch1), (4, batch4)):
        state = TS.init_state(cfg, 1, device="cpu")
        state, m = TS.make_train_step(cfg, TS.TrainConfig(microbatches=n_mb, opt=opt))(state, batch)
        outs.append((state, float(m["loss"])))
    assert abs(outs[0][1] - outs[1][1]) < 1e-4
    for (_, a), (_, b) in zip(OPT.tree_items(outs[0][0].params), OPT.tree_items(outs[1][0].params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3, atol=2e-5)


def test_determinism_across_restarts():
    """Two runs of three steps from the same seed and batches: every
    parameter and moment bit for bit."""
    cfg = R.get_smoke_config("qwen1.5-0.5b")

    def run(steps):
        state = TS.init_state(cfg, 2, device="cpu")
        step = TS.make_train_step(cfg, TS.TrainConfig(microbatches=1))
        for s in range(steps):
            state, _ = step(state, lm_batch(cfg, 4, 32, seed=9, step=s, microbatches=1))
        return state

    a, b = run(3), run(3)
    assert a.step == b.step == 3
    for tree in ("params", "mu", "nu"):
        ta = a.params if tree == "params" else getattr(a.opt, tree)
        tb = b.params if tree == "params" else getattr(b.opt, tree)
        for (_, x), (_, y) in zip(OPT.tree_items(ta), OPT.tree_items(tb)):
            assert torch.equal(x, y)


def test_loss_decreases_on_memorisable_data():
    cfg = R.get_smoke_config("qwen1.5-0.5b")
    tcfg = TS.TrainConfig(microbatches=1,
                          opt=OPT.AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=100))
    state = TS.init_state(cfg, 0, device="cpu")
    step = TS.make_train_step(cfg, tcfg)
    batch = _learnable_batch(4, 64)
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["grad_norm"]))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] * 0.5, (losses[0], losses[-1])


def test_bf16_step_takes_bf16_gradients_into_f32_state():
    """A bf16 config: the forward on a bf16 copy, the state float32."""
    cfg = dataclasses.replace(R.get_smoke_config("tinyllama-1.1b"), dtype="bfloat16")
    state = TS.init_state(cfg, 0, device="cpu")
    before = {p: t.clone() for p, t in OPT.tree_items(state.params)}
    state, m = TS.make_train_step(cfg, TS.TrainConfig(microbatches=2))(
        state, _learnable_batch(4, 32, n_mb=2))
    assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
    for path, t in OPT.tree_items(state.params):
        assert t.dtype == torch.float32 and not torch.equal(t, before[path]), path


def test_state_conversion_and_mesh():
    js = JTS.init_state(JR.get_smoke_config("qwen1.5-0.5b"), jax.random.PRNGKey(0))
    ps = convert.train_state_from_reference(jax.tree.map(np.asarray, js), "cpu")
    assert ps.step == 0 and ps.opt.step == 0
    got = _np_tree(ps.params)
    for path, w in _by_path(js.params).items():
        np.testing.assert_array_equal(got[path], w)
    assert all(not t.any() for t in OPT.tree_leaves(ps.opt.mu))
    cfg = R.get_smoke_config("qwen1.5-0.5b")
    with pytest.raises(TypeError, match="NamedMesh"):
        TS.make_train_step(cfg, TS.TrainConfig(), mesh=object())
    b = {"tokens": np.zeros((8, 5), np.int32)}
    assert TS.reshape_batch(b, 4)["tokens"].shape == (4, 2, 5)
