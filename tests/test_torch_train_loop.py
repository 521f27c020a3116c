"""The port's training driver (`repro_torch.launch.train`) on the CPU: the
loop against the JAX package's (`repro.launch.train.train_loop`) from the
reference's own step-0 checkpoint; the supervised restart bit-equal to an
uninterrupted run; the command line with an injected failure and under
SIGTERM, each in a subprocess; the SIGTERM handler left as found; the
augmentation example's training half. One ``gpu`` test runs the
supervised restart on the card at tinyllama's full width (skips here).

Tolerances (`tests/test_torch_train.py`): each step's loss within 2e-5
relative and every final parameter within 1e-6 absolute of the
reference's; restarts bit for bit. The JAX package is imported inside the
tests that use it, so the ``gpu`` test collects where only the card's
software is installed.
"""
import dataclasses
import os
import signal
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as R
from repro_torch.kernels import flash_attention as FA
from repro_torch.launch import train as LT
from repro_torch.train import checkpoint as CK
from repro_torch.train import fault as F
from repro_torch.train import optimizer as OPT

_SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
LOSS_TOL, PARAM_TOL = 2e-5, 1e-6
ARCH = "tinyllama-1.1b"


def _equal_states(a, b) -> bool:
    return (a.step == b.step and a.opt.step == b.opt.step and all(
        torch.equal(x, y) for tree in ("params", "mu", "nu")
        for x, y in zip(OPT.tree_leaves(a.params if tree == "params" else getattr(a.opt, tree)),
                        OPT.tree_leaves(b.params if tree == "params" else getattr(b.opt, tree)))))


def test_loop_matches_reference_from_its_checkpoint(tmp_path, capsys):
    """The reference's step-0 checkpoint of the smoke tinyllama, resumed by
    the port's loop for 4 steps of 4 × 32 tokens in 2 microbatches,
    against the reference's loop from the same seed: losses and final
    parameters; the port commits its last step."""
    import jax
    from repro.configs import registry as JR
    from repro.launch import train as JLT
    from repro.train import checkpoint as JCK
    from repro.train import train_step as JTS

    kw = dict(smoke=True, steps=4, batch=4, seq=32, microbatches=2, log_every=1)
    JCK.save(str(tmp_path), 0, JTS.init_state(JR.get_smoke_config(ARCH), jax.random.PRNGKey(0)))
    jstate, jlosses = JLT.train_loop(ARCH, ckpt_dir=None, seed=0, **kw)
    capsys.readouterr()
    state, losses = LT.train_loop(ARCH, ckpt_dir=str(tmp_path), device="cpu", **kw)
    out = capsys.readouterr().out
    assert "resumed from step 0" in out and out.count("loss") == 4
    assert len(losses) == len(jlosses) == 4
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= LOSS_TOL * want
    assert state.step == state.opt.step == int(jstate.step) == 4
    want = {tuple(k.key for k in p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jstate.params)[0]}
    for path, leaf in OPT.tree_items(state.params):
        assert np.abs(leaf.numpy() - want[path]).max() <= PARAM_TOL, path
    assert CK.latest_step(str(tmp_path)) == 4


def _supervised(ckpt_dir, steps, fail_at, device, **kw):
    """`run_with_restart` over the loop as `main` drives it (the failure
    injected on the first call only) → (final state, losses a call,
    resume steps, sleeps)."""
    finals, losses, resumes, sleeps = [], [], [], []

    def make_loop(resume_step):
        resumes.append(resume_step)
        state, ls = LT.train_loop(ARCH, steps=steps, ckpt_dir=ckpt_dir,
                                  fail_at_step=fail_at if (resume_step or 0) == 0 else None,
                                  device=device, **kw)
        finals.append(state)
        losses.append(ls)
        return steps

    out = F.run_with_restart(make_loop, lambda: CK.latest_step(ckpt_dir), max_restarts=2,
                             backoff_s=0.1, sleep=sleeps.append)
    assert out == steps
    return finals[-1], losses, resumes, sleeps


def test_supervised_restart_is_bit_equal(tmp_path):
    """6 steps, a checkpoint every 3, a failure after step 4: one restart
    from step 3, and the final state and the resumed losses bit-equal to
    an uninterrupted run; steps 3 and 6 committed."""
    kw = dict(smoke=True, batch=4, seq=32, microbatches=2, log_every=100)
    want, want_losses = LT.train_loop(ARCH, steps=6, ckpt_dir=None, device="cpu", **kw)
    got, losses, resumes, sleeps = _supervised(str(tmp_path), 6, 4, "cpu", ckpt_every=3, **kw)
    assert resumes == [None, 3] and sleeps == [0.1]
    assert losses == [want_losses[3:]]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003", "step_00000006"]
    assert _equal_states(got, want)
    restored = CK.restore(str(tmp_path), 6, LT.TS.abstract_state(R.get_smoke_config(ARCH)),
                          device="cpu")
    assert _equal_states(restored, want)


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=_SRC)
    return [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke",
            "--device", "cpu", *args], env


def test_cli_restarts_after_injected_failure(tmp_path):
    cmd, env = _cli("--steps", "4", "--batch", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path), "--ckpt-every", "2", "--fail-at-step", "2")
    run = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "resumed from step 2" in run.stdout
    assert CK.latest_step(str(tmp_path)) == 4


def test_cli_checkpoints_and_exits_on_sigterm(tmp_path):
    """A run of 100000 steps sent SIGTERM after its first log line exits 0,
    says so, and leaves a committed checkpoint below its last step."""
    cmd, env = _cli("--steps", "100000", "--batch", "2", "--seq", "16", "--ckpt-dir",
                    str(tmp_path))
    proc = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        first = proc.stdout.readline()
        assert first.startswith("step     0"), first + proc.stderr.read()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "preemption requested" in out
    step = CK.latest_step(str(tmp_path))
    assert step is not None and 1 <= step < 100000


def test_loop_leaves_sigterm_handler_as_found(tmp_path):
    """After it returns and after it raises, `train_loop` has put the
    previous SIGTERM handler back (the reference's loop leaves its own)."""
    before = signal.getsignal(signal.SIGTERM)
    marker = lambda signum, frame: None
    signal.signal(signal.SIGTERM, marker)
    try:
        kw = dict(smoke=True, batch=2, seq=16, device="cpu", log_every=100)
        LT.train_loop(ARCH, steps=1, ckpt_dir=None, **kw)
        assert signal.getsignal(signal.SIGTERM) is marker
        with pytest.raises(RuntimeError, match="injected failure"):
            LT.train_loop(ARCH, steps=2, ckpt_dir=str(tmp_path), fail_at_step=0, **kw)
        assert signal.getsignal(signal.SIGTERM) is marker
    finally:
        signal.signal(signal.SIGTERM, before)


def test_short_lm_training(capsys):
    """The example's training half: 30 finite losses on random tokens
    (they need not fall: at the warmup's rates the reference's own run
    rises, 6.691 → 6.858)."""
    from repro_torch import train_augmented
    losses = train_augmented.short_lm_training("cpu")
    assert len(losses) == 30 and np.isfinite(losses).all()
    assert f"loss {losses[0]:.3f} → {losses[-1]:.3f}" in capsys.readouterr().out


def test_cli_needs_a_device_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LT.main(["--arch", ARCH, "--smoke", "--steps", "1", "--batch", "2", "--seq", "16"])


# ----------------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_supervised_restart_is_bit_equal(cuda, tmp_path, monkeypatch):
    """tinyllama at full width, 2 layers, bf16: 5 steps of 4 × 256 tokens
    in 2 microbatches, a checkpoint every 2 steps, a failure after step 2;
    the resumed run's state bit-equal to an uninterrupted one, and the
    backward kernel launched every step."""
    cut = dataclasses.replace(R.get_config(ARCH), num_layers=2)
    monkeypatch.setattr(LT.registry, "get_config", lambda arch: cut)
    kw = dict(smoke=False, batch=4, seq=256, microbatches=2, log_every=100)
    n0 = FA.flash_attention_bwd.launches
    want, want_losses = LT.train_loop(ARCH, steps=5, ckpt_dir=None, device=cuda, **kw)
    assert FA.flash_attention_bwd.launches - n0 == 5 * 2 * 2
    got, losses, resumes, _ = _supervised(str(tmp_path), 5, 2, cuda, ckpt_every=2, **kw)
    assert resumes == [None, 2] and CK.latest_step(str(tmp_path)) == 5
    assert FA.flash_attention_bwd.launches - n0 == (5 + 3 + 3) * 2 * 2
    assert losses == [want_losses[2:]] and np.isfinite(want_losses).all()
    assert _equal_states(got, want)
