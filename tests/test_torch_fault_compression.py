"""The port's fault runtime and gradient compression
(`repro_torch.train.fault`, `repro_torch.train.compression`) against the
JAX package's (`repro.train.fault`, `repro.train.compression`) on the CPU.

Fault: `StragglerMonitor` on seeded duration sequences flags the same
steps with the same thresholds and returns the same values;
`run_with_restart` resumes with the same arguments, sleeps the same
backoff sequence and gives up the same way; `PreemptionHandler` flips on
its signal (``SIGUSR1``, so a slip never stops a test worker) and
`restore()` puts the previous handler back.

Compression, on seeded numpy gradients: the int8 payload ``q`` equal to
the reference's; the scale within one float32 ulp (2⁻²³ relative); a new
error or a mean within 1e-5 of the scale (XLA may fuse ``g − q·s`` into
one rounding, ≤ 127·s·2⁻²⁴ ≈ 7.6e-6·s). `compressed_psum` on a one-shard
CPU mesh against the reference's ``shard_map`` on one device, and on
``make_host_mesh(4, device="cpu")`` with four different gradients against
the reference's ``shard_map`` over 4 forced host devices (in a subprocess:
the device count is fixed before JAX starts). Then the reference's
properties: the half-step error bound, error feedback's telescoping sum,
and a toy quadratic that converges.
"""
import os
import signal
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import compression as JC
from repro.train import fault as JF
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import compression as C
from repro_torch.train import fault as F

_SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ULP = 2.0 ** -23
ERR_TOL = 1e-5


# ----------------------------------------------------------------------------
# straggler / preemption / restart
# ----------------------------------------------------------------------------

def _durations(seed: int, n: int = 160) -> np.ndarray:
    """Step seconds around 0.1 with jitter, a slow drift and spikes of
    2–20× on about one step in twelve."""
    rng = np.random.default_rng(seed)
    d = 0.1 * np.exp(rng.normal(0, 0.05, n)) * np.linspace(1.0, 1.3, n)
    spikes = rng.random(n) < 1 / 12
    d[spikes] *= rng.uniform(2, 20, spikes.sum())
    return d


@pytest.mark.parametrize("seed,kw", [(0, {}), (1, dict(window=20, k=3.0, min_samples=5)),
                                     (2, dict(window=8, k=1.0, min_samples=8)),
                                     (3, dict(k=0.0, min_samples=1))])
def test_straggler_monitor_matches_reference(seed, kw):
    calls = {"ref": [], "port": []}
    ref = JF.StragglerMonitor(**kw, on_straggler=lambda *a: calls["ref"].append(a))
    port = F.StragglerMonitor(**kw, on_straggler=lambda *a: calls["port"].append(a))
    got = [port.record(i, float(d)) for i, d in enumerate(_durations(seed))]
    want = [ref.record(i, float(d)) for i, d in enumerate(_durations(seed))]
    assert got == want and any(got)
    assert port.flagged == ref.flagged and port.times == ref.times
    assert calls["port"] == calls["ref"]


def test_straggler_monitor_flags_outlier_after_warmup():
    """The reference's two tests: no flag before ``min_samples``; then a
    15× step is flagged."""
    mon = F.StragglerMonitor(min_samples=10)
    assert not mon.record(0, 100.0)
    flagged = []
    mon = F.StragglerMonitor(min_samples=10, k=6.0,
                             on_straggler=lambda s, d, t: flagged.append(s))
    for i in range(20):
        mon.record(i, 0.100 + 0.001 * (i % 3))
    assert not flagged
    assert mon.record(20, 1.5)
    assert flagged == [20]


def _restart_trace(mod, fail_times: int, max_restarts: int, backoff_s: float):
    """Run ``mod.run_with_restart`` over a loop that fails ``fail_times``
    times (each failure "commits" a checkpoint) → (result or the raised
    message, the resume arguments, the sleeps)."""
    calls, sleeps, ckpt = [], [], {"step": None}

    def loop(resume):
        calls.append(resume)
        if len(calls) <= fail_times:
            ckpt["step"] = len(calls) * 10
            raise RuntimeError(f"worker died {len(calls)}")
        return 100

    try:
        out = mod.run_with_restart(loop, lambda: ckpt["step"], max_restarts=max_restarts,
                                   backoff_s=backoff_s, sleep=sleeps.append)
    except RuntimeError as e:
        out = str(e)
    return out, calls, sleeps


@pytest.mark.parametrize("fail_times,max_restarts,backoff_s",
                         [(2, 5, 0.0), (4, 5, 1.0), (8, 10, 3.0), (3, 2, 0.5), (0, 1, 1.0)])
def test_run_with_restart_matches_reference(fail_times, max_restarts, backoff_s):
    got = _restart_trace(F, fail_times, max_restarts, backoff_s)
    assert got == _restart_trace(JF, fail_times, max_restarts, backoff_s)
    out, calls, sleeps = got
    if fail_times <= max_restarts:
        assert out == 100 and calls == [None] + [10 * i for i in range(1, fail_times + 1)]
    else:     # gives up: the last failure propagates
        assert out == f"worker died {max_restarts + 1}"
    assert sleeps == [min(backoff_s * 2 ** i, 60.0) for i in range(len(sleeps))]


def test_preemption_handler_flips_and_restores():
    before = signal.getsignal(signal.SIGUSR1)
    h = F.PreemptionHandler(signals=(signal.SIGUSR1,))
    try:
        assert not h.should_checkpoint
        assert signal.getsignal(signal.SIGUSR1) == h._handler
        os.kill(os.getpid(), signal.SIGUSR1)
        assert h.should_checkpoint
    finally:
        h.restore()
    assert signal.getsignal(signal.SIGUSR1) == before


# ----------------------------------------------------------------------------
# int8 gradient compression with error feedback
# ----------------------------------------------------------------------------

def _grads(seed: int, shape=(64, 33), n: int = 1) -> np.ndarray:
    """``n`` gradients of ``shape`` at a magnitude from 1e-6 to 1e3, and
    error tensors 1e-3 of it."""
    rng = np.random.default_rng(seed)
    mag = 10 ** rng.uniform(-6, 3)
    return ((rng.normal(size=(n,) + shape) * mag).astype(np.float32),
            (rng.normal(size=(n,) + shape) * mag * 1e-3).astype(np.float32))


def _close_to_scale(got, want, scale):
    assert np.abs(np.asarray(got) - np.asarray(want)).max() <= ERR_TOL * float(scale)


@pytest.mark.parametrize("seed", range(6))
def test_quantize_and_feedback_match_reference(seed):
    g, e = (x[0] for x in _grads(seed))
    jq, js = JC.quantize_int8(jnp.asarray(g))
    q, s = C.quantize_int8(torch.from_numpy(g))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= ULP * float(js)
    np.testing.assert_array_equal(C.dequantize_int8(q, s).numpy(),
                                  np.asarray(JC.dequantize_int8(jq, js)))
    jq, js, je = jax.jit(JC.compress_with_feedback)(jnp.asarray(g), jnp.asarray(e))
    q, s, ne = C.compress_with_feedback(torch.from_numpy(g), torch.from_numpy(e))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    assert abs(float(s) - float(js)) <= ULP * float(js)
    _close_to_scale(ne.numpy(), je, js)
    # all zero: the scale's floor
    q0, s0 = C.quantize_int8(torch.zeros(5))
    assert float(s0) == np.float32(1e-30) and not q0.any()


def test_quantize_roundtrip_error_bound():
    g = torch.from_numpy(np.random.default_rng(0).normal(size=1000).astype(np.float32))
    q, s = C.quantize_int8(g)
    assert float((C.dequantize_int8(q, s) - g).abs().max()) <= float(s) / 2 + 1e-7


def test_error_feedback_is_unbiased_over_time():
    """The accumulated dequantised outputs plus the final error equal the
    accumulated gradients (the residual bounded by one step, not O(T))."""
    gs = np.random.default_rng(1).normal(size=(50, 256)).astype(np.float32)
    err, total_q = torch.zeros(256), np.zeros(256)
    for g in gs:
        q, s, err = C.compress_with_feedback(torch.from_numpy(g), err)
        total_q += C.dequantize_int8(q, s).numpy()
    assert np.abs(total_q + err.numpy() - gs.sum(0)).max() < 1e-3


def _ref_psum_one_device(g, e):
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    mesh = jax.make_mesh((1,), ("d",))
    f = shard_map(lambda g, e: JC.compressed_psum(g, e, "d"), mesh=mesh,
                  in_specs=(P(), P()), out_specs=(P(), P()), check_rep=False)
    return jax.jit(f)(jnp.asarray(g), jnp.asarray(e))


@pytest.mark.parametrize("seed", range(3))
def test_compressed_psum_one_shard_matches_reference(seed):
    """One shard: the reference's one-device ``shard_map`` (its own test's
    setting) against the port on a one-shard CPU mesh."""
    g, e = (x[0] for x in _grads(seed))
    mesh = make_host_mesh(1, device="cpu")
    (out,), (err,) = C.compressed_psum([torch.from_numpy(g)], [torch.from_numpy(e)])
    assert out.device == mesh[0] and err.device == mesh[0]
    jout, jerr = _ref_psum_one_device(g, e)
    scale = float(np.abs(g + e).max()) / 127
    _close_to_scale(out.numpy(), jout, scale)
    _close_to_scale(err.numpy(), jerr, scale)
    # the reference test's properties: ≈ identity, and out + err = g + e
    np.testing.assert_allclose(out.numpy(), g + e, atol=scale)
    np.testing.assert_allclose(out.numpy() + err.numpy(), g + e, atol=ERR_TOL * scale)


_FOUR_DEVICES = """
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import sys
    import numpy as np
    import jax, jax.numpy as jnp
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.train import compression as JC
    assert len(jax.devices()) == 4
    path = sys.argv[1]
    data = dict(np.load(path))
    mesh = jax.make_mesh((4,), ("d",))

    def body(g, e):
        out, err = JC.compressed_psum(g[0], e[0], "d")
        return out[None], err[None]

    f = jax.jit(shard_map(body, mesh=mesh, in_specs=(P("d"), P("d")),
                          out_specs=(P("d"), P("d")), check_rep=False))
    outs = {}
    for key in sorted(k for k in data if k.startswith("g")):
        out, err = f(jnp.asarray(data[key]), jnp.asarray(data["e" + key[1:]]))
        outs["out" + key[1:]] = np.asarray(out)
        outs["err" + key[1:]] = np.asarray(err)
    np.savez(path.replace(".npz", "_ref.npz"), **outs)
    print("ok")
"""


def test_compressed_psum_four_shards_matches_reference(tmp_path):
    """Four shards, four different gradients: the port on
    ``make_host_mesh(4, device="cpu")`` against the reference's
    ``shard_map`` over 4 forced host devices, for three seeds."""
    data = {}
    for seed in range(3):
        g, e = _grads(10 + seed, n=4)
        g[seed] *= 50          # one shard's scale dominates
        data[f"g{seed}"], data[f"e{seed}"] = g, e
    path = str(tmp_path / "psum.npz")
    np.savez(path, **data)
    env = dict(os.environ, PYTHONPATH=os.path.abspath(_SRC), JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    run = subprocess.run([sys.executable, "-c", textwrap.dedent(_FOUR_DEVICES), path],
                         env=env, capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-3000:]
    ref = np.load(path.replace(".npz", "_ref.npz"))
    mesh = make_host_mesh(4, device="cpu")
    for seed in range(3):
        g, e = data[f"g{seed}"], data[f"e{seed}"]
        outs, errs = C.compressed_psum([torch.from_numpy(x).to(d) for x, d in zip(g, mesh)],
                                       [torch.from_numpy(x).to(d) for x, d in zip(e, mesh)])
        scale = float(np.abs(g + e).max()) / 127
        for d in range(4):
            assert outs[d].device == errs[d].device == mesh[d]
            _close_to_scale(outs[d].numpy(), ref[f"out{seed}"][d], scale)
            _close_to_scale(errs[d].numpy(), ref[f"err{seed}"][d], scale)
        # every shard holds the same mean: Σ (g + e − err) / 4 to rounding
        want = ((g + e) - np.stack([x.numpy() for x in errs])).sum(0) / 4
        for out in outs:
            assert torch.equal(out, outs[0])
            np.testing.assert_allclose(out.numpy(), want, atol=4 * ERR_TOL * scale)


def test_tree_compressed_psum_is_leafwise():
    """Over trees, leaf by leaf, the same as `compressed_psum`; the error
    trees start from `init_error_feedback` (float32 zeros)."""
    rng = np.random.default_rng(4)
    trees = [{"b": {"w": torch.from_numpy(rng.normal(size=(4, 3)).astype(np.float32))},
              "a": torch.from_numpy(rng.normal(size=(7,)).astype(np.float32) * (d + 1))}
             for d in range(2)]
    errs = [C.init_error_feedback(t) for t in trees]
    assert all(not e.any() and e.dtype == torch.float32 and e.shape == t.shape
               for tree, et in zip(trees, errs) for t, e in
               ((tree["a"], et["a"]), (tree["b"]["w"], et["b"]["w"])))
    means, new_errs = C.tree_compressed_psum(trees, errs)
    for key in (("a",), ("b", "w")):
        leaf = lambda t: t[key[0]] if len(key) == 1 else t[key[0]][key[1]]
        outs, es = C.compressed_psum([leaf(t) for t in trees], [leaf(e) for e in errs])
        for d in range(2):
            assert torch.equal(leaf(means[d]), outs[d])
            assert torch.equal(leaf(new_errs[d]), es[d])
    with pytest.raises(ValueError):
        C.compressed_psum([trees[0]["a"]], [])


def test_compressed_training_converges():
    """The reference's toy quadratic: int8-compressed gradients with error
    feedback reach the optimum as exact gradients do."""
    w_true = torch.from_numpy(np.random.default_rng(2).normal(size=16).astype(np.float32))
    for compressed in (False, True):
        w, err = torch.zeros(16), torch.zeros(16)
        for _ in range(300):
            g = w - w_true
            if compressed:
                q, s, err = C.compress_with_feedback(g, err)
                g = C.dequantize_int8(q, s)
            w = w - 0.1 * g
        assert float(torch.linalg.norm(w - w_true)) < 1e-2, compressed
