"""The port's checkpoints (`repro_torch.train.checkpoint`) against the JAX
package's (`repro.train.checkpoint`) on the CPU: the reference's own
checkpoint tests run on the port (roundtrip, partial writes ignored,
corruption detected, keep-N, a shape mismatch rejected, resume bit for
bit; ``shardings=`` or ``device=``), then the on-disk format across the
packages: a checkpoint written by either restores into the other bit for
bit, and the two manifests of one state are equal as JSON;
`abstract_state` has the reference's leaf paths, shapes and dtypes for all
ten configs.

The state is the ``qwen1.5-0.5b`` smoke state the reference's tests use,
drawn by the reference from ``PRNGKey(0)`` and converted bit for bit
(`convert.train_state_from_reference`). Every comparison is exact: a
checkpoint moves bytes.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.train import checkpoint as JCK
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import lm_batch
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module")
def ref_state():
    return jax.device_get(JTS.init_state(JR.get_smoke_config(ARCH), jax.random.PRNGKey(0)))


@pytest.fixture
def state(ref_state):
    return convert.train_state_from_reference(ref_state, "cpu")


def _port_leaves(state):
    """(path, numpy array) of a port state in the reference's order."""
    return [(p, np.asarray(v, np.int32) if isinstance(v, int) else v.numpy())
            for p, v in CK.leaf_items(state)]


def _assert_state_equal(a, b):
    assert a.step == b.step and a.opt.step == b.opt.step
    la, lb = _port_leaves(a), _port_leaves(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (p, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, p
        np.testing.assert_array_equal(x, y, err_msg=p)


def _abstract():
    return TS.abstract_state(R.get_smoke_config(ARCH))


# ----------------------------------------------------------------------------
# the reference's checkpoint tests, on the port
# ----------------------------------------------------------------------------

def test_roundtrip(tmp_path, state):
    CK.save(str(tmp_path), 7, state)
    assert CK.latest_step(str(tmp_path)) == 7
    restored = CK.restore(str(tmp_path), 7, _abstract(), device="cpu")
    _assert_state_equal(state, restored)
    assert isinstance(restored.step, int) and isinstance(restored.opt.step, int)
    assert all(t.device.type == "cpu" and t.dtype == torch.float32
               for t in OPT.tree_leaves(restored.params))


def test_partial_checkpoint_ignored(tmp_path, state):
    CK.save(str(tmp_path), 1, state)
    # a crashed writer: the committed marker missing
    bad = tmp_path / "step_00000009"
    os.makedirs(bad / "arrays")
    (bad / "manifest.json").write_text("{}")
    assert CK.latest_step(str(tmp_path)) == 1
    with pytest.raises(FileNotFoundError):
        CK.restore(str(tmp_path), 9, _abstract(), device="cpu")
    assert CK.latest_step(str(tmp_path / "absent")) is None


def test_corruption_detected(tmp_path, state):
    path = CK.save(str(tmp_path), 3, state)
    target = os.path.join(path, "arrays", "0.npy")
    arr = np.load(target).copy()
    arr.reshape(-1)[0] += 1
    np.save(target, arr)
    with pytest.raises(IOError, match="crc mismatch"):
        CK.restore(str(tmp_path), 3, _abstract(), device="cpu")


def test_gc_keeps_n(tmp_path, state):
    os.makedirs(tmp_path / ".tmp-step_00000099")    # a crashed writer's
    for s in (1, 2, 3, 4, 5):
        CK.save(str(tmp_path), s, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_shape_mismatch_rejected(tmp_path, state):
    CK.save(str(tmp_path), 1, state)
    other = TS.abstract_state(R.get_smoke_config("tinyllama-1.1b"))
    with pytest.raises((ValueError, KeyError)):
        CK.restore(str(tmp_path), 1, other, device="cpu")


def test_missing_leaf_and_wrong_shape_named(tmp_path, state):
    """A leaf absent from the manifest raises `KeyError`, a leaf of
    another shape `ValueError`, each naming the leaf."""
    path = CK.save(str(tmp_path), 2, state)
    mf = os.path.join(path, "manifest.json")
    manifest = json.load(open(mf))
    leaves = manifest["leaves"]
    want = leaves[5]["path"]
    json.dump(dict(manifest, leaves=leaves[:5] + leaves[6:]), open(mf, "w"))
    with pytest.raises(KeyError, match=want.replace("[", r"\[")):
        CK.restore(str(tmp_path), 2, _abstract(), device="cpu")
    json.dump(manifest, open(mf, "w"))
    arr = np.zeros((3,), np.float32)
    np.save(os.path.join(path, leaves[5]["file"]), arr)
    leaves[5]["crc32"] = CK._crc32(arr)
    json.dump(manifest, open(mf, "w"))
    with pytest.raises(ValueError, match="shape mismatch"):
        CK.restore(str(tmp_path), 2, _abstract(), device="cpu")


def test_resume_training_continues(tmp_path):
    """Save mid-run, restore, continue: equal to an uninterrupted run, bit
    for bit."""
    cfg = R.get_smoke_config(ARCH)
    step = TS.make_train_step(cfg, TS.TrainConfig(microbatches=1))
    batch = lambda s: lm_batch(cfg, 4, 32, seed=5, step=s, microbatches=1)
    st = TS.init_state(cfg, 1, device="cpu")
    for s in range(2):
        st, _ = step(st, batch(s))
    CK.save(str(tmp_path), 2, st)
    for s in range(2, 4):
        st, _ = step(st, batch(s))
    st2 = CK.restore(str(tmp_path), 2, _abstract(), device="cpu")
    assert st2.step == st2.opt.step == 2
    for s in range(2, 4):
        st2, _ = step(st2, batch(s))
    _assert_state_equal(st, st2)


def test_restore_needs_a_device_without_cuda(tmp_path, state, monkeypatch):
    CK.save(str(tmp_path), 1, state)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        CK.restore(str(tmp_path), 1, _abstract())


def test_restore_takes_shardings_or_device(tmp_path, state):
    """``shardings=`` places each leaf over its mesh, ``device=`` on one
    device; both at once raise."""
    from repro_torch.launch import mesh as M
    from repro_torch.sharding import array as SA

    CK.save(str(tmp_path), 1, state)
    sh = TS.state_shardings(R.get_smoke_config(ARCH),
                            M.make_mesh((2, 2), ("data", "model"), device="cpu"))
    with pytest.raises(ValueError, match="not both"):
        CK.restore(str(tmp_path), 1, _abstract(), shardings=sh, device="cpu")
    got = CK.restore(str(tmp_path), 1, _abstract(), shardings=sh)
    assert all(isinstance(t, SA.ShardedTensor) for _, t in OPT.tree_items(got.params))
    _assert_state_equal(SA.gather_tree(got, "cpu"), state)
    one = CK.restore(str(tmp_path), 1, _abstract(), device="cpu")
    assert all(isinstance(t, torch.Tensor) for _, t in OPT.tree_items(one.params))


# ----------------------------------------------------------------------------
# the on-disk format across the two packages
# ----------------------------------------------------------------------------

def test_reference_checkpoint_restores_into_port(tmp_path, ref_state):
    JCK.save(str(tmp_path), 4, ref_state)
    assert CK.latest_step(str(tmp_path)) == 4
    got = CK.restore(str(tmp_path), 4, _abstract(), device="cpu")
    _assert_state_equal(got, convert.train_state_from_reference(ref_state, "cpu"))


def test_port_checkpoint_restores_into_reference(tmp_path, ref_state, state):
    CK.save(str(tmp_path), 4, state)
    assert JCK.latest_step(str(tmp_path)) == 4
    got = JCK.restore(str(tmp_path), 4, JTS.abstract_state(JR.get_smoke_config(ARCH)))
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(ref_state)[0]
    assert len(flat_g) == len(flat_w)
    for (pg, g), (pw, w) in zip(flat_g, flat_w):
        assert pg == pw
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(pg))


def test_manifests_equal_as_json(tmp_path, ref_state, state):
    """One state, two writers: the same manifest (paths, files, shapes,
    dtypes, crc32s) and the same bytes in every array file."""
    j = JCK.save(str(tmp_path / "ref"), 6, ref_state)
    p = CK.save(str(tmp_path / "port"), 6, state)
    mj = json.load(open(os.path.join(j, "manifest.json")))
    mp = json.load(open(os.path.join(p, "manifest.json")))
    assert mp == mj
    assert mp["leaves"][-2:] == [
        dict(path=".opt.step", file=f"arrays/{len(mp['leaves']) - 2}.npy", shape=[],
             dtype="int32", crc32=mp["leaves"][-2]["crc32"]),
        dict(path=".step", file=f"arrays/{len(mp['leaves']) - 1}.npy", shape=[],
             dtype="int32", crc32=mp["leaves"][-1]["crc32"])]
    for e in mp["leaves"]:
        assert open(os.path.join(p, e["file"]), "rb").read() == \
            open(os.path.join(j, e["file"]), "rb").read(), e["path"]
    assert sorted(os.listdir(p)) == sorted(os.listdir(j)) == \
        ["COMMITTED", "arrays", "manifest.json"]


@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", sorted(JR.ARCHS))
def test_abstract_state_matches_reference(arch, smoke):
    """`abstract_state`'s leaves against the reference's: the same paths
    in the same order, shapes and dtypes; meta tensors, no storage."""
    get, jget = ((R.get_smoke_config, JR.get_smoke_config) if smoke
                 else (R.get_config, JR.get_config))
    want = jax.tree_util.tree_flatten_with_path(JTS.abstract_state(jget(arch)))[0]
    got = list(CK.leaf_items(TS.abstract_state(get(arch))))
    assert [p for p, _ in got] == [jax.tree_util.keystr(p) for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.device.type == "meta", path
        assert tuple(g.shape) == tuple(w.shape), path
        assert str(g.dtype).removeprefix("torch.") == str(jnp.dtype(w.dtype)), path
