"""The port's sharded training step (`make_train_step(mesh=...)`,
`accumulate_grads_mesh`, `optimizer.apply_sharded`) and sharded
checkpoints on CPU meshes, at smoke size.

The mesh step is held to the port's one-device step for all ten configs
on three meshes: (2, 2) and (1, 2) on ("data", "model") and (2, 1, 2) on
("pod", "data", "model"); for tinyllama and grok-1 also to the
reference's one-device ``make_train_step``, two steps from its own
initial state. The reference's mesh step is not the yardstick:
``tests/test_distributed.py``'s mesh train test is red under jax 0.9
(ROADMAP §3), and the function GSPMD's sharded step computes is the
one-device step's. Then the places a mesh step is likely to go wrong:
the masked-token mean over replicas (labels masked in one replica's rows
only; a mean of the replicas' means is another number), the gradient norm
with a replicated leaf (a copy counted once), and MoE capacity, which
couples a microbatch's rows (slots drop in the batch used, and a naive
split, each replica its own capacity, misses the one-device loss; the
routing record under ``remat_policy="dots"``); other meshes refused; a
sharded save bit-equal to the unsharded one and restored by the
reference; the reference's checkpoint restored with ``shardings=`` onto
two meshes.

Tolerances are `tests/test_torch_train.py`'s: the loss within 2e-5
relative, the gradient norm 1e-5, the rate 1e-6, each moment leaf within
2e-4 of its largest entry, the parameters within 1e-6, and (from
`tests/test_torch_train_families.py`) each gradient leaf within 2e-4 of its
largest entry. AdamW runs with ``eps=1e-3`` for the reason given there.
Replicated copies stay bit-identical after every step.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as JR
from repro.train import checkpoint as JCK
from repro.train import optimizer as JO
from repro.train import train_step as JTS
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.data.pipeline import lm_batch
from repro_torch.launch import mesh as M
from repro_torch.models import params as MP
from repro_torch.models import transformer as T
from repro_torch.sharding import array as SA
from repro_torch.train import checkpoint as CK
from repro_torch.train import optimizer as OPT
from repro_torch.train import train_step as TS
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

LOSS_TOL, NORM_TOL, LR_TOL, MOMENT_TOL, PARAM_TOL = 2e-5, 1e-5, 1e-6, 2e-4, 1e-6
GRAD_TOL = 2e-4
ROW_INDEPENDENT = ["tinyllama-1.1b", "qwen1.5-0.5b", "phi3-mini-3.8b", "starcoder2-15b",
                   "llava-next-mistral-7b", "hymba-1.5b", "whisper-small", "rwkv6-3b"]
MOE = ["grok-1-314b", "llama4-maverick-400b-a17b"]
MESHES = {"2x2": ((2, 2), ("data", "model")), "1x2": ((1, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
OPT_KW = dict(lr=1e-3, warmup_steps=0, eps=1e-3)
#: 4 rows of 16 tokens in 2 microbatches: 2 rows a microbatch, one a replica
#: on the meshes with 2 data replicas
B, S, N_MB = 4, 16, 2
REF_ARCH = "tinyllama-1.1b"
MOE_REF_ARCH = "grok-1-314b"


def _mesh(name):
    return M.make_mesh(*MESHES[name], device="cpu")


def _tcfg(**kw):
    return TS.TrainConfig(microbatches=N_MB, opt=OPT.AdamWConfig(**OPT_KW), **kw)


def _batch(cfg, step):
    return {k: torch.from_numpy(v) for k, v in
            lm_batch(cfg, B, S, seed=3, step=step, microbatches=N_MB).items()}


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _assert_metrics(got, want):
    for k, tol in (("loss", LOSS_TOL), ("grad_norm", NORM_TOL), ("lr", LR_TOL)):
        assert abs(float(got[k]) - float(want[k])) <= tol * abs(float(want[k])), k


def _assert_state_close(sharded, want_params, want_mu, want_nu):
    """A sharded state's gathered parameters and moments against numpy
    trees keyed by path; every replicated copy bit-identical."""
    assert all(SA.copies_equal(t) for t in SA.leaves(sharded))
    got = SA.gather_tree(sharded, "cpu")
    for tree, want, rel in ((got.params, want_params, False), (got.opt.mu, want_mu, True),
                            (got.opt.nu, want_nu, True)):
        for path, t in OPT.tree_items(tree):
            w = want[path]
            if rel:
                assert _rel(t.numpy(), w) <= MOMENT_TOL, path
            else:
                assert t.dtype == torch.float32
                assert np.abs(t.numpy() - w).max() <= PARAM_TOL, path


def _np_tree(tree) -> dict:
    return {path: t.detach().numpy() for path, t in OPT.tree_items(tree)}


@pytest.fixture(scope="module")
def one_device():
    """arch → (the metrics, the state) after one step of the port's
    one-device step from seed 0, run once per module."""
    memo = {}

    def run(arch):
        if arch not in memo:
            cfg = R.get_smoke_config(arch)
            state = TS.init_state(cfg, 0, device="cpu")
            step = TS.make_train_step(cfg, _tcfg())
            state, m = step(state, _batch(cfg, 0))
            memo[arch] = (m, state)
        return memo[arch]

    return run


def _mesh_step_matches_one_device(arch, mesh_name, one_device, **tkw):
    cfg, mesh = R.get_smoke_config(arch), _mesh(mesh_name)
    want_m, want = one_device(arch)
    state = SA.device_put(TS.init_state(cfg, 0, device="cpu"), TS.state_shardings(cfg, mesh))
    state, m = TS.make_train_step(cfg, _tcfg(**tkw), mesh=mesh)(state, _batch(cfg, 0))
    assert state.step == state.opt.step == 1
    _assert_metrics(m, want_m)
    _assert_state_close(state, _np_tree(want.params), _np_tree(want.opt.mu),
                        _np_tree(want.opt.nu))


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ROW_INDEPENDENT + MOE)
def test_mesh_step_matches_one_device(arch, mesh_name, one_device):
    _mesh_step_matches_one_device(arch, mesh_name, one_device)


def test_moe_mesh_step_under_dots_remat_matches_one_device(one_device):
    """grok-1 on (2, 2) with ``remat_policy="dots"``: the recomputed layers
    read the offsets their forward read, and the routing record counts
    each replica once (slots drop in microbatch 1)."""
    _mesh_step_matches_one_device(MOE_REF_ARCH, "2x2", one_device, remat_policy="dots")


def _reference_run(arch):
    """The reference's smoke state of ``arch`` from PRNGKey(0), its
    one-device step's metrics over two steps, and its final state."""
    jcfg = JR.get_smoke_config(arch)
    js0 = jax.device_get(JTS.init_state(jcfg, jax.random.PRNGKey(0)))
    jstep = jax.jit(JTS.make_train_step(
        jcfg, JTS.TrainConfig(microbatches=N_MB, opt=JO.AdamWConfig(**OPT_KW))))
    js, metrics = js0, []
    for s in range(2):
        js, jm = jstep(js, {k: v.numpy() for k, v in _batch(R.get_smoke_config(arch),
                                                           s).items()})
        metrics.append({k: float(v) for k, v in jm.items()})
    return js0, metrics, jax.device_get(js)


@pytest.fixture(scope="module")
def reference_run():
    """`_reference_run` of tinyllama."""
    return _reference_run(REF_ARCH)


def _ref_tree(tree) -> dict:
    return {tuple(k.key for k in p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _mesh_steps_match_reference(arch, mesh_name, run):
    """Two mesh steps from the reference's own initial state against its
    one-device ``make_train_step``; the same two steps run again are
    bit-equal."""
    js0, want_metrics, js = run
    cfg, mesh = R.get_smoke_config(arch), _mesh(mesh_name)
    runs = []
    for _ in range(2):
        state = SA.device_put(convert.train_state_from_reference(js0, "cpu"),
                              TS.state_shardings(cfg, mesh))
        step = TS.make_train_step(cfg, _tcfg(), mesh=mesh)
        for s, want in enumerate(want_metrics):
            state, m = step(state, _batch(cfg, s))
            _assert_metrics(m, want)
        runs.append(SA.gather_tree(state, "cpu"))
    _assert_state_close(state, _ref_tree(js.params), _ref_tree(js.opt.mu), _ref_tree(js.opt.nu))
    for (_, a), (_, b) in zip(CK.leaf_items(runs[0]), CK.leaf_items(runs[1])):
        assert a == b if isinstance(a, int) else torch.equal(a, b)


@pytest.mark.parametrize("mesh_name", MESHES)
def test_tinyllama_mesh_step_matches_reference(mesh_name, reference_run):
    _mesh_steps_match_reference(REF_ARCH, mesh_name, reference_run)


def test_grok_mesh_step_matches_reference():
    """grok-1's expert capacity on a (2, 2) mesh: the reference's
    one-device step's function, two steps."""
    _mesh_steps_match_reference(MOE_REF_ARCH, "2x2", _reference_run(MOE_REF_ARCH))


def test_moe_slots_drop_and_a_naive_split_misses():
    """grok-1 on (2, 2), the batch of the tests above: its second
    microbatch drops slots at both layers. Each replica on its own (its
    rows' C, no offsets) misses the one-device loss by far more than the
    tolerance; the mesh's accumulated loss and gradients hold."""
    cfg, mesh = R.get_smoke_config(MOE_REF_ARCH), _mesh("2x2")
    batch = _batch(cfg, 0)
    params = TS.init_state(cfg, 0, device="cpu").params
    reps = TS.replicas(cfg, mesh, batch)
    assert len(reps) == 2
    naive, dropped = 0.0, []
    with torch.no_grad():
        for i in range(N_MB):
            rows = [{k: v[i, r] for k, v in batch.items()} for _, r in reps]
            count = float((batch["labels"][i] >= 0).sum())
            naive += sum(float(T.loss_sums(params, cfg, b)[0]) for b in rows) / count / N_MB
            routing = T.Routing(batch["tokens"][i].numel())
            for b in rows:
                T.loss_sums(params, cfg, b, routing=routing)
            dropped.append([int(d) for d in routing.dropped(cfg.experts_per_token,
                                                            cfg.num_experts)])
    assert sum(map(sum, dropped)) > 0, dropped
    loss1, g1 = TS.accumulate_grads(cfg, params, batch)
    assert abs(naive - float(loss1)) > 10 * LOSS_TOL * float(loss1)
    lossm, gm = TS.accumulate_grads_mesh(
        cfg, SA.device_put(params, MP.param_shardings(cfg, mesh)), batch, mesh)
    assert abs(float(lossm) - float(loss1)) <= LOSS_TOL * float(loss1)
    for (path, a), (_, b) in zip(OPT.tree_items(SA.gather_tree(gm, "cpu")),
                                 OPT.tree_items(g1)):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_TOL, path


def test_masked_labels_in_one_replica_combine_by_sums():
    """Labels masked in replica 0's rows only (3/4 of its tokens): the
    mesh's loss and gradients are the one-device masked token mean's,
    which a mean of the replicas' means is not."""
    cfg, mesh = R.get_smoke_config(REF_ARCH), _mesh("2x2")
    batch = _batch(cfg, 0)
    reps = TS.replicas(cfg, mesh, batch)
    assert [r for _, r in reps] == [slice(0, 1), slice(1, 2)]
    batch["labels"][:, reps[0][1], : 3 * S // 4] = -1
    params = TS.init_state(cfg, 0, device="cpu").params
    loss1, g1 = TS.accumulate_grads(cfg, params, batch)
    lossm, gm = TS.accumulate_grads_mesh(
        cfg, SA.device_put(params, MP.param_shardings(cfg, mesh)), batch, mesh)
    assert abs(float(lossm) - float(loss1)) <= LOSS_TOL * float(loss1)
    gm = SA.gather_tree(gm, "cpu")
    for (path, a), (_, b) in zip(OPT.tree_items(gm), OPT.tree_items(g1)):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_TOL, path
    with torch.no_grad():
        means = np.mean([float(T.forward_train(params, cfg, {k: v[i, rows]
                                                             for k, v in batch.items()}))
                         for i in range(N_MB) for _, rows in reps])
    assert abs(means - float(loss1)) > 100 * LOSS_TOL * float(loss1)


def test_grad_norm_counts_a_replicated_block_once():
    """On (1, 2) every ``embed``-sharded leaf is whole on both devices (ln1
    among them): the norm counts each copy once, as the one-device norm
    does; counting every copy would give another number."""
    cfg, mesh = R.get_smoke_config(REF_ARCH), _mesh("1x2")
    state = TS.init_state(cfg, 0, device="cpu")
    batch = _batch(cfg, 0)
    _, g1 = TS.accumulate_grads(cfg, state.params, batch)
    sharded = SA.device_put(state, TS.state_shardings(cfg, mesh))
    _, gm = TS.accumulate_grads_mesh(cfg, sharded.params, batch, mesh)
    ln1 = gm["blocks"]["ln1"]
    assert len(ln1.blocks) == 2 and SA.first_copies(ln1.sharding, 2) == [0]
    every_copy = float(torch.sqrt(sum(b.square().sum() for g in SA.leaves(gm)
                                      for b in g.blocks)))
    want = float(OPT.global_norm(g1))
    _, _, om = OPT.apply_sharded(sharded.params, gm, sharded.opt, OPT.AdamWConfig(**OPT_KW))
    assert abs(float(om["grad_norm"]) - want) <= NORM_TOL * want
    assert abs(every_copy - want) > 10 * NORM_TOL * want
    assert all(SA.copies_equal(t) for t in SA.leaves(sharded))


@pytest.mark.parametrize("mesh", [M.make_abstract_mesh((2, 2), ("data", "model")),
                                  (torch.device("cpu"),) * 4],
                         ids=["abstract", "flat"])
def test_mesh_step_needs_a_named_mesh_with_devices(mesh):
    with pytest.raises(TypeError, match="NamedMesh"):
        TS.make_train_step(R.get_smoke_config(REF_ARCH), _tcfg(), mesh=mesh)


def test_sharded_save_is_the_unsharded_save_and_the_reference_restores_it(tmp_path):
    cfg, mesh = R.get_smoke_config(REF_ARCH), _mesh("2x2")
    state = SA.device_put(TS.init_state(cfg, 0, device="cpu"), TS.state_shardings(cfg, mesh))
    state, _ = TS.make_train_step(cfg, _tcfg(), mesh=mesh)(state, _batch(cfg, 0))
    whole = SA.gather_tree(state, "cpu")
    p = CK.save(str(tmp_path / "mesh"), 1, state)
    q = CK.save(str(tmp_path / "one"), 1, whole)
    manifest = json.load(open(os.path.join(p, "manifest.json")))
    assert manifest == json.load(open(os.path.join(q, "manifest.json")))
    for e in manifest["leaves"]:
        assert open(os.path.join(p, e["file"]), "rb").read() == \
            open(os.path.join(q, e["file"]), "rb").read(), e["path"]
    got = JCK.restore(str(tmp_path / "mesh"), 1, JTS.abstract_state(JR.get_smoke_config(REF_ARCH)))
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    items = list(CK.leaf_items(whole))
    assert [jax.tree_util.keystr(k) for k, _ in flat] == [k for k, _ in items]
    for (_, g), (path, w) in zip(flat, items):
        w = np.asarray(w, np.int32) if isinstance(w, int) else w.numpy()
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=path)


@pytest.mark.parametrize("mesh_name", ["4x1", "2x1x2"])
def test_reference_checkpoint_restores_onto_a_mesh(tmp_path, mesh_name, reference_run):
    """The elastic path: the reference's one-device checkpoint placed on a
    mesh the saver never had, every leaf bit-equal once gathered."""
    js0 = reference_run[0]
    shape, axes = {"4x1": ((4, 1), ("data", "model")), "2x1x2": MESHES["2x1x2"]}[mesh_name]
    cfg, mesh = R.get_smoke_config(REF_ARCH), M.make_mesh(shape, axes, device="cpu")
    JCK.save(str(tmp_path), 5, js0)
    got = CK.restore(str(tmp_path), 5, TS.abstract_state(cfg),
                     shardings=TS.state_shardings(cfg, mesh))
    assert all(len(t.blocks) == mesh.size and SA.copies_equal(t) for t in SA.leaves(got))
    want = convert.train_state_from_reference(js0, "cpu")
    for (path, a), (_, b) in zip(CK.leaf_items(SA.gather_tree(got, "cpu")),
                                 CK.leaf_items(want)):
        assert a == b if isinstance(a, int) else torch.equal(a, b), path
