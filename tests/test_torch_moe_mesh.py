"""The port's MoE layer on rows of a larger call (`layers.moe`'s ``tokens``
and ``offset``), the layer under the MoE mesh training step, against the
reference's ``repro.models.layers.moe`` on the whole input, on the CPU at
smoke size.

x [4, 16, d] is split into R row blocks; each block runs with the whole
call's token count and, as its offset, the slot counts the blocks before
it returned; the blocks' outputs, concatenated, must equal the reference
on all of x within 1e-5 of the largest output (the layer tolerance of
`tests/test_torch_moe_rwkv.py`). grok-1 (top-2) and llama4 (top-1, a
shared expert), gather and einsum dispatch, R = 2 and 4, at a capacity
factor at which slots drop. A naive split (each block its own C, no
offset) is another function: the same test shows it misses. With its
defaults the layer is bit for bit the call with the whole call's count
and zero offsets.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import checkpoint as CK

from repro.configs import registry as JR
from repro.models import layers as JL
from repro.models import params as JP
from repro_torch import convert
from repro_torch.configs import registry as R
from repro_torch.models import layers as LY
from repro_torch.models import params as MP
from repro_torch.models import transformer as T

MOE = ("grok-1-314b", "llama4-maverick-400b-a17b")
LAYER_TOL = 1e-5
B, S = 4, 16
#: slots drop at this factor in both archs on these inputs
DROPPING = 0.5


def _layer(arch):
    """(reference config, port config, layer 0's MoE parameters in each)."""
    cfg_j, cfg_t = JR.get_smoke_config(arch), R.get_smoke_config(arch)
    ref = JP.init_params(cfg_j, jax.random.PRNGKey(0))
    mine = convert.lm_params_from_reference(jax.tree.map(np.asarray, ref), "cpu")
    return (cfg_j, cfg_t, jax.tree.map(lambda a: a[0], ref["blocks"]["moe"]),
            T._layer(mine["blocks"], 0)["moe"])


def _x(arch, cfg):
    return np.random.default_rng(len(arch)).normal(size=(B, S, cfg.d_model)).astype(np.float32)


def _split(x, p, cfg, n_blocks, offsets: bool, **kw):
    """The layer over ``n_blocks`` row blocks of x, concatenated, and the
    blocks' summed slot counts: each block with the whole call's token
    count and the running offsets, or (``offsets=False``) on its own."""
    ys, total = [], torch.zeros((cfg.num_experts,), dtype=torch.int64)
    for xb in torch.chunk(x, n_blocks):
        extra = dict(tokens=x.shape[0] * x.shape[1], offset=total) if offsets else {}
        y, counts = LY.moe(xb, p, cfg, return_counts=True, **extra, **kw)
        ys.append(y)
        total = total + counts
    return torch.cat(ys), total


@pytest.mark.parametrize("n_blocks", [2, 4])
@pytest.mark.parametrize("dispatch", ["gather", "einsum"])
@pytest.mark.parametrize("arch", MOE)
def test_row_blocks_with_offsets_match_the_whole_call(arch, dispatch, n_blocks):
    cfg_j, cfg_t, p_j, p_t = _layer(arch)
    x = _x(arch, cfg_t)
    kw = dict(capacity_factor=DROPPING, dispatch=dispatch)
    want = np.asarray(JL.moe(jnp.asarray(x), p_j, cfg_j, **kw))
    got, counts = _split(torch.from_numpy(x), p_t, cfg_t, n_blocks, True, **kw)
    E, K = cfg_t.num_experts, cfg_t.experts_per_token
    # every slot counted once, and some expert over its capacity
    assert int(counts.sum()) == B * S * K
    assert int((counts - LY.capacity(B * S, E, K, DROPPING)).clamp_min(0).sum()) > 0
    scale = np.abs(want).max()
    assert np.abs(got.numpy() - want).max() <= LAYER_TOL * scale
    naive, _ = _split(torch.from_numpy(x), p_t, cfg_t, n_blocks, False, **kw)
    assert np.abs(naive.numpy() - want).max() > 100 * LAYER_TOL * scale


@pytest.mark.parametrize("arch", MOE)
def test_defaults_are_the_whole_call_with_zero_offsets(arch):
    """Bit for bit: the defaults, the explicit token count with zero
    offsets, and one row block through `_split`; in float32 and bf16."""
    _, cfg, _, p = _layer(arch)
    x = torch.from_numpy(_x(arch, cfg))
    zero = torch.zeros((cfg.num_experts,), dtype=torch.int64)
    for dt in (torch.float32, torch.bfloat16):
        xd, pd = x.to(dt), {k: v.to(dt) for k, v in p.items()}
        for kw in (dict(), dict(capacity_factor=DROPPING), dict(dispatch="einsum")):
            want = LY.moe(xd, pd, cfg, **kw)
            assert torch.equal(LY.moe(xd, pd, cfg, tokens=B * S, offset=zero, **kw), want)
            assert torch.equal(_split(xd, pd, cfg, 1, True, **kw)[0], want)


def test_slots_keep_by_offset_and_place_by_own_count():
    """Expert 0's queue holds 3 slots ahead of this call's: at C = 4 only
    its first slot here is kept, in column 0 of this call's table."""
    experts = torch.tensor([[0], [0], [1], [0]])
    table, row, keep = LY.slots(experts, 2, 4, torch.tensor([3, 0]))
    assert keep[:, 0].tolist() == [True, False, True, False]
    assert table.tolist() == [[0, 4, 4, 4], [2, 4, 4, 4]]
    assert row[:, 0].tolist() == [0, 8, 4, 8]


def test_routing_record_sums_replicas_without_changing_a_read_offset():
    """`transformer.Routing`: zeros before any replica, the running sum
    after; an offset already read is never written in place; drops are
    each expert's count past C."""
    rec = T.Routing(tokens=8)
    first = rec.offset(0, 4, "cpu")
    assert first.tolist() == [0, 0, 0, 0]
    rec.add(0, torch.tensor([5, 1, 0, 2]))
    read = rec.offset(0, 4, "cpu")
    rec.add(0, torch.tensor([3, 0, 4, 0]))
    assert read.tolist() == [5, 1, 0, 2] and first.tolist() == [0, 0, 0, 0]
    assert rec.offset(0, 4, "cpu").tolist() == [8, 1, 4, 2]
    # C = int(1.25 · 2 · 8 / 4) = 5: expert 0 drops 3
    assert [int(d) for d in rec.dropped(K=2, E=4)] == [3]


def test_layer_routing_reads_its_offset_once_per_call():
    """A one-layer stack under ``torch.utils.checkpoint`` with a routing
    record, its gradient taken: the record holds the layer's counts once
    (the recomputation adds nothing), equal to the whole call's. Also with
    the checkpoint's early stop off, so the recomputation runs the whole
    layer, MoE call included."""
    cfg = dataclasses.replace(R.get_smoke_config(MOE[0]), num_layers=1)
    params = MP.init_params(cfg, 0, device="cpu")
    x = torch.from_numpy(_x(MOE[0], cfg)).requires_grad_()
    cs = T._rope(cfg, T._positions(S, "cpu"))
    want = T.Routing(B * S)
    with torch.no_grad():
        T._train_blocks(x, params["blocks"], cfg, cs, routing=want)
    assert int(want.counts[0].sum()) == B * S * cfg.experts_per_token
    for policy in ("nothing", "dots"):
        for early_stop in (True, False):
            rec = T.Routing(B * S)
            with CK.set_checkpoint_early_stop(early_stop):
                y = T._train_blocks(x, params["blocks"], cfg, cs, remat_policy=policy,
                                    routing=rec)
                torch.autograd.grad(y.square().sum(), x)
            assert len(rec.counts) == 1 and torch.equal(rec.counts[0], want.counts[0]), \
                (policy, early_stop)
