"""The training step: microbatched, mixed precision, on one device or
sharded over a named mesh.

The port of ``repro.train.train_step`` (`TrainState`, `TrainConfig`,
`init_state`, `abstract_state`, `state_shardings`, `batch_shardings`,
`reshape_batch`, `make_train_step`):

  * parameters and optimizer state in float32;
  * the forward and backward in ``cfg.dtype`` through a cast copy of the
    parameters, so a bf16 config's gradients are bf16;
  * the global batch split microbatch-major, ``[n_mb, mb, ...]``, each
    microbatch's gradients added in float32, the sum divided by ``n_mb``;
  * AdamW (`repro_torch.train.optimizer`) on the float32 master weights.

Each microbatch's gradient is one ``torch.autograd.grad`` through
`repro_torch.models.transformer.forward_train`, whose layers are
recomputed in the backward; its attention gradient is the backward kernel
on the card. The step updates the state's tensors in place (the
reference's step donates them) and returns the state with its step
advanced. ``TrainConfig.remat`` and ``moe_aux_weight`` are carried and not
read, as the reference leaves them.

On a mesh (`repro_torch.launch.mesh.NamedMesh`) the state is sharded by
`state_shardings` (ZeRO-3: parameters and both moments cut over every mesh
axis their logical axes name) and the step is data-parallel: each
microbatch's rows are split over the replicas that `batch_shardings` gives
its batch dim, each replica gathers the parameters onto its device in
``cfg.dtype``, runs the forward and backward on its rows, and adds its
float32 gradients into each leaf's blocks (`accumulate_grads_mesh`). The
loss is combined by its sums and the global count of labels, so it is the
function the one-device step computes; an MoE config's replicas share
each microbatch's expert queues through a routing record, so they drop
the slots one device drops. Compute on the "model" axis is not split (no
tensor-parallel or expert-parallel products): that axis shards storage
only.
The reference's ``compile_train_step`` lowers to XLA for its dry run and
has no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import NamedMesh
from repro_torch.models import params as MP
from repro_torch.models import transformer as T
from repro_torch.sharding import array as SA
from repro_torch.sharding import rules as shr
from repro_torch.train import optimizer as OPT


@dataclasses.dataclass
class TrainState:
    params: dict
    opt: OPT.AdamWState
    step: int


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 8
    opt: OPT.AdamWConfig = OPT.AdamWConfig()
    remat: bool = True
    remat_policy: str = "nothing"   # nothing | dots
    moe_aux_weight: float = 0.0


def init_state(cfg: ModelConfig, seed: int, device: D.DeviceLike = None) -> TrainState:
    """Fresh float32 parameters from ``seed`` (`params.init_params`), zero
    moments, step 0, on ``device`` (the card unless named)."""
    params = MP.init_params(cfg, seed, device)
    return TrainState(params=params, opt=OPT.init(params), step=0)


def abstract_state(cfg: ModelConfig) -> TrainState:
    """A `TrainState` of ``meta`` tensors (shapes and dtypes, no storage):
    the float32 parameters, ``mu`` and ``nu``, and both steps as int32
    scalars, the structure `checkpoint.restore` fills (it gives the steps
    back as host integers)."""
    params = MP.abstract_params(cfg)
    step = lambda: torch.empty((), dtype=torch.int32, device="meta")
    return TrainState(
        params=params,
        opt=OPT.AdamWState(mu=MP.abstract_params(cfg), nu=MP.abstract_params(cfg),
                           step=step()),
        step=step())


def state_shardings(cfg: ModelConfig, mesh: NamedMesh) -> TrainState:
    """A `TrainState` of `NamedSharding`s: the parameters and both moments
    by `params.param_shardings`, the step counts replicated."""
    ps = MP.param_shardings(cfg, mesh)
    scalar = shr.NamedSharding(mesh, shr.P())
    return TrainState(params=ps, opt=OPT.AdamWState(mu=ps, nu=ps, step=scalar), step=scalar)


def batch_shardings(cfg: ModelConfig, mesh: NamedMesh, batch_specs: Dict[str, Any],
                    microbatches: int) -> Dict[str, shr.NamedSharding]:
    """Microbatch-major layout: each input [B, ...] (anything with a
    ``.shape``) → [n_mb, B/n_mb, ...] with the per-microbatch batch dim
    sharded over ("pod", "data")."""
    out = {}
    for k, v in batch_specs.items():
        shape = (microbatches, v.shape[0] // microbatches) + tuple(v.shape[1:])
        axes = [None, "batch"] + [None] * (len(v.shape) - 1)
        out[k] = shr.named_sharding(axes, shape, mesh)
    return out


def reshape_batch(batch: Dict[str, Any], microbatches: int) -> Dict[str, Any]:
    """Each input [B, ...] → microbatch-major [n_mb, B / n_mb, ...]."""
    return {k: v.reshape((microbatches, v.shape[0] // microbatches) + tuple(v.shape[1:]))
            for k, v in batch.items()}


def _nest(items) -> dict:
    out: dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def accumulate_grads(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                     remat_policy: str = "nothing"):
    """(the mean of the microbatches' losses, the mean of their gradients
    in float32, a dict of ``params``' keys) over a microbatch-major
    ``batch`` [n_mb, mb, ...] on ``params``' device: the forward and
    backward on a ``cfg.dtype`` copy of ``params``, each microbatch's
    gradients added in float32 in order, the sums divided by ``n_mb``."""
    cdtype = getattr(torch, cfg.dtype)
    items = list(OPT.tree_items(params))
    dev = items[0][1].device
    cparams = _nest((path, p.detach().to(cdtype).requires_grad_()) for path, p in items)
    leaves = OPT.tree_leaves(cparams)
    gacc = [torch.zeros(p.shape, dtype=torch.float32, device=dev) for _, p in items]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    n_mb = next(iter(batch.values())).shape[0]
    for i in range(n_mb):
        loss = T.forward_train(cparams, cfg, {k: v[i] for k, v in batch.items()},
                               remat_policy=remat_policy)
        # a leaf the loss does not read (an unused adapter) gets 0
        for a, g in zip(gacc, torch.autograd.grad(loss, leaves, allow_unused=True)):
            if g is not None:
                a.add_(g)
        loss_sum = loss_sum + loss.detach()
    torch._foreach_div_(gacc, n_mb)
    return loss_sum / n_mb, _nest((path, g) for (path, _), g in zip(items, gacc))


def replicas(cfg: ModelConfig, mesh: NamedMesh, batch: Dict[str, Any]):
    """[(device, rows)] of each data-parallel replica of a microbatch-major
    ``batch`` [n_mb, mb, ...], in replica order: the mesh axes that
    `batch_shardings` gives the microbatch's batch dim (none when it is
    replicated) index the replicas major to minor; replica r computes on
    the device at its coordinates on them and 0 on every other axis, on
    rows [r·mb/R, (r+1)·mb/R) of each microbatch."""
    n_mb, mb = next(iter(batch.values())).shape[:2]
    spec = batch_shardings(cfg, mesh, {"rows": torch.empty((n_mb * mb,), device="meta")},
                           n_mb)["rows"].spec
    axes = shr.spec_axes(spec, 2)[1]
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    out = []
    for r in range(n):
        coords, rest = {}, r
        for a in reversed(axes):
            coords[a], rest = rest % mesh.shape[a], rest // mesh.shape[a]
        out.append((mesh.devices[mesh.flat(coords)], slice(r * mb // n, (r + 1) * mb // n)))
    return out


def _gather_params(items, dev, dtype) -> dict:
    """A ``dtype`` copy of every sharded parameter, whole on ``dev``, as
    leaves that take a gradient."""
    return _nest((path, SA.gather(st, dev, dtype).requires_grad_()) for path, st in items)


def _reduce_grad(acc: SA.ShardedTensor, g: torch.Tensor) -> None:
    """Add one replica's whole gradient ``g`` into each block of ``acc``
    (float32), every replicated copy included."""
    for f, b in enumerate(acc.blocks):
        b.add_(g[SA.block_slices(acc.sharding, acc.shape, f)].to(b.device))


def accumulate_grads_mesh(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
                          mesh: NamedMesh, remat_policy: str = "nothing"):
    """`accumulate_grads` over parameters sharded on ``mesh`` → (the mean
    of the microbatches' losses on the mesh's first device, a dict of
    float32 gradients sharded as the parameters). Each microbatch's rows
    are split over the `replicas`; replica r's gradient is that of its
    rows' NLL sum over the microbatch's count of labels ≥ 0, so the
    replicas' gradients, added into the blocks in replica order, are the
    gradient of the microbatch's masked token mean; the sums over the
    microbatches are divided by ``n_mb``.

    An MoE config's capacity dispatch couples a microbatch's rows: C is
    set by its token count, and a slot's place in its expert's queue is a
    running count over all its (token, k) slots. Each microbatch gets a
    fresh `transformer.Routing` record of its token count (never a
    replica's), and the replicas run in order: at each MoE layer a replica
    reads the [E] slot counts the earlier ones sent to each expert as its
    offset and adds its own, so every replica keeps and drops the slots
    the one-device step does. The counts move between replicas' devices
    with ``.to``, with no host sync. A runtime whose replicas run
    concurrently would exchange the same counts at each MoE layer: an
    all-gather of the replicas' [R, E] counts and an exclusive cumsum over
    R. The port runs the replicas in order on one queue. The experts are
    gathered whole on each replica (no expert-parallel compute)."""
    cdtype = getattr(torch, cfg.dtype)
    items = list(OPT.tree_items(params))
    dev0 = mesh.devices[0]
    gacc = [SA.zeros(st.shape, torch.float32, st.sharding) for _, st in items]
    reps = replicas(cfg, mesh, batch)
    labels = batch[T.label_key(cfg)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev0)
    n_mb = labels.shape[0]
    for i in range(n_mb):
        count = (labels[i] >= 0).sum(dtype=torch.float32).to(dev0).clamp_min(1.0)
        nll_mb = torch.zeros((), dtype=torch.float32, device=dev0)
        routing = T.Routing(batch["tokens"][i].numel()) if cfg.num_experts > 0 else None
        for dev, rows in reps:
            cparams = _gather_params(items, dev, cdtype)
            nll, _ = T.loss_sums(cparams, cfg, {k: v[i, rows].to(dev) for k, v in batch.items()},
                                 remat_policy=remat_policy, routing=routing)
            # a leaf the loss does not read (an unused adapter) gets 0
            grads = torch.autograd.grad(nll / count.to(dev), OPT.tree_leaves(cparams),
                                        allow_unused=True)
            del cparams
            for acc, g in zip(gacc, grads):
                if g is not None:
                    _reduce_grad(acc, g)
            del grads
            nll_mb = nll_mb + nll.detach().to(dev0)
        loss_sum = loss_sum + nll_mb / count
    for acc in gacc:
        torch._foreach_div_(acc.blocks, n_mb)
    return loss_sum / n_mb, _nest((path, g) for (path, _), g in zip(items, gacc))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh: Optional[NamedMesh] = None):
    """Returns ``train_step(state, batch) → (state, metrics)``: ``batch``
    microbatch-major, each input [n_mb, mb, ...] (tensors or numpy arrays,
    moved to the state's device, or each replica's rows to its device on a
    mesh); `accumulate_grads` (`accumulate_grads_mesh` with ``mesh``), then
    AdamW on the float32 master weights (`optimizer.apply_sharded` on a
    mesh); ``metrics`` {"loss" (the mean of the microbatches' losses),
    "grad_norm" (before clipping), "lr"}. With ``mesh`` the state is
    sharded by `state_shardings` (`sharding.array.device_put`) and leaves
    sharded the same way. Raises `TypeError` for a mesh that is not a
    `NamedMesh`."""
    if mesh is not None and (not isinstance(mesh, NamedMesh) or mesh.devices is None):
        raise TypeError(f"make_train_step(mesh=...) takes a NamedMesh with devices "
                        f"(launch.mesh.make_mesh), not {mesh!r}")

    def train_step(state: TrainState, batch):
        if mesh is None:
            dev = OPT.tree_leaves(state.params)[0].device
            batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
            loss, grads = accumulate_grads(cfg, state.params, batch, tcfg.remat_policy)
            params, opt, om = OPT.apply(state.params, grads, state.opt, tcfg.opt)
        else:
            batch = {k: torch.as_tensor(v) for k, v in batch.items()}
            loss, grads = accumulate_grads_mesh(cfg, state.params, batch, mesh,
                                                tcfg.remat_policy)
            params, opt, om = OPT.apply_sharded(state.params, grads, state.opt, tcfg.opt)
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, **om})

    return train_step
