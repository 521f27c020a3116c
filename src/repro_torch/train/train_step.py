"""The training step: microbatched, mixed precision, on one device.

The port of ``repro.train.train_step``'s step (`TrainState`,
`TrainConfig`, `init_state`, `abstract_state`, `reshape_batch`,
`make_train_step`):

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
read, as the reference leaves them. The mesh layout (``mesh=``, the
shardings, ``compile_train_step``) is not ported: it raises.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch import device as D
from repro_torch.configs.base import ModelConfig
from repro_torch.models import params as MP
from repro_torch.models import transformer as T
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


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, mesh: Optional[Any] = None):
    """Returns ``train_step(state, batch) → (state, metrics)``: ``batch``
    microbatch-major, each input [n_mb, mb, ...] (tensors or numpy arrays,
    moved to the state's device); `accumulate_grads`, then AdamW on the
    float32 master weights; ``metrics`` {"loss" (the mean of the
    microbatches' losses), "grad_norm" (before clipping), "lr"}."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_step(mesh=...): the training mesh layout is not ported "
            "(ROADMAP.md queue 1 item 4, training's sharding helpers)")

    def train_step(state: TrainState, batch):
        dev = OPT.tree_leaves(state.params)[0].device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, grads = accumulate_grads(cfg, state.params, batch, tcfg.remat_policy)
        params, opt, om = OPT.apply(state.params, grads, state.opt, tcfg.opt)
        return (TrainState(params=params, opt=opt, step=state.step + 1),
                {"loss": loss, **om})

    return train_step
