"""AdamW with linear warmup, cosine decay and global-norm clipping.

The port of ``repro.train.optimizer``: the same config, defaults and
update. Master parameters and both moments are float32 tensors in nested
dicts of the parameters' keys; leaves are taken in sorted-key order, as
JAX flattens a dict. The step count is a host integer, so the schedule and
the bias corrections are float32 numbers computed on the host (numpy
float32, as the reference computes them on the device) and no step waits
on the card for them. Unlike the reference, whose arrays are immutable,
`apply` updates the parameters and moments in place (the reference's step
donates them): an optimizer step allocates one leaf's temporaries at a
time, not a copy of the state. `apply_sharded` is the same step over a
state sharded on a named mesh (ZeRO-3: each block updated where it lies).
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Tuple

import numpy as np
import torch

from repro_torch.sharding import array as SA


@dataclasses.dataclass
class AdamWState:
    mu: dict
    nu: dict
    step: int


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def tree_items(tree: dict, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """(path, leaf) of a nested dict, keys in sorted order at every level."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, path + (k,))
        else:
            yield path + (k,), v


def tree_leaves(tree: dict) -> List[torch.Tensor]:
    return [v for _, v in tree_items(tree)]


def tree_map(fn, tree: dict) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def init(params: dict) -> AdamWState:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params), step=0)


def schedule(cfg: AdamWConfig, step: int) -> np.float32:
    """Linear warmup + cosine decay to min_lr_ratio, in float32."""
    f32 = np.float32
    warm = min(f32(step) / f32(max(cfg.warmup_steps, 1)), f32(1.0))
    prog = np.clip(f32(step - cfg.warmup_steps) / f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                   f32(0.0), f32(1.0))
    cos = f32(0.5) * (f32(1.0) + np.cos(f32(np.pi) * prog))
    return f32(cfg.lr) * warm * (f32(cfg.min_lr_ratio) + f32(1 - cfg.min_lr_ratio) * cos)


def global_norm(tree) -> torch.Tensor:
    """√(Σ over the leaves, in order, of each leaf's Σ g²), float32, on the
    leaves' device."""
    sq = None
    for g in tree_leaves(tree) if isinstance(tree, dict) else tree:
        s = g.to(torch.float32).square().sum()
        sq = s if sq is None else sq + s
    return torch.sqrt(sq)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled by min(1, max_norm / max(norm, 1e-9)), the norm): new
    tensors, each in its leaf's dtype."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g * scale).to(g.dtype), grads), norm


def _constants(cfg: AdamWConfig, step: int):
    """(this step's rate, the two bias corrections), float32 on the host."""
    f32 = np.float32
    return (schedule(cfg, step), float(f32(1.0) - f32(cfg.b1) ** f32(step)),
            float(f32(1.0) - f32(cfg.b2) ** f32(step)))


def _update(p, g, m, v, cfg: AdamWConfig, lr, b1c: float, b2c: float) -> None:
    """One AdamW update of a float32 tensor ``p`` and its moments, in place."""
    m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
    v.mul_(cfg.b2).add_(g.square().mul_(1 - cfg.b2))
    upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
    p.sub_(upd.add_(p * cfg.weight_decay).mul_(float(lr)))


def apply(params: dict, grads: dict, state: AdamWState, cfg: AdamWConfig):
    """One AdamW step → (params, state, {"grad_norm", "lr"}): the float32
    gradients clipped to ``cfg.grad_clip`` (in place), the moments and the
    parameters updated in place; ``grad_norm`` the norm before clipping (a
    0-dim tensor on the device), ``lr`` this step's rate (numpy float32)."""
    leaves = [g if g.dtype == torch.float32 else g.to(torch.float32) for g in tree_leaves(grads)]
    norm = global_norm(leaves)
    torch._foreach_mul_(leaves, _clip_scale(norm, cfg.grad_clip))
    step = state.step + 1
    lr, b1c, b2c = _constants(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), leaves, tree_leaves(state.mu),
                          tree_leaves(state.nu)):
        _update(p, g, m, v, cfg, lr, b1c, b2c)
    return params, AdamWState(mu=state.mu, nu=state.nu, step=step), {
        "grad_norm": norm, "lr": lr}


def apply_sharded(params: dict, grads: dict, state: AdamWState, cfg: AdamWConfig):
    """`apply` over trees of `repro_torch.sharding.array.ShardedTensor`s
    sharded alike (float32 gradients): the norm is each leaf's Σ g² summed
    over its distinct blocks (a replicated block once), then the leaves in
    `apply`'s order, on the mesh's first device; then every block, each
    replicated copy included, is clipped and updated where it lies, so the
    copies stay bit-identical."""
    gl = tree_leaves(grads)
    dev0 = gl[0].blocks[0].device
    sq = None
    for g in gl:
        s = None
        for f in SA.first_copies(g.sharding, len(g.shape)):
            b = g.blocks[f].square().sum().to(dev0)
            s = b if s is None else s + b
        sq = s if sq is None else sq + s
    norm = torch.sqrt(sq)
    scale = _clip_scale(norm, cfg.grad_clip)
    blocks = [b for g in gl for b in g.blocks]
    for dev in {b.device for b in blocks}:
        torch._foreach_mul_([b for b in blocks if b.device == dev], scale.to(dev))
    step = state.step + 1
    lr, b1c, b2c = _constants(cfg, step)
    for p, g, m, v in zip(tree_leaves(params), gl, tree_leaves(state.mu), tree_leaves(state.nu)):
        for pb, gb, mb, vb in zip(p.blocks, g.blocks, m.blocks, v.blocks):
            _update(pb, gb, mb, vb, cfg, lr, b1c, b2c)
    return params, AdamWState(mu=state.mu, nu=state.nu, step=step), {
        "grad_norm": norm, "lr": lr}
