"""Gradient compression with error feedback for slow links.

The port of ``repro.train.compression``: int8 deterministic quantisation
with per-tensor scales and local error-feedback accumulators (Seide et al.
/ 1-bit-Adam lineage):

    q = round(g / s),  s = max|g| / 127        (int8 payload)
    e' = g - q·s                               (residual kept locally)
    next step: g ← g + e'                      (error feedback)

The reference's ``compressed_psum`` runs inside ``shard_map`` over a named
mesh axis. Here a mesh is a sequence of devices (`launch.mesh`) driven by
one process, so `compressed_psum` takes one gradient and one error tensor
for each shard, in mesh order, each on its shard's device, and returns one
mean and one new error for each: the shared scale is the maximum of the
shards' (the pmax, a scalar per shard), the int8 payloads are summed in
int32 (the psum), and every shard gets the sum back on its device.
Nothing in either package's train step calls it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from repro_torch.train import optimizer as OPT
from repro_torch.train.train_step import _nest


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-d): scale = max(max|g| / 127, 1e-30), q =
    clip(round(g / scale), −127, 127), rounding half to even."""
    scale = torch.clamp(g.abs().max() / 127.0, min=1e-30)
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_with_feedback(g: torch.Tensor, err: torch.Tensor):
    """(g, err) → (q, scale, new_err). The residual stays on this worker."""
    g = g.to(torch.float32) + err
    q, scale = quantize_int8(g)
    new_err = g - dequantize_int8(q, scale)
    return q, scale, new_err


def compressed_psum(grads: Sequence[torch.Tensor], errs: Sequence[torch.Tensor]
                    ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Error-feedback int8 mean over the shards of a mesh: ``grads[d]``
    and ``errs[d]`` on shard ``d``'s device → (the mean on each shard, each
    shard's new error).

    The scale is shared (the shards' maximum), so dequantising the integer
    sum is exact with respect to each shard's quantised payload.
    """
    if len(grads) != len(errs) or not grads:
        raise ValueError(f"{len(grads)} gradients and {len(errs)} errors: one each a shard")
    gs = [g.to(torch.float32) + e for g, e in zip(grads, errs)]
    home = gs[0].device
    scale = torch.stack([(g.abs().max() / 127.0).to(home) for g in gs]).max()
    scale = torch.clamp(scale, min=1e-30)
    qs, new_errs = [], []
    for g in gs:
        s = scale.to(g.device)
        q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int32)
        new_errs.append(g - q.to(torch.float32) * s)
        qs.append(q)
    total = qs[0].clone()
    for q in qs[1:]:
        total += q.to(home)
    mean = total.to(torch.float32) * scale / float(len(gs))
    return [mean.to(g.device) for g in gs], new_errs


def tree_compressed_psum(grads: Sequence[dict], err_trees: Sequence[dict]):
    """`compressed_psum` leaf by leaf over one gradient tree and one error
    tree a shard (nested dicts, leaves in sorted-key order) → (the mean
    trees, the new error trees), one of each a shard."""
    paths = [p for p, _ in OPT.tree_items(grads[0])]
    flat_g = [OPT.tree_leaves(t) for t in grads]
    flat_e = [OPT.tree_leaves(t) for t in err_trees]
    outs = [compressed_psum([g[i] for g in flat_g], [e[i] for e in flat_e])
            for i in range(len(paths))]
    per_shard = lambda j, d: _nest(zip(paths, [o[j][d] for o in outs]))
    return ([per_shard(0, d) for d in range(len(grads))],
            [per_shard(1, d) for d in range(len(grads))])


def init_error_feedback(params: dict) -> dict:
    """A float32 zero tensor beside each parameter."""
    return OPT.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
