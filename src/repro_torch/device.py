"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the CUDA card unless the caller
    names another device. With no card and no explicit device this raises
    rather than falling back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


def on(device) -> contextlib.AbstractContextManager:
    """Make ``device`` the current CUDA device inside the block, so the
    kernels launched there go to its queue (a shard of a mesh on another
    card); a no-op for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)
