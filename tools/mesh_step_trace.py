#!/usr/bin/env python3
"""Where the card waits in a training step: tinyllama-1.1b at full width
and depth, the memorisable 4 × 2048 batch in 2 microbatches (chip_smoke's
``train`` and ``train_mesh`` inputs), through the one-device step and
through the step sharded over a 2 × 2 ("data", "model") mesh of the card.

For each side it times warm steps by CUDA events and by the host clock up
to the step's return (the launches issued, before a synchronise), then
takes one step under ``torch.profiler``: the CUDA kernels it launched, the
union of their device intervals (busy ms) and the span from the first
kernel's start to the last one's end; span − busy is the time the card
sat idle between kernels inside the step. The sides run in the order one
device, mesh, mesh, one device.

Run from the repository root on a CUDA card:
``python3 tools/mesh_step_trace.py``. It prints one ``trace <i> <side>
{json}`` line a run, then the card's name and power limit.
"""
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.sharding import array as SA  # noqa: E402
from repro_torch.train import optimizer as OPT  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402

WARM, TIMED = 2, 3


def _busy_and_span(prof):
    """(kernels, busy ms, span ms) of the CUDA kernels a profile holds."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a >= end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return len(spans), busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3


def run(side: str, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile
    cfg = C.TRAIN_CONFIG
    tcfg = TS.TrainConfig(microbatches=C.TRAIN_MB, opt=OPT.AdamWConfig(**C.TRAIN_OPT))
    batch = C._memorisable_batch(C.TRAIN_BATCH, C.TRAIN_SEQ, C.TRAIN_MB, dev)
    state = TS.init_state(cfg, C.SEED, device=dev)
    if side == "mesh":
        mesh = make_mesh(C.MESH_SHAPE, C.MESH_AXES)
        state = SA.device_put(state, TS.state_shardings(cfg, mesh))
        torch.cuda.empty_cache()
        step = TS.make_train_step(cfg, tcfg, mesh=mesh)
    else:
        step = TS.make_train_step(cfg, tcfg)
    for _ in range(WARM):
        state, _ = step(state, batch)
    torch.cuda.synchronize()
    host, events = [], []
    for _ in range(TIMED):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        state, _ = step(state, batch)
        e1.record()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
        events.append(e0.elapsed_time(e1))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    kernels, busy, span = _busy_and_span(prof)
    del state, step
    torch.cuda.empty_cache()
    return dict(step_ms=events, host_issue_ms=host, kernels=kernels, busy_ms=busy,
                span_ms=span, idle_ms=span - busy, idle_share=(span - busy) / span)


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    dev = torch.device("cuda")
    for i, side in enumerate(("one device", "mesh", "mesh", "one device"), 1):
        print(f"trace {i} {side.replace(' ', '_')} " + json.dumps(run(side, dev)), flush=True)
    print(C._card(), flush=True)


if __name__ == "__main__":
    main()
