"""Training driver: checkpointed, preemption-safe, straggler-monitored.

The port of ``repro.launch.train``:

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --smoke --steps 20 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt [--device cpu]

``--smoke`` selects the reduced config; without it the full config trains
(tinyllama-1.1b fits one H100). It runs on the CUDA card unless
``--device`` names another device. The loop resumes from the newest
committed checkpoint, checkpoints every ``--ckpt-every`` steps, at the last
step and on SIGTERM (then it stops), times each step for the straggler
monitor, and draws each step's batch from ``(seed, step)`` alone, so a
restart is bit-exact. With ``--fail-at-step`` and ``--ckpt-dir``,
`fault.run_with_restart` supervises the loop and restarts it from the
newest checkpoint after the injected failure. Unlike the reference's loop,
this one puts the previous SIGTERM handler back when it returns or raises.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional, Tuple

from repro_torch import device as D
from repro_torch.configs import registry
from repro_torch.data.pipeline import lm_batch
from repro_torch.train import checkpoint as CK
from repro_torch.train import fault as F
from repro_torch.train import train_step as TS


def train_loop(arch: str, *, smoke: bool, steps: int, batch: int, seq: int,
               ckpt_dir: Optional[str], ckpt_every: int = 50, microbatches: int = 1,
               resume: bool = True, seed: int = 0, log_every: int = 10,
               fail_at_step: Optional[int] = None, device: D.DeviceLike = None
               ) -> Tuple[TS.TrainState, List[float]]:
    """Train ``arch`` from step 0, or from the newest committed checkpoint
    in ``ckpt_dir`` when ``resume``, up to ``steps`` → (the final state, the
    losses of the steps this call ran). ``fail_at_step`` raises
    `RuntimeError` after that step, before its checkpoint. A
    `fault.StragglerMonitor` records each step's host seconds, taken once
    the loss is read. Runs on ``device`` (the CUDA card unless named)."""
    dev = D.resolve(device)
    cfg = registry.get_smoke_config(arch) if smoke else registry.get_config(arch)
    tcfg = TS.TrainConfig(microbatches=microbatches)
    step_fn = TS.make_train_step(cfg, tcfg)

    start = 0
    state = None
    if ckpt_dir and resume:
        latest = CK.latest_step(ckpt_dir)
        if latest is not None:
            state = CK.restore(ckpt_dir, latest, TS.abstract_state(cfg), device=dev)
            start = latest
            print(f"resumed from step {latest}", flush=True)
    if state is None:
        state = TS.init_state(cfg, seed, device=dev)

    monitor = F.StragglerMonitor()
    preempt = F.PreemptionHandler()
    losses = []
    try:
        for step in range(start, steps):
            bd = lm_batch(cfg, batch, seq, seed=seed, step=step, microbatches=microbatches)
            t0 = time.time()
            state, metrics = step_fn(state, bd)
            loss = float(metrics["loss"])
            losses.append(loss)
            monitor.record(step, time.time() - t0)
            if step % log_every == 0 or step == steps - 1:
                print(f"step {step:5d} loss {loss:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} dt {time.time()-t0:.2f}s", flush=True)
            if fail_at_step is not None and step == fail_at_step:
                raise RuntimeError(f"injected failure at step {step}")
            if ckpt_dir and ((step + 1) % ckpt_every == 0 or step == steps - 1
                             or preempt.should_checkpoint):
                CK.save(ckpt_dir, step + 1, state)
                if preempt.should_checkpoint:
                    print("preemption requested — checkpointed and exiting", flush=True)
                    break
    finally:
        preempt.restore()
    return state, losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fail-at-step", type=int, default=None,
                    help="inject a failure (tests the supervisor restart path)")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    def make_loop(resume_step):
        train_loop(
            args.arch, smoke=args.smoke, steps=args.steps, batch=args.batch,
            seq=args.seq, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            microbatches=args.microbatches, seed=args.seed,
            fail_at_step=args.fail_at_step if (resume_step or 0) == 0 else None,
            device=args.device)
        return args.steps

    if args.ckpt_dir and args.fail_at_step is not None:
        F.run_with_restart(make_loop, lambda: CK.latest_step(args.ckpt_dir),
                           max_restarts=args.max_restarts, backoff_s=0.1)
    else:
        make_loop(None)


if __name__ == "__main__":
    main()
