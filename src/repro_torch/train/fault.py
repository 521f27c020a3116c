"""Fault-tolerance runtime pieces: straggler detection, preemption, retry.

The port of ``repro.train.fault``: host-side control code around the
training step, the same classes, defaults and arithmetic:

  * :class:`StragglerMonitor` — robust per-step timing outlier detection
    (median + MAD), with a pluggable mitigation callback; here it logs and
    counts.
  * :class:`PreemptionHandler` — SIGTERM → checkpoint at the next step
    boundary; ``restore()`` puts the previous handlers back (the port's
    `launch.train.train_loop` calls it when it returns or raises).
  * :func:`run_with_restart` — supervisor loop: restarts the train loop from
    the latest committed checkpoint after a failure, with capped exponential
    backoff.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StragglerMonitor:
    """Flags steps whose duration exceeds median + k·MAD over a window."""

    window: int = 50
    k: float = 6.0
    min_samples: int = 10
    on_straggler: Optional[Callable[[int, float, float], None]] = None
    times: List[float] = dataclasses.field(default_factory=list)
    flagged: List[int] = dataclasses.field(default_factory=list)

    def record(self, step: int, duration_s: float) -> bool:
        self.times.append(duration_s)
        if len(self.times) > self.window:
            self.times.pop(0)
        if len(self.times) < self.min_samples:
            return False
        xs = sorted(self.times)
        med = xs[len(xs) // 2]
        mad = sorted(abs(x - med) for x in xs)[len(xs) // 2]
        thresh = med + self.k * max(mad, 1e-6)
        if duration_s > thresh:
            self.flagged.append(step)
            if self.on_straggler:
                self.on_straggler(step, duration_s, thresh)
            return True
        return False


class PreemptionHandler:
    """Installs signal handlers; ``should_checkpoint`` flips on SIGTERM."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._requested = False
        self._prev = {}
        for s in signals:
            self._prev[s] = signal.signal(s, self._handler)

    def _handler(self, signum, frame):
        self._requested = True

    @property
    def should_checkpoint(self) -> bool:
        return self._requested

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


def run_with_restart(make_loop: Callable[[Optional[int]], int],
                     latest_step: Callable[[], Optional[int]],
                     max_restarts: int = 5, backoff_s: float = 1.0,
                     sleep=time.sleep) -> int:
    """Supervisor: run the loop, restart from the last checkpoint on failure.

    ``make_loop(resume_step)`` runs training and returns the final step;
    raising simulates a worker failure. Backoff doubles per restart, capped.
    """
    restarts = 0
    while True:
        try:
            return make_loop(latest_step())
        except Exception:
            restarts += 1
            if restarts > max_restarts:
                raise
            sleep(min(backoff_s * (2 ** (restarts - 1)), 60.0))
