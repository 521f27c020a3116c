"""Asynchronous, deadline-aware serving over a `Server` (DESIGN.md §9).

`AsyncScheduler` turns the synchronous `repro_torch.engine.serve.Server`
into an open-loop system: callers `submit()` query-sketch batches and get
a `QueryTicket` (a future) back at once; a pool of worker threads drains
an admission queue into `Server.query_batch` calls.

  * **continuous batching** — queued tickets whose requests are compatible
    (`repro_torch.engine.plans.coalesce_key`: same estimator, scorer,
    prune mode, α and floor; ``k`` is a host-side slice) go out as one
    dispatch, which the server covers with its measured-cost bucket
    ladder. Dispatch is work-conserving: whatever queued while the workers
    were busy is the next batch, so batching appears exactly under load.
  * **deadline pressure** — admission is earliest-deadline-first across
    coalesce groups, and a group shrinks until its estimated cost (the
    server's bucket cover over its measured bucket costs) fits the oldest
    member's slack. A group whose head already missed ships at full width:
    it is late anyway, so clearing backlog at the lowest per-query cost
    maximises goodput.
  * **snapshot isolation** — a `Server.query_batch` reads one published
    segment map, so `append`/`delete`/`compact` and `refresh()` of a live
    index never race a dispatch.

With ``workers=1`` every ticket's result equals calling `Server.query_batch`
directly: a coalesced dispatch is a bigger batch, and each query row is
computed on its own.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.sketch import CorrelationSketch
from repro_torch.engine import plans as PL


class QueryTicket:
    """A submitted query batch: its completion future and timings.

    ``result()`` blocks until a worker has served the ticket and returns
    the ``(scores, ids, r, m)`` numpy tuple (rows: this ticket's queries;
    width: its request's k), re-raising any worker-side exception. Times
    are monotonic-clock seconds; ``latency_s`` and ``missed_deadline``
    are set on completion.
    """

    __slots__ = ("sketches", "request", "nq", "seq", "t_submit", "deadline",
                 "t_done", "_event", "_result", "_error")

    def __init__(self, sketches, request: PL.Request, nq: int, seq: int,
                 t_submit: float, deadline: Optional[float]):
        self.sketches = sketches
        self.request = request
        self.nq = nq
        self.seq = seq
        self.t_submit = t_submit
        self.deadline = deadline
        self.t_done: Optional[float] = None
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError("query ticket not served within timeout")
        if self._error is not None:
            raise self._error
        return self._result

    @property
    def latency_s(self) -> float:
        """Submit → completion seconds, the queue wait included."""
        if self.t_done is None:
            raise RuntimeError("ticket not completed")
        return self.t_done - self.t_submit

    @property
    def missed_deadline(self) -> bool:
        return (self.deadline is not None and self.t_done is not None
                and self.t_done > self.deadline)

    # -- worker side ---------------------------------------------------------
    def _finish(self, result, t_done: float) -> None:
        self.sketches = None          # free the query payload at once
        self._result = result
        self.t_done = t_done
        self._event.set()

    def _fail(self, err: BaseException, t_done: float) -> None:
        self.sketches = None
        self._error = err
        self.t_done = t_done
        self._event.set()


def _merge_sketches(tickets: List[QueryTicket]) -> CorrelationSketch:
    """The tickets' query sketches concatenated along the leading [NQ]
    axis, field by field."""
    if len(tickets) == 1:
        return tickets[0].sketches
    sks = [t.sketches for t in tickets]
    return CorrelationSketch(
        **{f.name: torch.cat([getattr(s, f.name) for s in sks])
           for f in dataclasses.fields(CorrelationSketch) if f.name != "agg"},
        agg=sks[0].agg)


class AsyncScheduler:
    """Admission queue and worker pool over a warmed `Server` (DESIGN.md §9).

    ``workers`` threads drain the queue; each admission takes the
    earliest-deadline coalesce group, sizes it against the measured-cost
    bucket ladder under the head's slack, merges the sketches and serves
    one `Server.query_batch` (with ``refresh``). ``slo_ms`` is the default
    deadline budget of a submit (a per-submit value wins); ``None`` means
    no deadlines. ``max_coalesce`` bounds one dispatch group in queries
    (default: the server's largest bucket). ``max_queue`` (queries) makes
    `submit` raise while the backlog is full; ``None`` queues without
    bound. The workers run on the server's device.

    Attaches itself to the server: `Server.throughput()` then reports
    ``queue_depth`` and ``deadline_misses``. Use as a context manager or
    call `close()` (drains the queue, then joins the workers).
    """

    def __init__(self, server, *, workers: int = 2,
                 slo_ms: Optional[float] = None,
                 max_coalesce: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 refresh: bool = True):
        if workers < 1:
            raise ValueError(f"workers must be at least 1, not {workers}")
        self.server = server
        self.refresh = refresh
        self.slo_s = None if slo_ms is None else float(slo_ms) / 1e3
        self.max_coalesce = int(max_coalesce if max_coalesce is not None
                                else max(server.buckets))
        if self.max_coalesce < 1:
            raise ValueError(f"max_coalesce must be at least 1, not "
                             f"{self.max_coalesce}")
        self.max_queue = max_queue
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        #: coalesce_key → FIFO of waiting tickets (EDF picks across keys)
        self._pending: Dict[tuple, Deque[QueryTicket]] = {}
        self._pending_n = 0          # queued queries (not tickets)
        self._seq = 0
        self._closed = False
        # counters, under _lock
        self._submitted = 0          # queries accepted
        self._completed = 0          # queries served (errors excluded)
        self._errors = 0             # tickets failed
        self._batches = 0            # dispatch groups taken
        self._deadline_misses = 0    # queries completed past their deadline
        self._flush_deadline = 0     # groups shrunk by deadline pressure
        self._flush_full = 0         # groups capped at max_coalesce
        self._flush_drain = 0        # groups that took their whole queue
        self._workers = [
            threading.Thread(target=self._worker_loop, daemon=True,
                             name=f"corrsketch-serve-{i}")
            for i in range(workers)]
        server._scheduler = self
        for t in self._workers:
            t.start()

    # -- submission ----------------------------------------------------------
    def submit(self, sketches: CorrelationSketch, *,
               request: Optional[PL.Request] = None,
               slo_ms: Optional[float] = None,
               deadline_s: Optional[float] = None) -> QueryTicket:
        """Enqueue query sketches (leading [NQ] axis) and return their
        `QueryTicket`. ``deadline_s`` is an absolute monotonic-clock
        deadline, ``slo_ms`` a budget from now; with neither, the
        scheduler's default SLO applies. An invalid request (unknown
        estimator, scorer or prune mode; k above k_max) raises here."""
        req = request if request is not None else self.server.request
        key = PL.coalesce_key(req)          # validates the request
        if req.k > self.server.shape.k_max:
            raise ValueError(
                f"request k={req.k} exceeds ShapePolicy.k_max="
                f"{self.server.shape.k_max}; raise k_max or lower k")
        nq = int(sketches.key_hash.shape[0])
        now = time.monotonic()
        if deadline_s is None:
            slo = self.slo_s if slo_ms is None else float(slo_ms) / 1e3
            deadline_s = None if slo is None else now + slo
        with self._work:
            if self._closed:
                raise RuntimeError("scheduler is closed")
            if (self.max_queue is not None
                    and self._pending_n + nq > self.max_queue):
                raise RuntimeError(
                    f"admission queue full ({self._pending_n} queries "
                    f"queued, max_queue={self.max_queue})")
            t = QueryTicket(sketches, req, nq, self._seq, now, deadline_s)
            self._seq += 1
            self._pending.setdefault(key, deque()).append(t)
            self._pending_n += nq
            self._submitted += nq
            self._work.notify()
        return t

    def query(self, sketches: CorrelationSketch, *,
              request: Optional[PL.Request] = None,
              slo_ms: Optional[float] = None,
              timeout: Optional[float] = None):
        """Submit and wait for the result."""
        return self.submit(sketches, request=request,
                           slo_ms=slo_ms).result(timeout)

    # -- admission -----------------------------------------------------------
    @staticmethod
    def _urgency(t: QueryTicket) -> tuple:
        """EDF order: deadline first (∞ when absent), then arrival."""
        return (t.deadline if t.deadline is not None else math.inf,
                t.t_submit, t.seq)

    def _est_cost_s(self, nq: int) -> float:
        """Estimated seconds to serve ``nq`` coalesced queries: the
        server's bucket cover (`plan_batches`) priced with the executors'
        measured bucket costs, times the segment count. Zero before
        warmup (nothing measured yet)."""
        view = self.server._view
        if not view:
            return 0.0
        ex = view[0].exec
        costs = ex._bucket_cost
        if not costs:
            return 0.0
        worst = max(costs.values())
        est = sum(costs.get(b, worst) for b in ex.plan_batches(nq))
        return est * len(view)

    def _take_locked(self, now: float) -> Tuple[List[QueryTicket], int]:
        """Pop the next dispatch group (under ``_lock``): from the
        earliest-deadline coalesce queue, its FIFO prefix up to
        ``max_coalesce`` queries, shrunk until the estimated cost fits the
        head's slack — unless the head already missed its deadline, when
        the full width ships."""
        key = min(self._pending,
                  key=lambda k: self._urgency(self._pending[k][0]))
        q = self._pending[key]
        group: List[QueryTicket] = [q[0]]
        total = q[0].nq
        for t in list(q)[1:]:
            if total + t.nq > self.max_coalesce:
                break
            group.append(t)
            total += t.nq
        capped = len(group) < len(q)
        head = group[0]
        shrunk = False
        if head.deadline is not None:
            slack = head.deadline - now
            if slack > 0:
                while len(group) > 1 and self._est_cost_s(total) > slack:
                    total -= group.pop().nq
                    shrunk = True
        for _ in group:
            q.popleft()
        if not q:
            del self._pending[key]
        self._pending_n -= total
        self._batches += 1
        if shrunk:
            self._flush_deadline += 1
        elif capped:
            self._flush_full += 1
        else:
            self._flush_drain += 1
        return group, total

    # -- worker pool ---------------------------------------------------------
    def _worker_loop(self) -> None:
        dev = self.server.device
        on_card = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            while True:
                with self._work:
                    while not self._pending and not self._closed:
                        self._work.wait()
                    if not self._pending:     # closed and drained
                        return
                    group, _ = self._take_locked(time.monotonic())
                self._execute(group)

    def _execute(self, group: List[QueryTicket]) -> None:
        try:
            k_rep = max(t.request.k for t in group)
            rep = dataclasses.replace(group[0].request, k=k_rep)
            out = self.server.query_batch(_merge_sketches(group),
                                          request=rep, refresh=self.refresh)
            now = time.monotonic()
            misses = served = 0
            s = 0
            for t in group:
                t._finish(tuple(np.array(a[s:s + t.nq, :t.request.k])
                                for a in out), now)
                s += t.nq
                served += t.nq
                if t.missed_deadline:
                    misses += t.nq
            with self._lock:
                self._completed += served
                self._deadline_misses += misses
        except BaseException as err:
            now = time.monotonic()
            failed = [t for t in group if not t.done()]
            for t in failed:
                t._fail(err, now)
            with self._lock:
                self._errors += len(failed)
            if not isinstance(err, Exception):
                raise

    # -- lifecycle and telemetry ---------------------------------------------
    def close(self) -> None:
        """Stop accepting work, drain the queue, join the workers."""
        with self._work:
            if self._closed:
                return
            self._closed = True
            self._work.notify_all()
        for t in self._workers:
            t.join()

    def __enter__(self) -> "AsyncScheduler":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def queue_stats(self) -> dict:
        """The admission counters `Server.throughput()` merges in."""
        with self._lock:
            return dict(queue_depth=self._pending_n,
                        deadline_misses=self._deadline_misses)

    def stats(self) -> dict:
        """All scheduler counters, read under one lock."""
        with self._lock:
            return dict(
                workers=len(self._workers),
                queue_depth=self._pending_n,
                submitted=self._submitted,
                completed=self._completed,
                errors=self._errors,
                batches=self._batches,
                avg_coalesce=self._completed / max(self._batches, 1),
                deadline_misses=self._deadline_misses,
                flush_deadline=self._flush_deadline,
                flush_full=self._flush_full,
                flush_drain=self._flush_drain)
