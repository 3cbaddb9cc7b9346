"""Admission control and worker pool for the consensus service.

The port of ``waffle_con_tpu``'s ``serve/scheduler.py``.
:class:`AdmissionQueue` is a *bounded* priority queue: higher
``JobRequest.priority`` pops first, FIFO within a priority class (a
monotonically increasing sequence number breaks ties, and makes heap
entries totally ordered without ever comparing handles).  A full queue
**rejects** with :class:`~waffle_con_tpu_torch.serve.job.ServiceOverloaded`
instead of blocking the submitter — under overload the caller must get
a fast typed answer it can retry/shed on, not a stalled thread.

Strict priority starves: a saturating high class would hold a queued
low-priority job forever.  ``aging_s`` bounds that wait — when the
OLDEST queued job has waited longer than the aging window it pops
next regardless of class.  Within the window ordering is exactly the
strict heap order, so latency-sensitive traffic keeps its edge and
the aged pop only fires under sustained cross-class pressure.

:class:`WorkerPool` is a fixed set of daemon threads draining the queue
through a job-runner callable supplied by the service.  Workers are
deliberately dumb: all lifecycle logic (skip-if-cancelled, deadline at
pop, engine construction, finalization) lives in
``ConsensusService._run_job``.
"""

from __future__ import annotations

import heapq
import threading
import time
from typing import Callable, List, Optional

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.serve.job import (
    JobHandle,
    ServiceClosed,
    ServiceOverloaded,
)


class AdmissionQueue:
    """Bounded priority queue with reject-on-full backpressure."""

    def __init__(self, limit: int, name: str = "consensus",
                 aging_s: Optional[float] = None,
                 clock: Optional[Callable[[], float]] = None) -> None:
        if limit < 1:
            raise ValueError("queue limit must be >= 1")
        if aging_s is not None and aging_s <= 0:
            raise ValueError("aging_s must be > 0 (or None to disable)")
        self.limit = limit
        self.aging_s = aging_s
        self._clock = clock or time.monotonic
        self._name = name
        self._cond = threading.Condition()
        self._heap: List[tuple] = []
        self._seq = 0
        self._closed = False
        self._aged_pops = 0

    def _set_depth_gauge(self, depth: int) -> None:
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().gauge(
                "waffle_serve_queue_depth", service=self._name
            ).set(depth)

    def put(self, handle: JobHandle) -> None:
        """Enqueue or raise — never blocks on a full queue."""
        with self._cond:
            if self._closed:
                raise ServiceClosed("service is closed to new jobs")
            if len(self._heap) >= self.limit:
                if obs_metrics.metrics_enabled():
                    obs_metrics.registry().counter(
                        "waffle_serve_admission_rejections_total",
                        service=self._name,
                    ).inc()
                raise ServiceOverloaded(
                    f"admission queue full ({self.limit} jobs queued); "
                    "retry later or shed load"
                )
            heapq.heappush(
                self._heap,
                (-handle.request.priority, self._seq, self._clock(),
                 handle),
            )
            self._seq += 1
            depth = len(self._heap)
            self._cond.notify()
        self._set_depth_gauge(depth)

    def _pop_entry(self) -> tuple:
        """Heap pop with anti-starvation aging: when the oldest queued
        entry (minimum sequence number — sequence is global arrival
        order) has waited past ``aging_s``, it pops instead of the
        strict-priority head.  O(n) scan + heapify, but n is bounded by
        the admission ``limit`` and the path only triggers on an aged
        entry."""
        if self.aging_s is not None and len(self._heap) > 1:
            idx = min(range(len(self._heap)),
                      key=lambda i: self._heap[i][1])
            entry = self._heap[idx]
            if (self._clock() - entry[2] >= self.aging_s
                    and entry[1] != self._heap[0][1]):
                self._heap[idx] = self._heap[-1]
                self._heap.pop()
                heapq.heapify(self._heap)
                self._aged_pops += 1
                if obs_metrics.metrics_enabled():
                    obs_metrics.registry().counter(
                        "waffle_serve_aged_pops_total",
                        service=self._name,
                    ).inc()
                return entry
        return heapq.heappop(self._heap)

    def get(self, timeout: Optional[float] = None) -> Optional[JobHandle]:
        """Pop the best job, or ``None`` on timeout / closed-and-empty."""
        with self._cond:
            while not self._heap:
                if self._closed:
                    return None
                if not self._cond.wait(timeout):
                    return None
            handle = self._pop_entry()[-1]
            depth = len(self._heap)
        self._set_depth_gauge(depth)
        return handle

    def drain(self) -> List[JobHandle]:
        """Remove and return every queued job (shutdown path)."""
        with self._cond:
            handles = [entry[-1] for entry in self._heap]
            self._heap.clear()
        self._set_depth_gauge(0)
        return handles

    def depth(self) -> int:
        with self._cond:
            return len(self._heap)

    @property
    def aged_pops(self) -> int:
        with self._cond:
            return self._aged_pops

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class WorkerPool:
    """Fixed pool of daemon threads feeding jobs to ``run_job``."""

    def __init__(
        self,
        workers: int,
        queue: AdmissionQueue,
        run_job: Callable[[JobHandle], None],
        name: str = "consensus",
    ) -> None:
        if workers < 1:
            raise ValueError("need at least one worker")
        self._queue = queue
        self._run_job = run_job
        self._name = name
        self._stop = threading.Event()
        self._threads = [
            lockcheck.make_thread(
                target=self._loop,
                name=f"waffle-serve-{name}-w{i}",
                daemon=True,
            )
            for i in range(workers)
        ]
        self._started = False

    def start(self) -> None:
        if self._started:
            return
        self._started = True
        for t in self._threads:
            t.start()

    @property
    def started(self) -> bool:
        return self._started

    def _loop(self) -> None:
        while not self._stop.is_set():
            handle = self._queue.get(timeout=0.05)
            if handle is None:
                continue
            self._run_job(handle)

    def stop(self, wait: bool = True) -> None:
        self._stop.set()
        self._queue.close()
        if wait and self._started:
            for t in self._threads:
                t.join()
