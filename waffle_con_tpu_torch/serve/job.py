"""Job types for the multi-tenant consensus service.

The port of ``waffle_con_tpu``'s ``serve/job.py``. A :class:`JobRequest`
is one independent consensus problem (engine kind + reads + config +
scheduling attributes); submitting it yields a :class:`JobHandle`, the
client's view of the job's lifecycle. The handle doubles as the
runtime's *abort ticket*: the worker and the batching dispatcher call
:meth:`JobHandle.check_abort` at every dispatch boundary, so
cancellation and per-job deadlines take effect at the next scorer
dispatch rather than only between jobs.

Typed service errors:

* :class:`ServiceOverloaded` — bounded admission queue full; the submit
  is *rejected*, never blocked (backpressure contract).
* :class:`ServiceClosed` — submit after close, or a job orphaned by
  shutdown.
* :class:`JobCancelled` — the client called :meth:`JobHandle.cancel`.
* deadline lapses raise
  :class:`~waffle_con_tpu_torch.runtime.watchdog.DeadlineExceeded` (the
  watchdog owns wall-clock enforcement) and finalize the job as
  :attr:`JobStatus.EXPIRED`.
"""

from __future__ import annotations

import dataclasses
import enum
import threading
import time
from typing import Any, Optional, Sequence, Tuple

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.obs.trace import JOB_PID_BASE, TraceContext
from waffle_con_tpu_torch.runtime.watchdog import enforce_deadline

JOB_KINDS = ("single", "dual", "priority")


class ServeError(RuntimeError):
    """Base class for service-layer errors."""


class ServiceOverloaded(ServeError):
    """Admission queue full: the job was rejected, not enqueued."""


class ServiceClosed(ServeError):
    """The service is shut down (or shutting down)."""


class JobCancelled(ServeError):
    """The job was cancelled via :meth:`JobHandle.cancel`."""


class JobStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    DONE = "done"
    FAILED = "failed"
    CANCELLED = "cancelled"
    EXPIRED = "expired"
    #: Served from the consensus cache's exact-hit tier: the job never
    #: ran (``started_at`` stays ``None``) and no worker was touched.
    CACHED = "cached"
    #: Served from a cached near-miss consensus certified at the
    #: optimal cost by one exact scoring pass (propose-then-verify).
    CERTIFIED = "certified"


_TERMINAL = (
    JobStatus.DONE, JobStatus.FAILED, JobStatus.CANCELLED, JobStatus.EXPIRED,
    JobStatus.CACHED, JobStatus.CERTIFIED,
)


@dataclasses.dataclass(frozen=True)
class JobRequest:
    """One consensus job.

    ``reads`` is a sequence of byte strings for ``single``/``dual``
    kinds, or a sequence of chains (each a sequence of byte strings) for
    ``priority``.  ``offsets`` optionally gives per-read last-offset
    seeds (``single``/``dual`` only).  ``priority`` orders admission
    (higher first, FIFO within a class); ``deadline_s`` is a wall-clock
    budget measured from submit.
    """

    kind: str
    reads: Tuple
    config: Optional[CdwfaConfig] = None
    offsets: Optional[Tuple[Optional[int], ...]] = None
    priority: int = 0
    deadline_s: Optional[float] = None
    tag: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kind not in JOB_KINDS:
            raise ValueError(
                f"unknown job kind {self.kind!r} (known: {JOB_KINDS})"
            )
        if not self.reads:
            raise ValueError("a job needs at least one read")
        if self.kind == "priority":
            frozen = tuple(tuple(bytes(s) for s in chain)
                           for chain in self.reads)
        else:
            frozen = tuple(bytes(r) for r in self.reads)
        object.__setattr__(self, "reads", frozen)
        if self.offsets is not None:
            if self.kind == "priority":
                raise ValueError("offsets are not supported for priority "
                                 "jobs (use seeded chains instead)")
            if len(self.offsets) != len(frozen):
                raise ValueError(
                    f"offsets length {len(self.offsets)} != reads length "
                    f"{len(frozen)}"
                )
            object.__setattr__(self, "offsets", tuple(self.offsets))
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError("deadline_s must be positive")


class JobHandle:
    """Client-side handle and runtime-side abort ticket for one job."""

    def __init__(
        self, job_id: int, request: JobRequest, service: Optional[str] = None
    ) -> None:
        self.job_id = job_id
        self.request = request
        label = f"job-{job_id}"
        if request.tag:
            label += f" [{request.tag}]"
        self.trace = TraceContext(
            trace_id=f"{service or 'serve'}/job-{job_id}",
            chrome_pid=JOB_PID_BASE + job_id,
            label=label,
        )
        self._lock = lockcheck.make_lock("serve.job.JobHandle")
        self._done = threading.Event()
        self._running = threading.Event()
        self._status = JobStatus.QUEUED
        self._cancel_requested = False
        self._result: Any = None
        self._exception: Optional[BaseException] = None
        self._report = None
        self._checkpoint: Any = None
        self._checkpoint_at: Optional[float] = None
        #: optional ``fn(wire_dict)`` invoked on every attached
        #: checkpoint; exceptions are swallowed — a broken sink must
        #: never fail the search that snapshotted
        self.on_checkpoint = None
        self.submitted_at = time.monotonic()
        self.started_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.deadline: Optional[float] = (
            self.submitted_at + request.deadline_s
            if request.deadline_s is not None else None
        )

    # -- client API ----------------------------------------------------

    @property
    def status(self) -> JobStatus:
        with self._lock:
            return self._status

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def wait_running(self, timeout: Optional[float] = None) -> bool:
        """Wait until a worker has picked the job up (or it finished —
        the running event also fires on any terminal transition so a
        waiter can never hang on an already-settled job)."""
        return self._running.wait(timeout)

    def result(self, timeout: Optional[float] = None):
        """Block for the job's consensus result.

        Re-raises the job's failure (:class:`JobCancelled`,
        :class:`~waffle_con_tpu_torch.runtime.watchdog.DeadlineExceeded`, or
        whatever the engine raised); raises :class:`TimeoutError` when
        the wait times out.
        """
        if not self._done.wait(timeout):
            raise TimeoutError(
                f"job {self.job_id} not finished within {timeout}s"
            )
        with self._lock:
            if self._exception is not None:
                raise self._exception
            return self._result

    def cancel(self) -> bool:
        """Request cancellation.

        A queued job finalizes as CANCELLED immediately (the worker
        skips it at pop); a running job aborts at its next dispatch
        boundary.  Returns ``False`` when the job already reached a
        terminal state.
        """
        with self._lock:
            if self._status in _TERMINAL:
                return False
            self._cancel_requested = True
            if self._status is JobStatus.QUEUED:
                self._finalize_locked(
                    JobStatus.CANCELLED,
                    exception=JobCancelled(
                        f"job {self.job_id} cancelled while queued"
                    ),
                )
        return True

    @property
    def latency_s(self) -> Optional[float]:
        """Submit-to-finish wall clock (``None`` until terminal)."""
        with self._lock:
            if self.finished_at is None:
                return None
            return self.finished_at - self.submitted_at

    @property
    def search_report(self):
        """The engine's structured SearchReport (``None`` until DONE or
        when reporting was off for the job's config)."""
        with self._lock:
            return self._report

    @property
    def checkpoint(self):
        """Latest search checkpoint attached to this job (an opaque
        wire dict, see :mod:`waffle_con_tpu_torch.models.checkpoint`),
        or ``None`` if the search never snapshotted.  An EXPIRED job
        keeps its final checkpoint so the caller can resume it with a
        fresh deadline."""
        with self._lock:
            return self._checkpoint

    @property
    def checkpoint_at(self) -> Optional[float]:
        """``time.monotonic()`` when :attr:`checkpoint` was attached
        (``None`` alongside it)."""
        with self._lock:
            return self._checkpoint_at

    def _drop_checkpoint(self) -> None:
        """Forget the attached checkpoint (restart-from-scratch paths:
        a stale resume point must not ride into the next dispatch)."""
        with self._lock:
            self._checkpoint = None
            self._checkpoint_at = None

    def _attach_checkpoint(self, data: Any) -> None:
        """Attach or replace the job's latest checkpoint (the service's
        snapshot hook)."""
        if data is None:
            return
        with self._lock:
            self._checkpoint = data
            self._checkpoint_at = time.monotonic()
            callback = self.on_checkpoint
        if callback is not None:
            try:
                callback(data)
            except Exception:  # noqa: BLE001 - sink must never fail a job
                pass

    # -- runtime (ticket) API ------------------------------------------

    def check_abort(self, op: str = "") -> None:
        """Raise when the job must stop: cancellation first, then the
        per-job deadline.  Called by the worker at pop and by the
        dispatcher before every routed scorer dispatch."""
        with self._lock:
            cancelled = self._cancel_requested
        if cancelled:
            raise JobCancelled(
                f"job {self.job_id} cancelled"
                + (f" (at dispatch {op})" if op else "")
            )
        enforce_deadline(self.deadline, label=f"job {self.job_id}")

    def _mark_running(self) -> bool:
        """Worker picked the job up.  Returns ``False`` when the job is
        already terminal (cancelled while queued) — the worker must skip
        it without touching an engine."""
        with self._lock:
            if self._status is not JobStatus.QUEUED:
                return False
            self._status = JobStatus.RUNNING
            self.started_at = time.monotonic()
        self._running.set()
        return True

    def _finish(
        self,
        status: JobStatus,
        result: Any = None,
        exception: Optional[BaseException] = None,
        report=None,
    ) -> None:
        with self._lock:
            if self._status in _TERMINAL:
                return
            self._result = result
            self._report = report
            self._finalize_locked(status, exception=exception)

    def _finalize_locked(
        self, status: JobStatus, exception: Optional[BaseException]
    ) -> None:
        self._status = status
        self._exception = exception
        self.finished_at = time.monotonic()
        self._running.set()
        self._done.set()

    def __repr__(self) -> str:
        return (
            f"JobHandle(id={self.job_id}, kind={self.request.kind!r}, "
            f"status={self.status.value})"
        )


def validate_requests(requests: Sequence[JobRequest]) -> None:
    """Fail fast on a batch submit with a non-JobRequest element."""
    for r in requests:
        if not isinstance(r, JobRequest):
            raise TypeError(f"expected JobRequest, got {type(r).__name__}")
