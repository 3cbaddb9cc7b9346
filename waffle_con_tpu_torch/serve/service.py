"""The multi-tenant consensus service.

The port of ``waffle_con_tpu``'s ``serve/service.py``, in process.
:class:`ConsensusService` accepts independent consensus jobs
(:class:`~waffle_con_tpu_torch.serve.job.JobRequest`), admits them
through a bounded priority queue (reject-on-full backpressure), runs them
on a worker pool, and coalesces the concurrent jobs' scorer calls via
the shared :class:`~waffle_con_tpu_torch.serve.dispatcher.BatchingDispatcher`,
whose ragged pass gangs their ``run_extend`` calls across jobs through
the serving pool (:mod:`waffle_con_tpu_torch.ops.ragged`).

The engines are untouched: each worker installs a thread-local scorer
decorator (``ops.scorer.set_scorer_decorator``) for the duration of its
job, so every scorer the engine builds — supervised or not — is wrapped
in a :class:`~waffle_con_tpu_torch.serve.dispatcher.CoalescingScorer`
routing calls into the shared dispatcher with the job's handle as abort
ticket.  A job whose config asks for supervision (``supervised`` /
``backend_chain``) gets its supervisor *inside* the coalescing proxy, so
retries, demotions and the circuit breaker all happen within one routed
call.

Lifecycle: ``submit`` -> QUEUED -> (worker pop, deadline/cancel check) ->
RUNNING -> DONE / FAILED / CANCELLED / EXPIRED.  ``close()`` drains
gracefully by default (runs everything already admitted) or sheds the
queue with ``cancel_pending=True``.

The JAX package's environment knobs are fields of :class:`ServeConfig`
here (the port reads no environment variable): the pool's switches and
geometry (``WAFFLE_RAGGED*``), ``checkpoint_interval_s``
(``WAFFLE_CKPT_INTERVAL_S``), ``checkpoint_max_bytes``
(``WAFFLE_CKPT_MAX_BYTES``), ``stats_file`` (``WAFFLE_STATS_FILE``) and
``flight_dir`` (``WAFFLE_FLIGHT_DIR``), and the consensus cache's
``cache`` (``WAFFLE_CACHE``), ``cache_max_results`` (``WAFFLE_CACHE_MAX``),
``cache_max_checkpoints`` (``WAFFLE_CACHE_CKPTS``), ``cache_proposals``
(``WAFFLE_CACHE_PROPOSALS``) and ``cache_dir`` (``WAFFLE_CACHE_DIR``).

Placement (:mod:`waffle_con_tpu_torch.serve.placement`): with
``ServeConfig.placement`` set, :meth:`ConsensusService.submit` rewrites a
large ``"torch"`` job's config with ``mesh_shards`` at admission; the job
then builds a read-sharded store on the service's ``device_set`` (pinned
on the worker thread around the whole job body) instead of joining the
serving pool.  A job counts as finished only once its pool pages are back
and the dispatcher has let it go, so ``stats()`` read right after the
last ``result()`` shows every admission released.

The consensus cache (:mod:`waffle_con_tpu_torch.serve.cache`, on with
``ServeConfig.cache``) sits between admission and dispatch: an exact or
certified hit finishes the handle in :meth:`ConsensusService.submit`
(``CACHED`` / ``CERTIFIED``, never queued, no kernel of a search
launched), a checkpoint hit attaches a cached bound-free snapshot that
the job resumes with its extra reads.  Out-of-process workers are not
ported yet.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import time
from typing import Dict, List, Optional, Sequence

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import audit as obs_audit
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import phases as obs_phases
from waffle_con_tpu_torch.obs import slo as obs_slo
from waffle_con_tpu_torch.obs import trace as obs_trace
from waffle_con_tpu_torch.ops import ragged as ops_ragged
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.runtime.watchdog import DeadlineExceeded
from waffle_con_tpu_torch.serve.dispatcher import (
    BatchingDispatcher,
    CoalescingScorer,
)
from waffle_con_tpu_torch.serve.job import (
    JobCancelled,
    JobHandle,
    JobRequest,
    JobStatus,
    ServiceClosed,
    ServiceOverloaded,
)
from waffle_con_tpu_torch.serve import cache as serve_cache
from waffle_con_tpu_torch.serve import placement as serve_placement
from waffle_con_tpu_torch.serve.procs import wire
from waffle_con_tpu_torch.serve.scheduler import AdmissionQueue, WorkerPool


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Service knobs.

    * ``workers`` — concurrent jobs in flight (also the natural upper
      bound on batch occupancy).
    * ``queue_limit`` — bounded admission queue; the (queue_limit+1)-th
      concurrent submit gets :class:`ServiceOverloaded`.
    * ``batch_window_s`` — how long the first call of a batch waits for
      concurrent company before executing (0 disables coalescing).
    * ``max_batch`` — batch-size wait target for the window.
    * ``adaptive_window`` — arrival-rate-predictive hold inside the
      window cap (see :class:`BatchingDispatcher`); off = fixed window.
    * ``aging_s`` — admission anti-starvation: the oldest queued job
      pops regardless of priority class after waiting this long
      (``None`` = strict priority).
    * ``placement`` — an optional
      :class:`~waffle_con_tpu_torch.serve.placement.PlacementPolicy`
      routing large admitted jobs to a read-sharded store.
    * ``ragged`` … ``ragged_gang`` — the serving pool
      (:class:`~waffle_con_tpu_torch.ops.ragged.ArenaConfig`): the
      ragged pass on or off, mixed band widths in one group, pool rows,
      rows a page, band half-width, longest read, consensus capacity and
      members a group.
    * ``checkpoint_interval_s`` / ``checkpoint_max_bytes`` — each job's
      periodic snapshot cadence and size cap.
    * ``stats_file`` — when set, the live stats are rewritten there
      (atomically, at most every 0.25 s) as jobs finish.
    * ``flight_dir`` — when set, the flight recorder also writes each
      incident there (otherwise incidents stay in memory).
    * ``cache`` … ``cache_dir`` — the consensus cache
      (:class:`~waffle_con_tpu_torch.serve.cache.ConsensusCache`): on or
      off (off by default), results and checkpoints kept (LRU), the
      proposal-certify tier on or off, and an optional directory of
      hash-sealed result files that outlives the service.
    """

    workers: int = 4
    queue_limit: int = 64
    batch_window_s: float = 0.002
    max_batch: int = 8
    name: str = "consensus"
    adaptive_window: bool = True
    aging_s: Optional[float] = 0.5
    placement: Optional[object] = None
    ragged: bool = True
    ragged_mixed_w: bool = True
    ragged_rows: int = 256
    ragged_page: int = 8
    ragged_e: int = 32
    ragged_l: int = 512
    ragged_c: int = 2048
    ragged_gang: int = 8
    checkpoint_interval_s: float = 30.0
    checkpoint_max_bytes: int = 8 * 1024 * 1024
    stats_file: Optional[str] = None
    flight_dir: Optional[str] = None
    cache: bool = False
    cache_max_results: int = 256
    cache_max_checkpoints: int = 64
    cache_proposals: bool = True
    cache_dir: Optional[str] = None

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if self.batch_window_s < 0:
            raise ValueError("batch_window_s must be >= 0")
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if self.aging_s is not None and self.aging_s <= 0:
            raise ValueError("aging_s must be > 0 (or None)")
        if self.checkpoint_max_bytes < 0:
            raise ValueError("checkpoint_max_bytes must be >= 0")
        if self.cache_max_results < 1:
            raise ValueError("cache_max_results must be >= 1")
        if self.cache_max_checkpoints < 1:
            raise ValueError("cache_max_checkpoints must be >= 1")
        self.arena_config()  # the pool's ranges

    def arena_config(self) -> ops_ragged.ArenaConfig:
        """The serving pool's configuration from these fields."""
        return ops_ragged.ArenaConfig(
            rows=self.ragged_rows, page_rows=self.ragged_page,
            band_e=self.ragged_e, read_len=self.ragged_l,
            cons_len=self.ragged_c, gang=self.ragged_gang,
            enabled=self.ragged, mixed_w=self.ragged_mixed_w,
        )


def _build_engine(request: JobRequest):
    """Instantiate the engine for one job (with offset seeding).  Imports
    are local to keep ``serve`` importable without the model stack."""
    from waffle_con_tpu_torch.config import CdwfaConfig
    from waffle_con_tpu_torch.models.consensus import ConsensusDWFA
    from waffle_con_tpu_torch.models.dual_consensus import DualConsensusDWFA
    from waffle_con_tpu_torch.models.priority_consensus import (
        PriorityConsensusDWFA,
    )

    config = request.config if request.config is not None else CdwfaConfig()
    if request.kind == "priority":
        engine = PriorityConsensusDWFA(config)
        for chain in request.reads:
            engine.add_sequence_chain(list(chain))
        return engine
    cls = ConsensusDWFA if request.kind == "single" else DualConsensusDWFA
    engine = cls(config)
    offsets = request.offsets or (None,) * len(request.reads)
    for read, offset in zip(request.reads, offsets):
        engine.add_sequence_offset(read, offset)
    return engine


class ConsensusService:
    """Accepts, schedules, and batch-serves consensus jobs.

    Usage::

        with ConsensusService(ServeConfig(workers=4)) as svc:
            handles = [svc.submit(req) for req in requests]
            results = [h.result(timeout=60) for h in handles]

    ``autostart=False`` builds the service with workers and dispatcher
    parked (tests use this to exercise admission-queue semantics with no
    timing dependence); call :meth:`start` to begin serving.  ``arena``
    pins the ragged pass to one serving pool; by default the service
    uses the process pool, rebuilt to this config's geometry.
    ``device_set`` pins the service's jobs to one
    :class:`~waffle_con_tpu_torch.parallel.mesh.DeviceSet`: a placed job
    shards its reads over it (and placement counts its devices).
    """

    def __init__(
        self,
        config: Optional[ServeConfig] = None,
        autostart: bool = True,
        arena=None,
        device_set=None,
    ) -> None:
        self.config = config if config is not None else ServeConfig()
        self._device_set = device_set
        if self.config.flight_dir is not None:
            obs_flight.set_incident_dir(self.config.flight_dir)
        self._arena = (
            arena if arena is not None
            else ops_ragged.get_arena(self.config.arena_config())
        )
        self._queue = AdmissionQueue(
            self.config.queue_limit, name=self.config.name,
            aging_s=self.config.aging_s,
        )
        self._dispatcher = BatchingDispatcher(
            window_s=self.config.batch_window_s,
            max_batch=self.config.max_batch,
            name=self.config.name,
            adaptive_window=self.config.adaptive_window,
            arena=self._arena,
        )
        self._pool = WorkerPool(
            self.config.workers, self._queue, self._run_job,
            name=self.config.name,
        )
        self._lock = lockcheck.make_lock("serve.service.ConsensusService")
        self._next_id = 0
        self._closed = False
        self._handles: List[JobHandle] = []
        #: job_id -> live CheckpointController (running jobs only);
        #: request_checkpoints() fans a snapshot request out over it
        self._controllers: Dict[int, object] = {}
        self._counts = {
            "submitted": 0, "rejected": 0, "done": 0, "failed": 0,
            "cancelled": 0, "expired": 0, "mesh_placed": 0,
            "placement_errors": 0, "cached": 0, "certified": 0,
        }
        self._ckpt_counts = {
            "snapshots": 0, "bytes": 0, "resumed": 0, "rejected": 0,
        }
        #: the consensus cache, or None when ServeConfig.cache is off
        self._cache = serve_cache.ConsensusCache.from_config(
            self.config.name, self.config
        )
        self._stats_published_at = 0.0
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        self._dispatcher.start()
        self._pool.start()

    def close(
        self, cancel_pending: bool = False, timeout: Optional[float] = None
    ) -> None:
        """Shut down.  Default drains gracefully: everything already
        admitted runs to completion first.  ``cancel_pending=True``
        finalizes still-queued jobs as CANCELLED instead."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            handles = list(self._handles)
        if cancel_pending:
            for handle in self._queue.drain():
                handle.cancel()
        if self._pool.started:
            for handle in handles:
                handle.wait(timeout)
        self._pool.stop(wait=True)
        # any job still queued when the pool stopped (never-started
        # service, or drain raced a worker) must not hang its client
        for handle in self._queue.drain():
            handle._finish(
                JobStatus.CANCELLED,
                exception=ServiceClosed("service closed before job ran"),
            )
        self._dispatcher.close()

    def __enter__(self) -> "ConsensusService":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- client API ----------------------------------------------------

    def submit(self, request: JobRequest, checkpoint=None) -> JobHandle:
        """Admit one job; raises :class:`ServiceOverloaded` when the
        bounded queue is full and :class:`ServiceClosed` after close.
        ``checkpoint`` optionally resumes a previously snapshotted search
        (a wire dict from :attr:`JobHandle.checkpoint`), with the
        request's reads missing from the checkpoint's joining the resumed
        search (single, unseeded jobs); a checkpoint that does not resume
        degrades to a fresh search with a ``checkpoint_rejected``
        incident, never a failed job.  With the cache on, a job without a
        checkpoint is looked up first (the certify pass inside the
        service's device scope): an exact or certified hit is finished
        here without being queued."""
        if not isinstance(request, JobRequest):
            raise TypeError(
                f"expected JobRequest, got {type(request).__name__}"
            )
        request = self._place(request)
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is closed to new jobs")
            handle = JobHandle(
                self._next_id, request, service=self.config.name
            )
            self._next_id += 1
        if checkpoint is not None:
            handle._attach_checkpoint(checkpoint)
        elif self._cache is not None:
            with self._device_scope():
                hit = self._cache.lookup(
                    request, trace_id=handle.trace.trace_id
                )
            if isinstance(hit, serve_cache.CacheHit):
                status = (
                    JobStatus.CACHED if hit.tier == "exact"
                    else JobStatus.CERTIFIED
                )
                handle._finish(status, result=hit.result)
                with self._lock:
                    self._counts["submitted"] += 1
                    self._handles.append(handle)
                self._account(handle, status.value)
                return handle
            if isinstance(hit, serve_cache.CheckpointHit):
                handle._attach_checkpoint(hit.checkpoint)
                handle._from_cache_checkpoint = True
        try:
            self._queue.put(handle)
        except ServiceOverloaded:
            with self._lock:
                self._counts["rejected"] += 1
            events.record(
                "serve_overloaded", job_kind=request.kind,
                queue_limit=self.config.queue_limit,
            )
            # one incident per process for the whole storm (dedupe on
            # reason), carrying the first rejected job's identity
            obs_flight.trigger(
                "service_overloaded",
                rejected_trace_id=handle.trace.trace_id,
                job_kind=request.kind,
                queue_limit=self.config.queue_limit,
                queue_depth=self._queue.depth(),
            )
            raise
        with self._lock:
            self._counts["submitted"] += 1
            self._handles.append(handle)
        return handle

    def submit_all(self, requests: Sequence[JobRequest]) -> List[JobHandle]:
        return [self.submit(r) for r in requests]

    def _place(self, request: JobRequest) -> JobRequest:
        """The configured placement policy at admission: a large
        ``"torch"`` job gets ``mesh_shards`` written into its config, so
        its scorer is built sharded over the service's devices (the
        pinned device set's, else the local devices of the job's device
        type).  Placement only ever routes: an error while placing is
        counted (``stats()["jobs"]["placement_errors"]``), recorded as a
        ``placement_failed`` event, and the job stays on the pool."""
        policy = self.config.placement
        if policy is None:
            return request
        try:
            placed = policy.place(request, self._available_devices(request))
        except Exception as exc:  # noqa: BLE001 - counted, never silent
            with self._lock:
                self._counts["placement_errors"] += 1
            events.record(
                "placement_failed", job_kind=request.kind,
                reads=len(request.reads), service=self.config.name,
                error=repr(exc),
            )
            return request
        if placed is None:
            return request
        with self._lock:
            self._counts["mesh_placed"] += 1
        events.record(
            "job_placed_mesh", job_kind=request.kind,
            reads=len(request.reads),
            shards=placed.config.mesh_shards,
            service=self.config.name,
        )
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_serve_mesh_placed_total",
                service=self.config.name,
            ).inc()
        return placed

    def _available_devices(self, request: JobRequest) -> int:
        """The devices a placed job may shard over: the pinned device
        set's size, else the local device count of the job's device
        type."""
        if self._device_set is not None:
            return len(self._device_set)
        import torch

        from waffle_con_tpu_torch.parallel import mesh as par_mesh

        device = (request.config.device if request.config is not None
                  else "cuda")
        return par_mesh.probe_device_count(torch.device(device).type)

    def outstanding(self) -> int:
        """Admitted-but-unfinished job count (queued + running)."""
        with self._lock:
            counts = dict(self._counts)
        finished = (counts["done"] + counts["failed"]
                    + counts["cancelled"] + counts["expired"]
                    + counts["cached"] + counts["certified"])
        return max(0, counts["submitted"] - finished)

    # -- worker --------------------------------------------------------

    def _run_job(self, handle: JobHandle) -> None:
        from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
        from waffle_con_tpu_torch.ops.scorer import set_scorer_decorator

        if not handle._mark_running():
            # cancelled while queued: finalized by cancel() already,
            # account it now that its heap entry has been consumed
            self._account(handle, "cancelled")
            return
        # the job's trace context for everything the worker does on its
        # behalf: spans land under the job's Chrome pid and the flight
        # recorder attributes records even with tracing off
        prev_ctx = obs_trace.set_current_context(handle.trace)
        obs_flight.record(
            "job_start", trace_id=handle.trace.trace_id,
            job_kind=handle.request.kind, job_id=handle.job_id,
            queued_s=round(time.monotonic() - handle.submitted_at, 6),
        )
        try:
            handle.check_abort()  # the deadline may already have lapsed
        except BaseException as exc:
            self._finalize(handle, exc)
            obs_trace.set_current_context(prev_ctx)
            return
        self._dispatcher.job_started()
        dispatcher, ticket = self._dispatcher, handle
        previous = set_scorer_decorator(
            lambda scorer: CoalescingScorer(scorer, dispatcher, ticket)
        )
        policy = self.config.placement
        learn = policy is not None and policy.learned
        phases_before = (obs_phases.totals()
                         if learn and obs_phases.profiling_enabled()
                         else None)
        job_t0 = time.monotonic()
        ctrl = ckpt_mod.CheckpointController(
            interval_s=self.config.checkpoint_interval_s,
            max_bytes=self.config.checkpoint_max_bytes,
            deadline=handle.deadline,
            on_snapshot=lambda ckpt: self._deliver_checkpoint(handle, ckpt),
            label=f"job {handle.job_id}",
        )
        with self._lock:
            self._controllers[handle.job_id] = ctrl
        failure: Optional[BaseException] = None
        try:
            try:
                with obs_trace.span(
                    "serve:job", "serve",
                    kind=handle.request.kind, job_id=handle.job_id,
                ), self._device_scope(), \
                        ops_ragged.serve_scope(self._arena.cfg):
                    # serve scope: scorers built for this job floor their
                    # consensus capacity to the pool's (see
                    # ops.ragged.geometry_hint), and engines do not
                    # self-gang; the device scope pins every scorer the
                    # job builds (a restart's and a supervisor's fallback
                    # included) to the service's device set
                    engine = self._make_engine(handle)
                    try:
                        with ckpt_mod.installed(ctrl):
                            result = engine.consensus()
                    except ckpt_mod.CheckpointRejected as exc:
                        # a checkpoint body is validated when the engine
                        # consumes it: restart from scratch, never fail
                        self._record_ckpt_rejection(handle, exc)
                        with self._lock:
                            # it never actually resumed
                            self._ckpt_counts["resumed"] -= 1
                        handle._drop_checkpoint()
                        engine = _build_engine(handle.request)
                        with ckpt_mod.installed(ctrl):
                            result = engine.consensus()
            except BaseException as exc:
                failure = exc
            finally:
                with self._lock:
                    self._controllers.pop(handle.job_id, None)
                set_scorer_decorator(previous)
                self._end_residency(handle)
            # the job is finished only now, with its pages back: a client
            # woken by result() reads a pool with this job released
            if failure is not None:
                self._finalize(handle, failure)
            else:
                # deposited before the handle finishes, so a duplicate
                # submitted right after result() finds the entry
                self._deposit(handle, result)
                handle._finish(
                    JobStatus.DONE, result=result,
                    report=getattr(engine, "last_search_report", None),
                )
                self._account(handle, "done")
                if learn:
                    self._record_placement_outcome(
                        handle, time.monotonic() - job_t0, phases_before)
        finally:
            obs_trace.set_current_context(prev_ctx)

    def _end_residency(self, handle: JobHandle) -> None:
        """Page-table residency ends with the job: whatever scorers it
        admitted into the serving pool free their pages (idempotent: a
        second release finds nothing), then the dispatcher lets the job
        go.  Runs once a job, before its handle is finished."""
        try:
            ops_ragged.release_job(handle.job_id, arena=self._arena)
        except Exception:  # noqa: BLE001 - never block teardown
            pass
        self._dispatcher.job_finished()

    def _device_scope(self):
        """Pins this worker thread to the service's device set for one
        job (a no-op when none is pinned)."""
        if self._device_set is None:
            return contextlib.nullcontext()
        from waffle_con_tpu_torch.parallel import mesh as par_mesh

        return par_mesh.use_device_set(self._device_set)

    def _record_placement_outcome(self, handle: JobHandle, wall_s: float,
                                  phases_before) -> None:
        """Append one placement-profile record of a finished job to the
        learned policy's perf database: its substrate (mesh iff
        :meth:`_place` wrote ``mesh_shards`` into its config), reads and
        wall, and with phase profiling on the process phase totals'
        change over the job.  A failed write is recorded as an event and
        never fails the job."""
        config = handle.request.config
        substrate = (
            "mesh" if getattr(config, "mesh_shards", 0) >= 2 else "arena"
        )
        phases = None
        if phases_before is not None:
            after = obs_phases.totals()
            phases = {
                k: max(0.0, after.get(k, 0.0) - phases_before.get(k, 0.0))
                for k in ("host_prep", "device_compute", "transfer")
            }
        try:
            serve_placement.record_outcome(
                substrate, len(handle.request.reads), wall_s,
                phases=phases, path=self.config.placement.perfdb_path,
            )
        except OSError as exc:
            events.record("placement_profile_failed",
                          service=self.config.name, error=repr(exc))

    def _deposit(self, handle: JobHandle, result) -> None:
        """Feed a finished job back into the consensus cache: its wire
        result under the canonical key, plus its last *bound-free*
        mid-search checkpoint for superset resume (a bound-tightened
        snapshot prunes with subset-only costs and must never seed a
        superset search).  Jobs that themselves resumed from a
        checkpoint never deposit (their search did not cover the full
        space from scratch — fail-closed for parity).  Cache IO never
        fails a job."""
        if self._cache is None:
            return
        if getattr(handle, "_resumed_from_checkpoint", False):
            return
        try:
            self._cache.deposit_result(
                handle.request,
                wire.encode_result(handle.request.kind, result),
            )
            last = getattr(handle, "_cache_ckpt", None)
            if last is not None:
                self._cache.deposit_checkpoint(handle.request, last)
        except Exception:  # noqa: BLE001 - cache must never fail a job
            pass

    def _make_engine(self, handle: JobHandle):
        """Build the job's engine, resuming from the handle's attached
        checkpoint when one is present (with the request's reads the
        checkpoint lacks as extras).  A rejected checkpoint degrades to a
        fresh search with a ``checkpoint_rejected`` incident."""
        from waffle_con_tpu_torch.models import checkpoint as ckpt_mod

        wire_ckpt = handle.checkpoint
        if wire_ckpt is not None:
            try:
                checkpoint = ckpt_mod.SearchCheckpoint.from_wire(wire_ckpt)
                if checkpoint.kind != handle.request.kind:
                    raise ckpt_mod.CheckpointRejected(
                        f"{handle.request.kind} job cannot resume a "
                        f"{checkpoint.kind!r} checkpoint"
                    )
                extras = self._checkpoint_extras(handle.request, checkpoint)
                engine = ckpt_mod.resume_engine(
                    checkpoint, extra_reads=extras
                )
            except ckpt_mod.CheckpointRejected as exc:
                self._record_ckpt_rejection(handle, exc)
            else:
                handle._resumed_from_checkpoint = True
                with self._lock:
                    self._ckpt_counts["resumed"] += 1
                events.record(
                    "job_resumed", job_id=handle.job_id,
                    job_kind=handle.request.kind, service=self.config.name,
                    extra_reads=len(extras),
                )
                return engine
        return _build_engine(handle.request)

    @staticmethod
    def _checkpoint_extras(request: JobRequest, checkpoint) -> tuple:
        """The request reads missing from a checkpoint's read multiset
        (the superset resume): the engine restores the recorded frontier
        and joins these at offset 0.  Empty when the multisets match (a
        plain resume), for any job but a single unseeded one, and
        whenever the overlap cannot be established (a malformed body) —
        never a reason to reject the checkpoint."""
        from waffle_con_tpu_torch.models import checkpoint as ckpt_mod

        if request.kind != "single" or request.offsets is not None:
            return ()
        try:
            body_reads = [
                ckpt_mod.unb64(r) for r in checkpoint.body["reads"]
            ]
            extras = serve_cache.keys.multiset_extras(
                request.reads, body_reads
            )
        except Exception:  # noqa: BLE001 - malformed body: plain resume
            return ()
        return extras or ()

    def _record_ckpt_rejection(self, handle: JobHandle, exc) -> None:
        """Account one rejected checkpoint (counter, event log, typed
        flight incident, metric): the construction-time and the deferred
        (mid-``consensus()``) paths both come here."""
        with self._lock:
            self._ckpt_counts["rejected"] += 1
        events.record(
            "checkpoint_rejected", job_id=handle.job_id,
            service=self.config.name, why=str(exc),
        )
        obs_flight.trigger(
            "checkpoint_rejected",
            trace_id=handle.trace.trace_id,
            job_id=handle.job_id, job_kind=handle.request.kind,
            service=self.config.name, why=str(exc),
        )
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_ckpt_rejected_total", service=self.config.name,
            ).inc()

    def _deliver_checkpoint(self, handle: JobHandle, checkpoint) -> None:
        """Controller snapshot hook: attach the wire form to the handle
        and count.  With the cache on, a bound-free snapshot also becomes
        the job's checkpoint deposit candidate (only those resume a read
        superset exactly, see
        :func:`waffle_con_tpu_torch.serve.cache.resumable_wire`)."""
        size = checkpoint.byte_size()
        wire_ckpt = checkpoint.to_wire()
        handle._attach_checkpoint(wire_ckpt)
        if self._cache is not None and serve_cache.resumable_wire(wire_ckpt):
            handle._cache_ckpt = wire_ckpt
        with self._lock:
            self._ckpt_counts["snapshots"] += 1
            self._ckpt_counts["bytes"] += size
        obs_flight.record(
            "job_checkpoint", trace_id=handle.trace.trace_id,
            job_id=handle.job_id, bytes=size,
        )

    def request_checkpoints(self, preempt: bool = False) -> int:
        """Ask every running job to snapshot at its next pop boundary;
        with ``preempt`` the searches also stop there.  Returns how many
        jobs were signalled."""
        with self._lock:
            controllers = list(self._controllers.values())
        for ctrl in controllers:
            ctrl.request_snapshot(preempt=preempt)
        return len(controllers)

    def _finalize(self, handle: JobHandle, exc: BaseException) -> None:
        if isinstance(exc, JobCancelled):
            handle._finish(JobStatus.CANCELLED, exception=exc)
            self._account(handle, "cancelled")
        elif isinstance(exc, DeadlineExceeded):
            handle._finish(JobStatus.EXPIRED, exception=exc)
            self._account(handle, "expired")
        else:
            handle._finish(JobStatus.FAILED, exception=exc)
            self._account(handle, "failed")

    def _account(self, handle: JobHandle, outcome: str) -> None:
        with self._lock:
            self._counts[outcome] += 1
        latency = handle.latency_s
        obs_flight.record(
            "job_end", trace_id=handle.trace.trace_id,
            outcome=outcome, job_id=handle.job_id,
            latency_s=(round(latency, 6) if latency is not None else None),
        )
        if outcome == "done" and latency is not None:
            obs_slo.observe_job(latency)
        self._publish_stats()
        if obs_metrics.metrics_enabled():
            reg = obs_metrics.registry()
            reg.counter(
                "waffle_serve_jobs_total",
                service=self.config.name, outcome=outcome,
            ).inc()
            if latency is not None:
                reg.histogram(
                    "waffle_serve_job_latency_seconds",
                    service=self.config.name,
                ).observe(latency)
            reg.gauge(
                "waffle_serve_active_jobs", service=self.config.name
            ).set(self._active_jobs())

    def _publish_stats(self) -> None:
        """With ``stats_file`` set, atomically rewrite it with the live
        stats and SLO snapshot (at most every 0.25 s)."""
        path = self.config.stats_file
        if not path:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._stats_published_at < 0.25:
                return
            self._stats_published_at = now
        payload = {
            "service": self.config.name,
            "unix_time": time.time(),
            "stats": self.stats(),
            "slo": obs_slo.snapshot(),
            "incidents": [
                {k: i.get(k) for k in
                 ("seq", "reason", "trace_id", "unix_time", "path")}
                for i in obs_flight.incidents()[-8:]
            ],
        }
        if obs_metrics.metrics_enabled():
            payload["metrics"] = obs_metrics.registry().snapshot()
        audit_status = obs_audit.status()
        if audit_status is not None:
            payload["audit"] = audit_status
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, default=repr)
            os.replace(tmp, path)
        except OSError:  # a broken stats sink must never fail a job
            pass

    def _active_jobs(self) -> int:
        return max(0, self.outstanding() - self._queue.depth())

    # -- introspection -------------------------------------------------

    def stats(self) -> Dict:
        """Point-in-time counters, the dispatcher's batching stats, the
        serving pool's and (when on) the consensus cache's."""
        with self._lock:
            counts = dict(self._counts)
            ckpt_counts = dict(self._ckpt_counts)
        payload = {
            "jobs": counts,
            "checkpoints": ckpt_counts,
            "queue_depth": self._queue.depth(),
            "aged_pops": self._queue.aged_pops,
            "dispatch": self._dispatcher.stats(),
            "ragged": ops_ragged.arena_stats(self._arena),
        }
        if self._cache is not None:
            payload["cache"] = self._cache.stats()
        return payload
