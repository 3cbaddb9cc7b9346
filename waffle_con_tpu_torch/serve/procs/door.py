"""Out-of-process front door: admission and routing over worker processes.

The port of ``waffle_con_tpu``'s ``serve/procs/door.py``.
:class:`ProcFrontDoor` is the process-parallel sibling of
:class:`~waffle_con_tpu_torch.serve.replicas.ReplicatedService`: the same
least-outstanding, health-aware routing, but the N members are **worker
processes** (each its own interpreter, GIL, CUDA context, dispatcher,
serving pool and worker pool) reached over an AF_UNIX socket speaking the
typed frames of :mod:`waffle_con_tpu_torch.serve.procs.wire`.

The door owns what the workers must agree on once:

* **admission** — one bounded priority queue with anti-starvation aging
  (:class:`~waffle_con_tpu_torch.serve.scheduler.AdmissionQueue`); a full
  queue rejects with
  :class:`~waffle_con_tpu_torch.serve.job.ServiceOverloaded`.
* **placement** — a
  :class:`~waffle_con_tpu_torch.serve.placement.PlacementPolicy` (the
  template's ``ServeConfig.placement``) runs door-side at admission, so
  the decision travels to the worker inside the job's config.
* **health** — each worker forwards its flight-recorder triggers as
  ``HEALTH`` frames; ``backend_demoted`` puts the worker in ``draining``
  (no new routes until its routed jobs finish, then re-admission),
  ``slow_search`` in ``shedding`` for ``shed_cooldown_s``.
* **liveness** — a watchdog pings every worker every
  ``ProcConfig.ping_s`` and any frame counts as a heartbeat; a process
  that exited, a closed socket, or silence past ``ProcConfig.liveness_s``
  marks the worker **lost**: exactly one ``worker_lost`` flight incident,
  and its jobs move to healthy workers.  Jobs not yet started are
  requeued; started jobs **migrate**: the door re-dispatches each with
  the latest ``CHECKPOINT`` frame the worker streamed back, so the search
  resumes at its last pop boundary (byte-identical: the checkpoint rides
  the engines' node-identity invariant,
  :mod:`waffle_con_tpu_torch.models.checkpoint`).  A started job with no
  checkpoint (or ``checkpoint_migrate`` off) restarts from scratch under
  ``restart_lost``, else fails with
  :class:`~waffle_con_tpu_torch.runtime.liveness.WorkerLost`.
* **checkpoints** — workers snapshot searches every
  ``ServeConfig.checkpoint_interval_s`` of the template, at a deadline's
  lapse and on ``DRAIN``; each snapshot lands on the door-side handle.
  :meth:`ProcFrontDoor.close` sends ``DRAIN`` to still-busy workers once
  its queue is empty, so a drain that runs out of time leaves every
  started job a fresh resume point.
* **the consensus cache** (the template's ``cache*`` fields) — exact and
  certified hits answer before a ``SUBMIT`` is encoded; a superset hit
  rides a cached checkpoint to the worker.
* **observability** — ``waffle_worker_*`` and ``waffle_ckpt_*`` metrics,
  a ``workers`` table in the template's ``stats_file`` (the door is its
  only writer), runtime events at every transition.  With tracing on, the
  door opens a per-job root span, ships the job's trace context on each
  ``SUBMIT`` and stitches the worker's returned spans into one connected
  Chrome trace (flow arrows across the socket); with metrics on, it
  merges each worker's ``STATS`` snapshot under a ``worker=`` label and
  splits each job's latency into queued, routed and running; forwarded
  ``INCIDENT`` frames are re-ingested into its flight recorder with the
  worker's name and fleet-wide dedupe (in the template's ``flight_dir``
  when one is set).

Every knob the JAX package reads from the environment is a field here
(:class:`ProcConfig`): the workers get theirs in the ``--spec`` JSON of
their command line and read no environment variable either.

A client's cancel finishes the door-side handle at once; the worker
computes on until its own abort check, and its late frames land on a
finished handle (no-op).
"""

from __future__ import annotations

import collections
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Set

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import slo as obs_slo
from waffle_con_tpu_torch.obs import trace as obs_trace
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.runtime.liveness import Heartbeats, WorkerLost
from waffle_con_tpu_torch.runtime.watchdog import DeadlineExceeded
from waffle_con_tpu_torch.serve import cache as serve_cache
from waffle_con_tpu_torch.serve.job import (
    JobCancelled,
    JobHandle,
    JobRequest,
    JobStatus,
    ServiceClosed,
    ServiceOverloaded,
)
from waffle_con_tpu_torch.serve.procs import wire
from waffle_con_tpu_torch.serve.scheduler import AdmissionQueue
from waffle_con_tpu_torch.serve.service import ServeConfig

#: worker states (the first three mirror the in-process replica set)
UP = "up"
DRAINING = "draining"    # circuit-break: no routes until drained
SHEDDING = "shedding"    # latency flag: deprioritized for a cooldown
LOST = "lost"            # process dead / socket gone / liveness lapse

_HEALTH_REASONS = ("backend_demoted", "slow_search")

RECV_CHUNK = 1 << 16

#: the worker process's module (``python -m``)
WORKER_MODULE = "waffle_con_tpu_torch.serve.procs.worker"

#: fields of the template that are the door's alone: placement, the stats
#: file and the consensus cache run door-side only (and the incident
#: directory while workers forward their incidents)
_DOOR_ONLY = ("placement", "stats_file", "cache", "cache_max_results",
              "cache_max_checkpoints", "cache_proposals", "cache_dir")


@dataclasses.dataclass(frozen=True)
class ProcConfig:
    """Front-door knobs.

    * ``workers`` — worker *process* count.
    * ``worker_slots`` — concurrent jobs inside each worker (its
      service's ``ServeConfig.workers``).
    * ``queue_limit`` — the door's bounded admission queue (a worker's
      own queue takes the door's whole routing window).
    * ``name`` — the door's name; worker ``i`` is ``<name>:w<i>``.
    * ``aging_s`` — admission anti-starvation, at the door and in every
      worker (``None``: strict priority).
    * ``shed_cooldown_s`` — how long a ``slow_search`` worker stays
      deprioritized.
    * ``restart_lost`` — restart a lost worker's started jobs that have no
      checkpoint from scratch on a healthy worker (deterministic engines
      make the retried result byte-identical); off, they fail with
      :class:`~waffle_con_tpu_torch.runtime.liveness.WorkerLost`.  Jobs
      not yet started are requeued either way.
    * ``inflight`` — routed but unfinished jobs the door keeps on one
      worker before holding further routes (default ``2 * worker_slots``:
      one batch running, one queued behind it).
    * ``spawn_timeout_s`` — how long :meth:`ProcFrontDoor.start` waits for
      every worker's ``HELLO``.
    * ``launcher`` — the spawn seam: ``launcher(socket_path, name,
      spec_json)`` returning a Popen-like handle (``pid``, ``poll``,
      ``terminate``, ``kill``, ``wait``); ``None`` runs ``python -m
      waffle_con_tpu_torch.serve.procs.worker``.
    * ``serve`` — the :class:`~waffle_con_tpu_torch.serve.service.
      ServeConfig` template: a worker's service takes its batching
      window, serving pool and checkpoint fields (``workers``,
      ``queue_limit``, ``name`` and ``aging_s`` are set from this
      config); its ``placement``, ``stats_file`` and ``cache*`` fields
      are the door's, and so is ``flight_dir`` while ``forward_incidents``
      is on (the door writes each worker's incidents there).
    * ``ping_s`` — the watchdog's ping period (JAX
      ``WAFFLE_PROC_PING_S``).
    * ``liveness_s`` — silence before a worker is declared lost
      (``WAFFLE_PROC_LIVENESS_S``).
    * ``checkpoint_migrate`` — resume a lost worker's started jobs from
      their last checkpoint (``WAFFLE_CKPT_MIGRATE``); off, they take the
      ``restart_lost`` path.
    * ``forward_incidents`` — workers forward each flight incident as an
      ``INCIDENT`` frame (``WAFFLE_PROC_INCIDENTS``).
    * ``stats_interval_s`` — a worker's ``STATS`` period while metrics
      are on (``WAFFLE_PROC_STATS_S``; at least 0.05).
    * ``trace_span_cap`` — span events a worker ships on one frame
      (``WAFFLE_TRACE_SPAN_CAP``; at least 16).
    * ``max_payload`` — the largest frame payload either side sends or
      accepts (``WAFFLE_PROC_FRAME_MAX``).
    """

    workers: int = 2
    worker_slots: int = 2
    queue_limit: int = 64
    name: str = "consensus"
    aging_s: Optional[float] = 0.5
    shed_cooldown_s: float = 2.0
    restart_lost: bool = True
    inflight: Optional[int] = None
    spawn_timeout_s: float = 120.0
    launcher: Optional[Callable[[str, str, str], Any]] = None
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    ping_s: float = 0.5
    liveness_s: float = 5.0
    checkpoint_migrate: bool = True
    forward_incidents: bool = True
    stats_interval_s: float = 2.0
    trace_span_cap: int = 512
    max_payload: int = wire.MAX_PAYLOAD

    def __post_init__(self) -> None:
        if self.workers < 1:
            raise ValueError("workers must be >= 1")
        if self.worker_slots < 1:
            raise ValueError("worker_slots must be >= 1")
        if self.queue_limit < 1:
            raise ValueError("queue_limit must be >= 1")
        if self.aging_s is not None and self.aging_s <= 0:
            raise ValueError("aging_s must be > 0 (or None)")
        if self.shed_cooldown_s < 0:
            raise ValueError("shed_cooldown_s must be >= 0")
        if self.inflight is not None and self.inflight < 1:
            raise ValueError("inflight must be >= 1 (or None)")
        if self.spawn_timeout_s <= 0:
            raise ValueError("spawn_timeout_s must be > 0")
        if not isinstance(self.serve, ServeConfig):
            raise TypeError("serve must be a ServeConfig")
        if self.ping_s <= 0:
            raise ValueError("ping_s must be > 0")
        if self.liveness_s <= 0:
            raise ValueError("liveness_s must be > 0")
        if self.stats_interval_s < 0.05:
            raise ValueError("stats_interval_s must be >= 0.05")
        if self.trace_span_cap < 16:
            raise ValueError("trace_span_cap must be >= 16")
        if self.max_payload < wire.MIN_MAX_PAYLOAD:
            raise ValueError(
                f"max_payload must be >= {wire.MIN_MAX_PAYLOAD}"
            )

    @property
    def window(self) -> int:
        return (self.inflight if self.inflight is not None
                else 2 * self.worker_slots)

    def worker_serve_config(self, name: str) -> ServeConfig:
        """The :class:`ServeConfig` of worker ``name``'s service: the
        template with this config's slots, queue, name and aging, and the
        door-only fields at their defaults (off)."""
        door_only = _DOOR_ONLY + (
            ("flight_dir",) if self.forward_incidents else ())
        default = ServeConfig()
        return dataclasses.replace(
            self.serve, **{f: getattr(default, f) for f in door_only},
            workers=self.worker_slots,
            # the worker's queue must absorb the door's whole window
            queue_limit=max(self.queue_limit, self.window),
            name=name, aging_s=self.aging_s,
        )


class _Worker:
    """Mutable per-worker record (state guarded by the door's lock)."""

    __slots__ = ("index", "name", "proc", "pid", "sock", "slots",
                 "state", "shed_until", "assigned", "started",
                 "routed", "demotions", "sheds", "readmits", "requeues",
                 "migrations", "restarts", "ckpt_frames", "ckpt_bytes",
                 "reported_outstanding", "decoder", "send_lock",
                 "stats_frames", "stats_at", "last_slo", "incidents",
                 "span_events", "spawned_at", "start_s")

    def __init__(self, index: int, name: str, max_payload: int) -> None:
        self.index = index
        self.name = name
        self.proc: Any = None
        self.pid: Optional[int] = None
        self.sock: Optional[socket.socket] = None
        self.slots = 1
        self.state = UP
        self.shed_until = 0.0
        self.assigned: Dict[int, JobHandle] = {}
        self.started: Set[int] = set()
        self.routed = 0
        self.demotions = 0
        self.sheds = 0
        self.readmits = 0
        self.requeues = 0
        self.migrations = 0
        self.restarts = 0
        self.ckpt_frames = 0
        self.ckpt_bytes = 0
        self.reported_outstanding = 0
        self.decoder = wire.FrameDecoder(max_payload=max_payload)
        self.send_lock = lockcheck.make_lock(f"procs.door.send.{name}")
        self.stats_frames = 0
        self.stats_at: Optional[float] = None
        self.last_slo: Optional[Dict] = None
        self.incidents = 0
        self.span_events = 0
        self.spawned_at: Optional[float] = None
        #: seconds from spawn to the worker's HELLO
        self.start_s: Optional[float] = None


class ProcFrontDoor:
    """N worker processes behind least-outstanding, health-aware routing
    over the typed socket protocol.

    Usage::

        with ProcFrontDoor(ProcConfig(workers=2)) as door:
            handles = [door.submit(req) for req in requests]
            results = [h.result(timeout=600) for h in handles]
    """

    def __init__(
        self,
        config: Optional[ProcConfig] = None,
        autostart: bool = True,
    ) -> None:
        self.config = config if config is not None else ProcConfig()
        template = self.config.serve
        self._lock = lockcheck.make_lock("serve.procs.ProcFrontDoor")
        self._closed = False
        self._started = False
        self._next_id = 0
        self._jobs: Dict[int, JobHandle] = {}
        self._counts: Dict[str, int] = collections.defaultdict(int)
        self._retry: Deque[JobHandle] = collections.deque()
        self._queue = AdmissionQueue(
            self.config.queue_limit,
            name=f"{self.config.name}.door",
            aging_s=self.config.aging_s,
        )
        self._beats = Heartbeats()
        #: per-job distributed-trace state ({"root", "dispatches",
        #: "flow"}) by job id: only while tracing is on and the job is in
        #: flight (see _trace_dispatch)
        self._trace_jobs: Dict[int, Dict] = {}
        #: monotonic time of each job's last SUBMIT send (the phase
        #: histograms' queued / routed split)
        self._routed_at: Dict[int, float] = {}
        self._stats_published_at = 0.0
        self._stopping = False
        if template.flight_dir is not None:
            obs_flight.set_incident_dir(template.flight_dir)
        #: the door-side consensus cache (None unless the template's
        #: ``cache`` is on): exact and certified hits answer before a
        #: SUBMIT is encoded, superset hits ride a cached checkpoint
        self._cache = serve_cache.ConsensusCache.from_config(
            f"{self.config.name}.door", template
        )
        self._tmpdir = tempfile.mkdtemp(prefix="waffle-procs-")
        self._socket_path = os.path.join(self._tmpdir, "door.sock")
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self._socket_path)
        self._listener.listen(self.config.workers)
        self._workers = [
            _Worker(i, f"{self.config.name}:w{i}", self.config.max_payload)
            for i in range(self.config.workers)
        ]
        self._threads: List[Any] = []
        if autostart:
            self.start()

    # -- lifecycle -----------------------------------------------------

    def worker_spec(self, name: str) -> str:
        """The ``--spec`` JSON of worker ``name``: its service's config
        field by field (``placement``, door-side, left out), the process
        knobs it needs, and whether to arm its tracer and metrics
        (switched on in code at the door, they travel no other way)."""
        cfg = self.config
        serve = dataclasses.asdict(cfg.worker_serve_config(name))
        del serve["placement"]
        return json.dumps({
            "serve": serve,
            "stats_interval_s": cfg.stats_interval_s,
            "trace_span_cap": cfg.trace_span_cap,
            "forward_incidents": cfg.forward_incidents,
            "max_payload": cfg.max_payload,
            "trace": obs_trace.tracing_enabled(),
            "metrics": obs_metrics.metrics_enabled(),
        })

    @staticmethod
    def _spawn_process(socket_path: str, name: str, spec: str):
        """One worker process: ``python -m`` of the worker module with the
        package's root on its path (never a fork: a CUDA context does not
        survive one).  Its stdout goes to the door's stderr, so a caller
        reading the door's stdout reads the door alone."""
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env["PYTHONPATH"] = (
            pkg_root + (os.pathsep + env["PYTHONPATH"]
                        if env.get("PYTHONPATH") else "")
        )
        return subprocess.Popen(
            [sys.executable, "-m", WORKER_MODULE,
             "--socket", socket_path, "--worker", name, "--spec", spec],
            env=env, stdin=subprocess.DEVNULL, stdout=2,
        )

    def start(self) -> None:
        with self._lock:
            if self._started or self._closed:
                return
            self._started = True
        launcher = self.config.launcher or self._spawn_process
        for worker in self._workers:
            worker.spawned_at = time.monotonic()
            worker.proc = launcher(self._socket_path, worker.name,
                                   self.worker_spec(worker.name))
        deadline = time.monotonic() + self.config.spawn_timeout_s
        pending = {w.name: w for w in self._workers}
        conn: Optional[socket.socket] = None
        try:
            while pending:
                self._listener.settimeout(
                    max(0.1, deadline - time.monotonic())
                )
                try:
                    conn, _ = self._listener.accept()
                except (socket.timeout, OSError):
                    raise RuntimeError(
                        f"worker handshake timed out; still waiting for "
                        f"{sorted(pending)}"
                    ) from None
                hello, trailing, decoder = self._handshake(conn, deadline)
                worker = pending.pop(hello.get("worker"), None)
                if worker is None:
                    conn.close()
                    conn = None
                    continue
                worker.sock = conn
                conn = None
                worker.decoder = decoder
                worker.pid = int(hello.get("pid", 0)) or None
                worker.slots = int(hello.get("slots", 1))
                worker.start_s = time.monotonic() - worker.spawned_at
                self._beats.beat(worker.name)
                for ftype, obj in trailing:
                    self._on_frame(worker, ftype, obj)
        except Exception:
            if conn is not None:
                try:
                    conn.close()
                except OSError:
                    pass
            self._abort_spawn()
            raise
        for worker in self._workers:
            thread = lockcheck.make_thread(
                target=self._read_loop, args=(worker,),
                name=f"procs.door.read.{worker.name}", daemon=True,
            )
            thread.start()
            self._threads.append(thread)
        router = lockcheck.make_thread(
            target=self._route_loop, name="procs.door.router", daemon=True,
        )
        router.start()
        self._threads.append(router)
        watchdog = lockcheck.make_thread(
            target=self._watch_loop, name="procs.door.watchdog",
            daemon=True,
        )
        watchdog.start()
        self._threads.append(watchdog)
        events.record(
            "procs_door_up", service=self.config.name,
            workers=len(self._workers),
        )

    def _abort_spawn(self) -> None:
        """The handshake failed: close the accepted sockets and reap every
        process already launched, so a raising :meth:`start` leaves no
        live worker behind."""
        for worker in self._workers:
            _close_socket(worker.sock)
            worker.sock = None
            proc = worker.proc
            if proc is None:
                continue
            try:
                proc.terminate()
                proc.wait(timeout=2.0)
            except Exception:  # noqa: BLE001 - escalate to kill
                try:
                    proc.kill()
                    proc.wait(timeout=2.0)
                except Exception:  # noqa: BLE001
                    pass
        # a raising start() means close() never runs: drop the listener
        # and the socket directory here
        self._drop_listener()

    def _drop_listener(self) -> None:
        try:
            self._listener.close()
            os.unlink(self._socket_path)
            os.rmdir(self._tmpdir)
        except OSError:
            pass

    def _handshake(self, conn: socket.socket, deadline: float):
        """Read frames until HELLO.  Returns the HELLO payload, the frames
        that rode in the same chunk and the primed decoder: the caller
        adopts both, or an eager worker's first frame would be lost."""
        decoder = wire.FrameDecoder(max_payload=self.config.max_payload)
        while True:
            conn.settimeout(max(0.1, deadline - time.monotonic()))
            data = conn.recv(RECV_CHUNK)
            if not data:
                raise RuntimeError("worker closed during handshake")
            frames = decoder.feed(data)
            if not frames:
                continue
            ftype, obj = frames[0]
            if ftype is not wire.FrameType.HELLO or not isinstance(obj, dict):
                raise RuntimeError(f"expected HELLO, got {ftype.name}")
            conn.settimeout(None)
            return obj, frames[1:], decoder

    def close(
        self, cancel_pending: bool = False, timeout: Optional[float] = None
    ) -> None:
        """Shut down.  By default drains: everything already admitted runs
        to completion first (``timeout``, default 60 s, bounds the wait).
        ``cancel_pending=True`` cancels still-queued jobs instead.  Every
        worker process has exited (or been killed) when this returns."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._queue.close()
        if cancel_pending:
            leftovers = self._queue.drain()
            with self._lock:
                leftovers.extend(self._retry)
                self._retry.clear()
            for handle in leftovers:
                handle._finish(
                    JobStatus.CANCELLED,
                    exception=ServiceClosed("service closed"),
                )
        budget = timeout if timeout is not None else 60.0
        deadline = time.monotonic() + budget
        drain_sent = False
        while time.monotonic() < deadline:
            # outstanding() counts every admitted unfinished handle, so a
            # job mid-route still holds the drain open
            if self.outstanding() == 0:
                break
            if not drain_sent and self._queue.depth() == 0:
                # everything is routed: busy workers checkpoint their
                # running searches (DRAIN also stops late submits), so a
                # drain that runs out of time leaves every started job a
                # fresh resume point on its door-side handle
                with self._lock:
                    idle = not self._retry
                    busy = [w for w in self._workers
                            if w.state != LOST and w.sock is not None
                            and w.assigned]
                if idle:
                    for worker in busy:
                        self._send(worker, wire.FrameType.DRAIN, {})
                    drain_sent = True
            time.sleep(0.02)
        self._stopping = True
        for worker in self._workers:
            if worker.state != LOST and worker.sock is not None:
                self._send(worker, wire.FrameType.SHUTDOWN, {})
        for worker in self._workers:
            # a survivor exits on SHUTDOWN once its service has closed; a
            # lost one is dead or wedged and gets no grace
            self._reap(worker, 0.1 if worker.state == LOST else 15.0)
            _close_socket(worker.sock)
            self._beats.forget(worker.name)
        self._drop_listener()
        # anything still unfinished is orphaned by the shutdown
        with self._lock:
            orphans = [h for h in self._jobs.values() if not h.done()]
        for handle in orphans:
            handle._finish(
                JobStatus.CANCELLED,
                exception=ServiceClosed("service closed before the job "
                                        "finished"),
            )
        events.record("procs_door_down", service=self.config.name)
        self._publish_stats(force=True)

    @staticmethod
    def _reap(worker: _Worker, grace_s: float) -> None:
        """Wait ``grace_s`` for the worker's process to exit, then
        terminate it, then kill it."""
        proc = worker.proc
        if proc is None or not hasattr(proc, "wait"):
            return
        for step, wait_s in ((None, grace_s), ("terminate", 5.0),
                             ("kill", 5.0)):
            try:
                if step is not None:
                    getattr(proc, step)()
                proc.wait(timeout=wait_s)
                return
            except Exception:  # noqa: BLE001 - escalate
                continue

    def __enter__(self) -> "ProcFrontDoor":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- client API ----------------------------------------------------

    def submit(self, request: JobRequest, checkpoint=None) -> JobHandle:
        """Admit one job; raises :class:`ServiceOverloaded` when the
        bounded queue is full and :class:`ServiceClosed` after close.

        ``checkpoint`` resumes a previously snapshotted search (a wire
        dict from :attr:`~waffle_con_tpu_torch.serve.job.JobHandle.
        checkpoint`, e.g. off an EXPIRED handle): the SUBMIT carries it to
        whichever worker the job routes to."""
        if not isinstance(request, JobRequest):
            raise TypeError(
                f"expected JobRequest, got {type(request).__name__}"
            )
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is closed to new jobs")
        request = self._place(request)
        with self._lock:
            job_id = self._next_id
            self._next_id += 1
            handle = JobHandle(job_id, request, service=self.config.name)
            self._jobs[job_id] = handle
            self._counts["submitted"] += 1
        if checkpoint is not None:
            handle._attach_checkpoint(checkpoint)
        elif self._cache is not None:
            # an exact or certified hit never costs an encoding, a route
            # or a worker slot
            hit = self._cache.lookup(request, trace_id=handle.trace.trace_id)
            if isinstance(hit, serve_cache.CacheHit):
                status = (
                    JobStatus.CACHED if hit.tier == "exact"
                    else JobStatus.CERTIFIED
                )
                handle._finish(status, result=hit.result)
                self._publish_stats()
                return handle
            if isinstance(hit, serve_cache.CheckpointHit):
                handle._attach_checkpoint(hit.checkpoint)
                handle._resumed_from_checkpoint = True
        try:
            self._queue.put(handle)
        except (ServiceOverloaded, ServiceClosed):
            with self._lock:
                self._counts["submitted"] -= 1
                del self._jobs[job_id]
            raise
        self._publish_stats()
        return handle

    def submit_all(self, requests: Sequence[JobRequest]) -> List[JobHandle]:
        return [self.submit(r) for r in requests]

    def outstanding(self) -> int:
        """Admitted but unfinished jobs (queued and routed)."""
        with self._lock:
            return sum(1 for h in self._jobs.values() if not h.done())

    def _place(self, request: JobRequest) -> JobRequest:
        """Door-side placement (the decision travels in the job's
        config), over the local devices of the job's device type.  An
        error while placing is counted (``stats()["jobs"]
        ["placement_errors"]``) and recorded; the job stays unplaced."""
        policy = self.config.serve.placement
        if policy is None:
            return request
        try:
            import torch

            from waffle_con_tpu_torch.parallel import mesh as par_mesh

            device = (request.config.device if request.config is not None
                      else "cuda")
            placed = policy.place(request, par_mesh.probe_device_count(
                torch.device(device).type))
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
        return placed

    # -- routing -------------------------------------------------------

    def _route_loop(self) -> None:
        while True:
            handle: Optional[JobHandle] = None
            with self._lock:
                if self._retry:
                    handle = self._retry.popleft()
            if handle is None:
                handle = self._queue.get(timeout=0.1)
            if handle is None:
                with self._lock:
                    drained = self._closed and not self._retry
                if drained and self._queue.depth() == 0:
                    return
                continue
            if handle.done():
                continue  # cancelled while queued
            try:
                self._route_one(handle)
            except Exception as exc:  # noqa: BLE001 - the router is one
                # thread: an escaping exception would stop routing for
                # good, so the one job fails and routing goes on
                if not handle.done():
                    handle._finish(JobStatus.FAILED, exception=exc)

    def _route_one(self, handle: JobHandle) -> None:
        """Assign one job to the best worker, holding it while no worker
        has room in its window (bounded by close)."""
        while True:
            self._maintain()
            worker = None
            with self._lock:
                if self._closed and self._stopping:
                    break
                window = self.config.window
                ranked = sorted(
                    (w for w in self._workers if w.state != LOST),
                    key=lambda w: (0 if w.state == UP else 1,
                                   len(w.assigned), w.index),
                )
                healthy = [w for w in ranked if w.state == UP]
                pool = healthy or ranked
                with_room = [w for w in pool if len(w.assigned) < window]
                if not with_room and healthy and len(healthy) < len(ranked):
                    # the healthy tier is full: overflow onto the rest
                    with_room = [
                        w for w in ranked
                        if w not in healthy and len(w.assigned) < window
                    ]
                if with_room:
                    worker = with_room[0]
                    worker.assigned[handle.job_id] = handle
                    worker.routed += 1
            if worker is None:
                if handle.done():
                    return
                time.sleep(0.01)
                continue
            if self._dispatch(worker, handle):
                self._publish_worker_metrics(worker)
                self._publish_stats()
            # on a failed dispatch the handle was finished or pushed back
            # onto the retry deque: this routing attempt is over
            return
        handle._finish(
            JobStatus.CANCELLED,
            exception=ServiceClosed("service closed before the job "
                                    "was routed"),
        )

    def _dispatch(self, worker: _Worker, handle: JobHandle) -> bool:
        """Send one SUBMIT; on failure unassign and expire or requeue."""
        deadline_left = None
        if handle.deadline is not None:
            deadline_left = handle.deadline - time.monotonic()
            if deadline_left <= 0:
                with self._lock:
                    worker.assigned.pop(handle.job_id, None)
                handle._finish(
                    JobStatus.EXPIRED,
                    exception=DeadlineExceeded(
                        f"job {handle.job_id} deadline lapsed before "
                        "routing"
                    ),
                )
                return False
        max_payload = self.config.max_payload
        try:
            payload = {
                "job": handle.job_id,
                "request": wire.encode_request(
                    handle.request, deadline_left_s=deadline_left
                ),
            }
            checkpoint = handle.checkpoint
            if checkpoint is not None:
                # the resume point rides opaque in the SUBMIT (the worker
                # validates it and degrades to a fresh search when it is
                # refused); a job that starts from any checkpoint never
                # deposits into the cache: its search did not cover the
                # space from scratch
                payload["checkpoint"] = checkpoint
                handle._resumed_from_checkpoint = True
            trace_obj = self._trace_dispatch(handle)
            if trace_obj is not None:
                payload["trace"] = trace_obj
            try:
                frame = wire.encode_frame(wire.FrameType.SUBMIT, payload,
                                          max_payload=max_payload)
            except wire.FrameTooLarge:
                if "checkpoint" not in payload:
                    raise
                # an oversized checkpoint must not wedge the job: drop it
                # and dispatch a restart from scratch
                del payload["checkpoint"]
                frame = wire.encode_frame(wire.FrameType.SUBMIT, payload,
                                          max_payload=max_payload)
        except (wire.WireError, ValueError, TypeError) as exc:
            # an unencodable request (oversized, non-finite, ...) fails
            # this one job, never the router thread
            with self._lock:
                worker.assigned.pop(handle.job_id, None)
            handle._finish(JobStatus.FAILED, exception=exc)
            return False
        try:
            with worker.send_lock:
                worker.sock.sendall(frame)
            if obs_metrics.metrics_enabled():
                with self._lock:
                    self._routed_at[handle.job_id] = time.monotonic()
            return True
        except OSError:
            with self._lock:
                if worker.assigned.pop(handle.job_id, None) is None:
                    # a concurrent _worker_lost already took and requeued
                    # this job: it owns the retry
                    return False
                self._retry.append(handle)
            return False

    def _send(self, worker: _Worker, ftype: wire.FrameType,
              obj: Any) -> None:
        if worker.sock is None:
            return
        try:
            frame = wire.encode_frame(ftype, obj,
                                      max_payload=self.config.max_payload)
            with worker.send_lock:
                worker.sock.sendall(frame)
        except OSError:
            pass  # the reader or the watchdog declares the worker lost

    # -- distributed tracing -------------------------------------------

    def _trace_dispatch(self, handle: JobHandle) -> Optional[Dict]:
        """This dispatch's wire trace context (``None``, and no work, with
        tracing off: the SUBMIT frame then has no ``trace`` key).

        The first dispatch opens the job's door-side **root** span (held
        open until :meth:`_trace_settle`) and records ``door:queued``
        under it.  Every dispatch draws the submit-hop flow arrow (``"s"``
        here, ``"f"`` in the worker) and ships a disjoint ``span_base``,
        so a migrated job's second worker never reuses the first's span
        ids."""
        tracer = obs_trace.get_tracer()
        if not tracer.enabled:
            return None
        ctx = handle.trace
        queued_span = None
        now = time.monotonic()
        with self._lock:
            state = self._trace_jobs.get(handle.job_id)
            if state is None:
                root, _ = ctx._open_span()  # closed by _trace_settle
                qid, qparent = ctx._open_span()
                ctx._close_span(qid)
                state = {"root": root, "dispatches": 0, "flow": 0}
                self._trace_jobs[handle.job_id] = state
                queued_span = (qid, qparent)
            state["dispatches"] += 1
            n = state["dispatches"]
            # 16 flow ids a job's pid: 8 dispatches x (submit arrow,
            # result arrow) before ids recycle
            fid = ctx.chrome_pid * 16 + (n & 7) * 2
            state["flow"] = fid
            root = state["root"]
        if queued_span is not None:
            tracer.record_span(
                ctx, "door:queued", "door", handle.submitted_at, now,
                span_id=queued_span[0], parent_id=queued_span[1],
            )
        tracer.flow("s", fid, "submit", ctx=ctx)
        return obs_trace.context_to_wire(
            ctx, parent_span_id=root, span_base=1_000_000 * n,
            flow_id=fid,
        )

    def _trace_settle(self, handle: JobHandle, status: str) -> None:
        """Close the job's door-side trace: the result-hop flow arrow
        (ending the worker's ``"s"``) and the ``door:job`` span the whole
        stitched tree hangs under."""
        with self._lock:
            state = self._trace_jobs.pop(handle.job_id, None)
        tracer = obs_trace.get_tracer()
        if state is None or not tracer.enabled:
            return
        ctx = handle.trace
        tracer.flow("f", state["flow"] + 1, "result", ctx=ctx)
        end = handle.finished_at
        if end is None:
            end = time.monotonic()
        tracer.record_span(
            ctx, "door:job", "door", handle.submitted_at, end,
            span_id=state["root"], parent_id=None,
            status=status, dispatches=state["dispatches"],
        )
        ctx._close_span(state["root"])

    def _ingest_spans(self, worker: _Worker, obj: Dict) -> None:
        """Merge a frame's worker span buffer into the door's tracer,
        rebased onto the door's clock."""
        spans = obj.get("spans") if isinstance(obj, dict) else None
        if not isinstance(spans, dict):
            return
        events_list = spans.get("events")
        if not isinstance(events_list, list):
            return
        n = obs_trace.get_tracer().ingest_remote_events(
            events_list, origin_us=spans.get("origin_us"),
            worker=worker.name,
        )
        if n:
            with self._lock:
                worker.span_events += n

    def _observe_phases(self, handle: JobHandle) -> None:
        """A job's latency split by door phase: ``queued`` (admission to
        SUBMIT), ``routed`` (SUBMIT to the worker's STARTED) and
        ``running`` (STARTED to the end), one labelled histogram family."""
        with self._lock:
            routed_at = self._routed_at.pop(handle.job_id, None)
        if not obs_metrics.metrics_enabled():
            return
        finished = handle.finished_at
        started = handle.started_at
        phases = []
        if routed_at is not None:
            phases.append(("queued", routed_at - handle.submitted_at))
            if started is not None:
                phases.append(("routed", started - routed_at))
        if started is not None and finished is not None:
            phases.append(("running", finished - started))
        reg = obs_metrics.registry()
        for phase, seconds in phases:
            if seconds < 0:
                continue
            reg.histogram(
                "waffle_door_job_phase_seconds",
                service=self.config.name, phase=phase,
            ).observe(seconds)

    # -- worker frames -------------------------------------------------

    def _read_loop(self, worker: _Worker) -> None:
        while True:
            try:
                data = worker.sock.recv(RECV_CHUNK)
            except OSError:
                data = b""
            if not data:
                self._worker_lost(worker, "socket closed")
                return
            self._beats.beat(worker.name)
            try:
                frames = worker.decoder.feed(data)
            except wire.WireError as exc:
                self._worker_lost(worker, f"protocol error: {exc}")
                return
            for ftype, obj in frames:
                try:
                    self._on_frame(worker, ftype, obj)
                except (AttributeError, KeyError, TypeError,
                        ValueError) as exc:
                    # a malformed frame of a known type is the worker's
                    # protocol fault: it is declared lost, its jobs move
                    self._worker_lost(worker, f"malformed {ftype.name} "
                                              f"frame: {exc!r}")
                    return

    def _on_frame(self, worker: _Worker, ftype: wire.FrameType,
                  obj: Any) -> None:
        if ftype is wire.FrameType.STARTED:
            job_id = int(obj["job"])
            with self._lock:
                handle = worker.assigned.get(job_id)
                if handle is not None:
                    worker.started.add(job_id)
            if handle is not None:
                handle._mark_running()
        elif ftype is wire.FrameType.RESULT:
            self._on_result(worker, obj)
        elif ftype is wire.FrameType.ERROR:
            self._on_error(worker, obj)
        elif ftype is wire.FrameType.HEALTH:
            self._apply_health(worker, obj)
        elif ftype is wire.FrameType.CHECKPOINT:
            self._on_checkpoint(worker, obj)
        elif ftype is wire.FrameType.STATS:
            self._on_stats(worker, obj)
        elif ftype is wire.FrameType.INCIDENT:
            self._on_incident(worker, obj)
        elif ftype is wire.FrameType.PONG:
            with self._lock:
                worker.reported_outstanding = int(
                    obj.get("outstanding", 0)
                )
        # HELLO repeats and other valid frames are ignored

    def _on_stats(self, worker: _Worker, obj: Any) -> None:
        """One worker's periodic STATS frame: its metrics snapshot merged
        into the door's registry under a ``worker=`` label, its latest SLO
        windows kept for the stats payload."""
        if not isinstance(obj, dict):
            return
        slo = obj.get("slo")
        with self._lock:
            worker.stats_frames += 1
            worker.stats_at = time.time()
            if isinstance(slo, dict):
                worker.last_slo = slo
        metrics_snap = obj.get("metrics")
        if obs_metrics.metrics_enabled() and isinstance(metrics_snap, dict):
            obs_metrics.registry().merge_snapshot(
                metrics_snap, worker=worker.name
            )
        self._publish_stats()

    def _on_incident(self, worker: _Worker, obj: Any) -> None:
        """A worker's flight incident, re-ingested into the door's
        recorder (fleet-wide dedupe, the worker's name attached, dumped in
        the door's incident directory) and recorded as an event."""
        incident = obj.get("incident") if isinstance(obj, dict) else None
        if not isinstance(incident, dict):
            return
        with self._lock:
            worker.incidents += 1
        stored = obs_flight.ingest_remote(incident, worker=worker.name)
        events.record(
            "worker_incident", worker=worker.name,
            reason=incident.get("reason"),
            trace_id=incident.get("trace_id"),
            deduped=stored is None,
        )
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_door_worker_incidents_total",
                service=self.config.name, worker=worker.name,
            ).inc()
        self._publish_stats()

    def _on_checkpoint(self, worker: _Worker, obj: Any) -> None:
        """Keep the worker's latest snapshot on the door-side handle
        (verbatim, never decoded): the resume point that migration and
        deadline persistence run on."""
        self._ingest_spans(worker, obj)
        try:
            job_id = int(obj["job"])
            data = obj["data"]
            size = int(obj.get("bytes", 0) or 0)
        except (KeyError, TypeError, ValueError):
            return  # a malformed accounting frame is ignored, never fatal
        with self._lock:
            handle = worker.assigned.get(job_id)
            worker.ckpt_frames += 1
            worker.ckpt_bytes += size
        if handle is not None:
            handle._attach_checkpoint(data)
            # a bound-free snapshot is the job's cache deposit candidate:
            # only those resume a read superset exactly
            if self._cache is not None and serve_cache.resumable_wire(data):
                handle._cache_ckpt = data
        if obs_metrics.metrics_enabled():
            reg = obs_metrics.registry()
            labels = {"service": self.config.name, "worker": worker.name}
            reg.counter("waffle_ckpt_snapshots_total", **labels).inc()
            reg.counter("waffle_ckpt_bytes_total", **labels).inc(size)

    def _take_assigned(self, worker: _Worker,
                       job_id: int) -> Optional[JobHandle]:
        with self._lock:
            worker.started.discard(job_id)
            return worker.assigned.pop(job_id, None)

    def _on_result(self, worker: _Worker, obj: Dict) -> None:
        self._ingest_spans(worker, obj)
        handle = self._take_assigned(worker, int(obj["job"]))
        if handle is None:
            return
        try:
            result = wire.decode_result(obj["kind"], obj["result"])
        except (KeyError, wire.WireError) as exc:
            handle._finish(JobStatus.FAILED, exception=exc)
            self._trace_settle(handle, "failed")
            self._observe_phases(handle)
            return
        # deposited before the handle finishes, so a duplicate submitted
        # right after result() finds the entry; the RESULT frame already
        # holds the wire form (no re-encoding)
        if (self._cache is not None
                and not getattr(handle, "_resumed_from_checkpoint", False)):
            try:
                self._cache.deposit_result(handle.request, obj["result"])
                ckpt = getattr(handle, "_cache_ckpt", None)
                if ckpt is not None:
                    self._cache.deposit_checkpoint(handle.request, ckpt)
            except Exception:  # noqa: BLE001 - the cache never fails a job
                pass
        handle._finish(JobStatus.DONE, result=result)
        if handle.latency_s is not None:
            obs_slo.observe_job(handle.latency_s)
        self._trace_settle(handle, "done")
        self._observe_phases(handle)
        self._publish_worker_metrics(worker)
        self._publish_stats()

    def _on_error(self, worker: _Worker, obj: Dict) -> None:
        self._ingest_spans(worker, obj)
        handle = self._take_assigned(worker, int(obj["job"]))
        if handle is None:
            return
        kind = obj.get("kind", "failed")
        message = obj.get("message", "")
        if kind == "cancelled":
            handle._finish(
                JobStatus.CANCELLED, exception=JobCancelled(message)
            )
        elif kind == "expired":
            # deadline persistence: the EXPIRED handle keeps the final
            # checkpoint, so the client resubmits with a fresh budget and
            # loses nothing
            handle._attach_checkpoint(obj.get("checkpoint"))
            handle._finish(
                JobStatus.EXPIRED, exception=DeadlineExceeded(message)
            )
        else:
            handle._finish(
                JobStatus.FAILED,
                exception=RuntimeError(
                    f"worker {worker.name} failed job: "
                    f"{obj.get('type', 'Error')}: {message}"
                ),
            )
        self._trace_settle(handle, kind)
        self._observe_phases(handle)
        self._publish_stats()

    # -- health --------------------------------------------------------

    def _apply_health(self, worker: _Worker, obj: Any) -> None:
        """A forwarded flight trigger of this worker's recorder; the
        connection itself attributes it."""
        reason = obj.get("reason") if isinstance(obj, dict) else None
        trace_id = obj.get("trace") if isinstance(obj, dict) else None
        if reason not in _HEALTH_REASONS:
            # a reason this door does not act on (a newer worker's) is
            # ignored for routing, but counted and recorded: a fleet of
            # mixed versions stays visible
            events.record(
                "door_health_ignored", worker=worker.name,
                reason=str(reason), trace_id=trace_id,
            )
            if obs_metrics.metrics_enabled():
                obs_metrics.registry().counter(
                    "waffle_door_health_ignored_total",
                    service=self.config.name, worker=worker.name,
                    reason=str(reason),
                ).inc()
            return
        with self._lock:
            if self._closed or worker.state == LOST:
                return
            if reason == "backend_demoted":
                worker.demotions += 1
                if worker.state != DRAINING:
                    worker.state = DRAINING
                    events.record(
                        "worker_draining", worker=worker.name,
                        trigger=reason, trace_id=trace_id,
                    )
            else:  # slow_search
                worker.sheds += 1
                if worker.state == UP:
                    worker.state = SHEDDING
                worker.shed_until = (
                    time.monotonic() + self.config.shed_cooldown_s
                )
                events.record(
                    "worker_shedding", worker=worker.name,
                    trigger=reason, trace_id=trace_id,
                )
        self._publish_worker_metrics(worker)

    def _maintain(self) -> None:
        """Health upkeep at each routing decision: re-admit drained
        workers, end lapsed shed cooldowns."""
        now = time.monotonic()
        readmitted = []
        with self._lock:
            for worker in self._workers:
                if worker.state == DRAINING and not worker.assigned:
                    worker.state = UP
                    worker.readmits += 1
                    readmitted.append(worker)
                elif worker.state == SHEDDING and now >= worker.shed_until:
                    worker.state = UP
        for worker in readmitted:
            events.record("worker_readmitted", worker=worker.name)
            self._publish_worker_metrics(worker)

    # -- liveness ------------------------------------------------------

    def _watch_loop(self) -> None:
        while True:
            time.sleep(self.config.ping_s)
            with self._lock:
                if self._closed:
                    return
                workers = [w for w in self._workers if w.state != LOST]
            lapse = self.config.liveness_s
            for worker in workers:
                rc = None
                if worker.proc is not None and hasattr(worker.proc, "poll"):
                    rc = worker.proc.poll()
                if rc is not None:
                    self._worker_lost(
                        worker, f"process exited with code {rc}"
                    )
                    continue
                age = self._beats.age(worker.name)
                if age is not None and age > lapse:
                    self._worker_lost(
                        worker, f"no frames for {age:.1f}s "
                        f"(liveness lapse {lapse:.1f}s)"
                    )
                    continue
                self._send(worker, wire.FrameType.PING, {})

    def _worker_lost(self, worker: _Worker, why: str) -> None:
        """Move one worker to LOST, once: requeue its jobs not yet
        started, **migrate** its started jobs that have a checkpoint (the
        next dispatch carries the resume point), restart the others from
        scratch under ``restart_lost`` or fail them with
        :class:`WorkerLost`, and fire exactly one ``worker_lost`` flight
        incident."""
        with self._lock:
            if self._closed or worker.state == LOST:
                return
            worker.state = LOST
            assigned = dict(worker.assigned)
            started = set(worker.started)
            worker.assigned.clear()
            worker.started.clear()
        _close_socket(worker.sock)
        self._beats.forget(worker.name)
        events.record(
            "worker_lost", worker=worker.name, why=why,
            jobs=len(assigned),
        )
        obs_flight.trigger(
            "worker_lost", trace_id=worker.name, why=why,
            service=self.config.name, jobs_assigned=len(assigned),
        )
        requeued = 0
        migrated = 0
        restarted = 0
        migrated_jobs: List[int] = []
        wasted_s = 0.0
        now = time.monotonic()
        for job_id, handle in sorted(assigned.items()):
            if handle.done():
                continue
            is_migration = (
                job_id in started and self.config.checkpoint_migrate
                and handle.checkpoint is not None
            )
            if job_id not in started or is_migration or \
                    self.config.restart_lost:
                with self._lock:
                    worker.requeues += 1
                    if is_migration:
                        worker.migrations += 1
                    elif job_id in started:
                        worker.restarts += 1
                    self._retry.append(handle)
                requeued += 1
                if is_migration:
                    migrated += 1
                    migrated_jobs.append(job_id)
                    # the work since the last snapshot is all that is
                    # lost: the rest resumes on the next worker
                    at = handle.checkpoint_at
                    if at is not None:
                        wasted_s += max(0.0, now - at)
                elif job_id in started:
                    restarted += 1
                    # a restart forfeits the whole run: drop any stale
                    # checkpoint so the re-dispatch starts from scratch
                    handle._drop_checkpoint()
                    if handle.started_at is not None:
                        wasted_s += max(0.0, now - handle.started_at)
            else:
                handle._finish(
                    JobStatus.FAILED,
                    exception=WorkerLost(
                        f"worker {worker.name} lost ({why}) while "
                        f"running job {job_id}"
                    ),
                )
        if migrated or restarted:
            events.record(
                "worker_jobs_rescued", worker=worker.name,
                migrated=migrated, restarted=restarted,
                migrated_jobs=migrated_jobs,
                wasted_s=round(wasted_s, 6),
            )
        if obs_metrics.metrics_enabled():
            reg = obs_metrics.registry()
            labels = {"service": self.config.name, "worker": worker.name}
            reg.counter("waffle_worker_lost_total", **labels).inc()
            reg.counter(
                "waffle_worker_requeued_total", **labels
            ).inc(requeued)
            if migrated:
                reg.counter(
                    "waffle_ckpt_migrations_total", **labels
                ).inc(migrated)
        self._publish_worker_metrics(worker)
        self._publish_stats()

    # -- observability -------------------------------------------------

    def _publish_worker_metrics(self, worker: _Worker) -> None:
        if not obs_metrics.metrics_enabled():
            return
        reg = obs_metrics.registry()
        labels = {"service": self.config.name, "worker": worker.name}
        with self._lock:
            outstanding = len(worker.assigned)
            state = worker.state
            routed = worker.routed
            demotions = worker.demotions
            sheds = worker.sheds
        reg.gauge("waffle_worker_outstanding", **labels).set(outstanding)
        reg.gauge("waffle_worker_healthy", **labels).set(
            1 if state == UP else 0
        )
        reg.gauge("waffle_worker_routed", **labels).set(routed)
        reg.gauge("waffle_worker_demotions", **labels).set(demotions)
        reg.gauge("waffle_worker_sheds", **labels).set(sheds)

    def worker_stats(self) -> List[Dict]:
        """One row a worker (the ``workers`` table of the stats payload)."""
        out = []
        with self._lock:
            for worker in self._workers:
                outstanding = len(worker.assigned)
                out.append({
                    "worker": worker.name,
                    "pid": worker.pid,
                    "state": worker.state,
                    "outstanding": outstanding,
                    "jobs": sorted(worker.assigned),
                    "started": sorted(worker.started),
                    "slots": worker.slots,
                    "occupancy": (outstanding / worker.slots
                                  if worker.slots else 0.0),
                    "start_s": worker.start_s,
                    "routed": worker.routed,
                    "requeues": worker.requeues,
                    "migrations": worker.migrations,
                    "restarts": worker.restarts,
                    "ckpt_frames": worker.ckpt_frames,
                    "ckpt_bytes": worker.ckpt_bytes,
                    "demotions": worker.demotions,
                    "sheds": worker.sheds,
                    "readmits": worker.readmits,
                    "stats_frames": worker.stats_frames,
                    "stats_at": worker.stats_at,
                    "incidents": worker.incidents,
                    "span_events": worker.span_events,
                    "dispatch_p95_s": (
                        (worker.last_slo.get("dispatch") or {}).get("p95_s")
                        if isinstance(worker.last_slo, dict) else None
                    ),
                })
        return out

    def stats(self) -> Dict:
        """The door's counters and the per-worker table."""
        with self._lock:
            # fold finished handles into the counts and drop them, so the
            # jobs table stays bounded (their trace and phase state too)
            for job_id in [j for j, h in self._jobs.items() if h.done()]:
                self._counts[self._jobs.pop(job_id).status.value] += 1
                self._trace_jobs.pop(job_id, None)
                self._routed_at.pop(job_id, None)
            counts = dict(self._counts)
        workers = self.worker_stats()
        out = {
            "jobs": counts,
            "queue_depth": self._queue.depth(),
            "aged_pops": self._queue.aged_pops,
            "workers": workers,
            "checkpoints": {
                "frames": sum(w["ckpt_frames"] for w in workers),
                "bytes": sum(w["ckpt_bytes"] for w in workers),
                "migrations": sum(w["migrations"] for w in workers),
                "restarts": sum(w["restarts"] for w in workers),
            },
            "fleet": {
                "stats_frames": sum(w["stats_frames"] for w in workers),
                "incidents_forwarded": sum(
                    w["incidents"] for w in workers
                ),
                "span_events": sum(w["span_events"] for w in workers),
            },
        }
        if self._cache is not None:
            out["cache"] = self._cache.stats()
        return out

    def _publish_stats(self, force: bool = False) -> None:
        """With the template's ``stats_file`` set, atomically rewrite it
        (at most every 0.25 s unless ``force``); the payload has a
        top-level ``workers`` table."""
        path = self.config.serve.stats_file
        if not path:
            return
        now = time.monotonic()
        with self._lock:
            if not force and now - self._stats_published_at < 0.25:
                return
            self._stats_published_at = now
        stats = self.stats()
        payload = {
            "service": self.config.name,
            "unix_time": time.time(),
            "stats": stats,
            "workers": stats["workers"],
            "fleet": stats["fleet"],
            "slo": obs_slo.snapshot(),
            "incidents": [
                {k: i.get(k) for k in
                 ("seq", "reason", "trace_id", "unix_time", "path")}
                for i in obs_flight.incidents()[-8:]
            ],
        }
        if obs_metrics.metrics_enabled():
            payload["metrics"] = obs_metrics.registry().snapshot()
        try:
            tmp = f"{path}.tmp-{os.getpid()}"
            with open(tmp, "w") as fh:
                json.dump(payload, fh, default=repr)
            os.replace(tmp, path)
        except OSError:  # a broken stats sink must never fail a job
            pass


def _close_socket(sock: Optional[socket.socket]) -> None:
    """Shut the connection down, then close it: the shutdown wakes a
    thread blocked in ``recv`` on it and sends the peer its end, which a
    bare close does not while that thread holds the socket."""
    if sock is None:
        return
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass
