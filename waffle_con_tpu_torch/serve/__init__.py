"""Multi-tenant consensus serving with cross-job batching.

The port of ``waffle_con_tpu``'s ``serve`` package:

* :class:`~waffle_con_tpu_torch.serve.service.ConsensusService` —
  accepts many independent jobs (single, dual, priority), a bounded
  admission queue with reject-on-full backpressure, priority scheduling
  (FIFO within a class, with aging), per-job deadlines and cancellation
  enforced at every scorer call, graceful or shedding shutdown.
* :class:`~waffle_con_tpu_torch.serve.dispatcher.BatchingDispatcher` —
  the cross-job coalescing point: concurrent jobs' blocking scorer calls
  are collected within a bounded batching window, their ``run_extend``
  calls ganged across jobs into launches of the gang kernel through the
  serving pool (:mod:`waffle_con_tpu_torch.ops.ragged`; an exhausted pool
  raises the typed :class:`~waffle_con_tpu_torch.ops.ragged.ArenaExhausted`
  internally and degrades to the bucketed path), the rest grouped by
  shape bucket and run by a single dispatcher thread (direct
  fall-through when a job is alone).  Results are byte-identical to
  serial execution.
* :class:`~waffle_con_tpu_torch.serve.dispatcher.CoalescingScorer` —
  the per-job transparent scorer proxy that routes calls into the shared
  dispatcher.
* :class:`~waffle_con_tpu_torch.serve.placement.PlacementPolicy` — routes
  a large ``"torch"`` job at admission to a read-sharded store over the
  service's devices instead of the serving pool (static threshold, or
  learned from perf-database profiles).
* :class:`~waffle_con_tpu_torch.serve.replicas.ReplicatedService` — N
  services, each with its own dispatcher, pool and device slice, behind
  one least-outstanding, health-aware door.
* :class:`~waffle_con_tpu_torch.serve.cache.ConsensusCache` — the
  content-addressed consensus cache (``ServeConfig.cache``): exact hits
  and certified near-misses served without a search (``CACHED``,
  ``CERTIFIED``), read supersets resumed from a cached bound-free
  checkpoint, results optionally kept in hash-sealed files.
* :class:`~waffle_con_tpu_torch.serve.procs.door.ProcFrontDoor` — the
  out-of-process front door: N worker processes
  (``python -m waffle_con_tpu_torch.serve.procs.worker``), each one
  service with its own GIL and CUDA context, behind admission, routing,
  health and liveness, a lost worker's started jobs migrating with their
  latest checkpoint; :mod:`~waffle_con_tpu_torch.serve.procs.wire` is
  its wire codec (frames, and the config, request and result codecs the
  cache stores results in).
"""

from waffle_con_tpu_torch.ops.ragged import ArenaExhausted
from waffle_con_tpu_torch.runtime.watchdog import DeadlineExceeded
from waffle_con_tpu_torch.serve.dispatcher import (
    BatchingDispatcher,
    CoalescingScorer,
    bucket_key,
)
from waffle_con_tpu_torch.serve.job import (
    JobCancelled,
    JobHandle,
    JobRequest,
    JobStatus,
    ServeError,
    ServiceClosed,
    ServiceOverloaded,
)
from waffle_con_tpu_torch.serve.placement import PlacementPolicy
from waffle_con_tpu_torch.serve.procs.door import ProcConfig, ProcFrontDoor
from waffle_con_tpu_torch.serve.replicas import (
    ReplicatedConfig,
    ReplicatedService,
)
from waffle_con_tpu_torch.serve.scheduler import AdmissionQueue, WorkerPool
from waffle_con_tpu_torch.serve.service import ConsensusService, ServeConfig

__all__ = [
    "AdmissionQueue",
    "ArenaExhausted",
    "BatchingDispatcher",
    "CoalescingScorer",
    "ConsensusService",
    "DeadlineExceeded",
    "JobCancelled",
    "JobHandle",
    "JobRequest",
    "JobStatus",
    "PlacementPolicy",
    "ProcConfig",
    "ProcFrontDoor",
    "ReplicatedConfig",
    "ReplicatedService",
    "ServeConfig",
    "ServeError",
    "ServiceClosed",
    "ServiceOverloaded",
    "WorkerPool",
    "bucket_key",
]
