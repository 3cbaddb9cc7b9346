"""Replicated front door: N in-process serve replicas behind one door.

The port of ``waffle_con_tpu``'s ``serve/replicas.py``.  Each replica is
a full :class:`~waffle_con_tpu_torch.serve.service.ConsensusService` —
its own admission queue, batching dispatcher (one thread: the replicas'
dispatchers launch at the same time, on one card or several), serving
pool (:func:`~waffle_con_tpu_torch.ops.ragged.new_arena`) and worker
pool — pinned to a :class:`~waffle_con_tpu_torch.parallel.mesh.DeviceSet`
slice of ``ReplicatedConfig.devices``.  :class:`ReplicatedService` is the
shared admission point in front of them:

* **least-outstanding routing** — every submit goes to the healthy
  replica with the fewest admitted-but-unfinished jobs; a replica at its
  admission limit overflows to the next instead of rejecting the client.
* **health-driven shedding** — the door listens to the flight recorder's
  trigger stream (:func:`~waffle_con_tpu_torch.obs.flight.add_trigger_listener`).
  A ``backend_demoted`` on a replica puts it in ``draining``: no new
  admissions until its outstanding work reaches zero, then it re-admits.
  A ``slow_search`` puts it in ``shedding`` for ``shed_cooldown_s``:
  routing prefers the others meanwhile.  When every replica is unhealthy
  the door falls back to plain least-outstanding.
* **per-replica observability** — ``waffle_replica_*`` gauges, a
  ``replicas`` table in the stats file (``base.stats_file``, written by
  the door alone: the members have none) and a runtime event at every
  state transition.

Results stay byte-identical to serial execution: each job runs on exactly
one replica.

``devices`` is the port's explicit counterpart of the JAX package's
topology probe: by default the local CUDA devices, and a host without one
raises (there is no device-less fallback).  A device may be listed more
than once: ``("cuda:0",) * 4`` gives two replicas two co-resident shards
each on one card, ``("cpu", "cpu")`` two CPU replicas.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import slo as obs_slo
from waffle_con_tpu_torch.ops import ragged as ops_ragged
from waffle_con_tpu_torch.runtime import events
from waffle_con_tpu_torch.serve.job import (
    JobHandle,
    JobRequest,
    ServiceClosed,
    ServiceOverloaded,
)
from waffle_con_tpu_torch.serve.service import ConsensusService, ServeConfig

#: replica states
UP = "up"
DRAINING = "draining"    # circuit-break: no admissions until drained
SHEDDING = "shedding"    # latency flag: deprioritized for a cooldown

#: flight-trigger reasons the health listener acts on
_HEALTH_REASONS = ("backend_demoted", "slow_search")


@dataclasses.dataclass(frozen=True)
class ReplicatedConfig:
    """Front-door knobs.

    * ``replicas`` — member services; each gets its own dispatcher,
      serving pool, worker pool and device slice.
    * ``base`` — the members' :class:`ServeConfig` template (each is
      named ``<name>:r<i>`` and has no stats file: the door writes
      ``base.stats_file``).
    * ``name`` — the door's name.
    * ``shed_cooldown_s`` — how long a ``slow_search``-flagged replica
      stays deprioritized.
    * ``devices`` — the devices sliced over the replicas
      (:func:`~waffle_con_tpu_torch.parallel.mesh.device_slices`; a
      device may repeat); ``None``: the local CUDA devices.
    """

    replicas: int = 2
    base: Optional[ServeConfig] = None
    name: str = "consensus"
    shed_cooldown_s: float = 2.0
    devices: Optional[Tuple[Any, ...]] = None

    def __post_init__(self) -> None:
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.shed_cooldown_s < 0:
            raise ValueError("shed_cooldown_s must be >= 0")
        if self.devices is not None:
            if not self.devices:
                raise ValueError("devices is empty")
            object.__setattr__(self, "devices", tuple(self.devices))


class _Replica:
    """Mutable per-replica record (state guarded by the door's lock)."""

    __slots__ = ("index", "name", "service", "arena", "device_set",
                 "state", "shed_until", "routed", "demotions", "sheds",
                 "readmits")

    def __init__(self, index: int, name: str, service: ConsensusService,
                 arena, device_set) -> None:
        self.index = index
        self.name = name
        self.service = service
        self.arena = arena
        self.device_set = device_set
        self.state = UP
        self.shed_until = 0.0
        self.routed = 0
        self.demotions = 0
        self.sheds = 0
        self.readmits = 0


class ReplicatedService:
    """N serve replicas behind least-outstanding, health-aware routing.

    Usage::

        door = ReplicatedService(ReplicatedConfig(
            replicas=2, devices=("cuda:0",) * 4,
            base=ServeConfig(placement=PlacementPolicy())))
        with door:
            handles = door.submit_all(requests)
            results = [h.result(timeout=600) for h in handles]
    """

    def __init__(
        self,
        config: Optional[ReplicatedConfig] = None,
        autostart: bool = True,
    ) -> None:
        self.config = config if config is not None else ReplicatedConfig()
        base = (self.config.base if self.config.base is not None
                else ServeConfig())
        self._stats_file = base.stats_file
        self._lock = lockcheck.make_lock("serve.replicas.ReplicatedService")
        self._closed = False
        self._stats_published_at = 0.0
        slices = self._device_slices(self.config.replicas,
                                     self.config.devices)
        self._replicas: List[_Replica] = []
        for i in range(self.config.replicas):
            rname = f"{self.config.name}:r{i}"
            arena = ops_ragged.new_arena(rname, base.arena_config())
            service = ConsensusService(
                dataclasses.replace(base, name=rname, stats_file=None),
                autostart=False,
                arena=arena,
                device_set=slices[i],
            )
            self._replicas.append(
                _Replica(i, rname, service, arena, slices[i])
            )
        obs_flight.add_trigger_listener(self._on_trigger)
        if autostart:
            self.start()

    @staticmethod
    def _device_slices(n: int, devices: Optional[Sequence[Any]]) -> List:
        """The replicas' device sets: ``devices`` (default: the local
        CUDA devices, raising when there is none) sliced ``n`` ways."""
        from waffle_con_tpu_torch.parallel import mesh as par_mesh

        if devices is None:
            devices = par_mesh.local_devices("cuda")
            if not devices:
                raise ValueError(
                    "ReplicatedConfig.devices is None and this host has no "
                    "CUDA device: name the devices, e.g. ('cpu', 'cpu')"
                )
        return par_mesh.device_slices(n, devices, name_prefix="replica")

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        for rep in self._replicas:
            rep.service.start()

    def close(
        self, cancel_pending: bool = False, timeout: Optional[float] = None
    ) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        obs_flight.remove_trigger_listener(self._on_trigger)
        for rep in self._replicas:
            rep.service.close(cancel_pending=cancel_pending,
                              timeout=timeout)
        for rep in self._replicas:
            ops_ragged.drop_arena(rep.name)

    def __enter__(self) -> "ReplicatedService":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    # -- health --------------------------------------------------------

    def _on_trigger(self, reason: str, trace_id: Optional[str],
                    detail: Dict) -> None:
        """Flight-trigger listener: attribute a health signal to a
        replica by trace-id prefix (job trace ids are
        ``<replica name>/job-<id>``) and move its state."""
        if reason not in _HEALTH_REASONS or not trace_id:
            return
        rep = next(
            (r for r in self._replicas
             if trace_id.startswith(r.name + "/")), None,
        )
        if rep is None:
            return
        with self._lock:
            if self._closed:
                return
            if reason == "backend_demoted":
                rep.demotions += 1
                if rep.state != DRAINING:
                    rep.state = DRAINING
                    events.record(
                        "replica_draining", replica=rep.name,
                        trigger=reason, trace_id=trace_id,
                    )
            else:  # slow_search
                rep.sheds += 1
                if rep.state == UP:
                    rep.state = SHEDDING
                rep.shed_until = (
                    time.monotonic() + self.config.shed_cooldown_s
                )
                events.record(
                    "replica_shedding", replica=rep.name,
                    trigger=reason, trace_id=trace_id,
                )
        self._publish_replica_metrics(rep)

    def _maintain(self) -> None:
        """Health upkeep at each routing decision: re-admit drained
        replicas, end expired shed cooldowns."""
        now = time.monotonic()
        readmitted = []
        with self._lock:
            for rep in self._replicas:
                if rep.state == DRAINING \
                        and rep.service.outstanding() == 0:
                    rep.state = UP
                    rep.readmits += 1
                    readmitted.append(rep)
                elif rep.state == SHEDDING and now >= rep.shed_until:
                    rep.state = UP
                    events.record("replica_shed_ended", replica=rep.name)
        for rep in readmitted:
            events.record("replica_readmitted", replica=rep.name)
            self._publish_replica_metrics(rep)

    # -- client API ----------------------------------------------------

    def _try(self, reps: Sequence[_Replica], request: JobRequest):
        """Submit to the first of ``reps`` that admits: ``(handle,
        None)``, or ``(None, the last rejection)``."""
        last_exc: Optional[ServiceOverloaded] = None
        for rep in reps:
            try:
                handle = rep.service.submit(request)
            except ServiceOverloaded as exc:
                last_exc = exc
                continue
            with self._lock:
                rep.routed += 1
            self._publish_replica_metrics(rep)
            self._publish_stats()
            return handle, None
        return None, last_exc

    def submit(self, request: JobRequest) -> JobHandle:
        """Route one job to the least-outstanding healthy replica.

        Draining and shedding replicas are skipped while a healthy one
        admits; a full replica overflows to the next, the healthy tier
        first, then the rest.  Raises :class:`ServiceOverloaded` only
        when EVERY replica rejected."""
        with self._lock:
            if self._closed:
                raise ServiceClosed("service is closed to new jobs")
        self._maintain()
        with self._lock:
            ranked = sorted(
                self._replicas,
                key=lambda r: (0 if r.state == UP else 1,
                               r.service.outstanding(), r.index),
            )
        healthy = [r for r in ranked if r.state == UP]
        # no healthy replica: degraded least-outstanding beats rejecting
        handle, last_exc = self._try(healthy or ranked, request)
        if handle is None and healthy and len(healthy) < len(ranked):
            # the healthy tier is full: overflow onto the others
            handle, exc = self._try(
                [r for r in ranked if r not in healthy], request)
            last_exc = exc or last_exc
        if handle is not None:
            return handle
        raise last_exc if last_exc is not None else ServiceOverloaded(
            "no replica accepted the job"
        )

    def submit_all(self, requests: Sequence[JobRequest]) -> List[JobHandle]:
        return [self.submit(r) for r in requests]

    # -- observability -------------------------------------------------

    def _publish_replica_metrics(self, rep: _Replica) -> None:
        if not obs_metrics.metrics_enabled():
            return
        reg = obs_metrics.registry()
        labels = {"service": self.config.name, "replica": rep.name}
        reg.gauge("waffle_replica_outstanding", **labels).set(
            rep.service.outstanding()
        )
        reg.gauge("waffle_replica_healthy", **labels).set(
            1 if rep.state == UP else 0
        )
        reg.gauge("waffle_replica_routed", **labels).set(rep.routed)
        reg.gauge("waffle_replica_demotions", **labels).set(rep.demotions)
        reg.gauge("waffle_replica_sheds", **labels).set(rep.sheds)

    def replica_stats(self) -> List[Dict]:
        """Per-replica snapshot (the ``replicas`` table of the stats
        file and of :meth:`stats`)."""
        out = []
        with self._lock:
            reps = list(self._replicas)
            states = {r.name: r.state for r in reps}
        for rep in reps:
            svc_stats = rep.service.stats()
            dispatch = svc_stats.get("dispatch", {})
            out.append({
                "replica": rep.name,
                "state": states[rep.name],
                "outstanding": rep.service.outstanding(),
                "queue_depth": svc_stats.get("queue_depth", 0),
                "routed": rep.routed,
                "demotions": rep.demotions,
                "sheds": rep.sheds,
                "readmits": rep.readmits,
                "jobs": svc_stats.get("jobs", {}),
                "mean_batch_occupancy": dispatch.get(
                    "mean_batch_occupancy", 0.0
                ),
                "ragged_mean_occupancy": dispatch.get(
                    "ragged_mean_occupancy", 0.0
                ),
                "last_hold_ms": dispatch.get("last_hold_ms"),
                "devices": [str(d) for d in rep.device_set.devices],
            })
        return out

    def stats(self) -> Dict:
        """The members' job counters summed, queue depth and aged pops,
        and the per-replica table."""
        agg: Dict[str, int] = {}
        queue_depth = 0
        aged_pops = 0
        per_replica = self.replica_stats()
        for rep in self._replicas:
            svc_stats = rep.service.stats()
            for key, val in svc_stats.get("jobs", {}).items():
                agg[key] = agg.get(key, 0) + int(val)
            queue_depth += svc_stats.get("queue_depth", 0)
            aged_pops += svc_stats.get("aged_pops", 0)
        return {
            "jobs": agg,
            "queue_depth": queue_depth,
            "aged_pops": aged_pops,
            "replicas": per_replica,
        }

    def outstanding(self) -> int:
        return sum(r.service.outstanding() for r in self._replicas)

    def _publish_stats(self) -> None:
        """With ``base.stats_file`` set, atomically rewrite it (at most
        every 0.25 s, as a single service does); the payload gains a
        top-level ``replicas`` table."""
        path = self._stats_file
        if not path:
            return
        now = time.monotonic()
        with self._lock:
            if now - self._stats_published_at < 0.25:
                return
            self._stats_published_at = now
        stats = self.stats()
        payload = {
            "service": self.config.name,
            "unix_time": time.time(),
            "stats": stats,
            "replicas": stats["replicas"],
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
