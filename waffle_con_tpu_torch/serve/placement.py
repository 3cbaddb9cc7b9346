"""Shard placement for admitted jobs: route by read count.

The port of ``waffle_con_tpu``'s ``serve/placement.py``.  The service has
two substrates with opposite sweet spots.  Small jobs amortize launch
overhead by *ganging*: the serving pool (:mod:`waffle_con_tpu_torch.ops.ragged`)
steps many jobs in one launch of the gang kernel.  A single large job has
enough reads to fill a device on its own and goes to the *mesh* instead:
its reads are split over the service's devices
(:class:`~waffle_con_tpu_torch.ops.sharded_scorer.ShardedScorer`, every
co-resident shard of a card in one fused launch of the branch step).
:class:`PlacementPolicy` picks per admitted job.

Promotion happens at admission by rewriting the job's config
(``dataclasses.replace(config, mesh_shards=n)``): ``construct_backend``
then builds the sharded store through
:func:`~waffle_con_tpu_torch.parallel.mesh.shard_for_config`, with no
change to the engines.  The pool refuses a sharded store
(:meth:`~waffle_con_tpu_torch.ops.ragged.BandArena.why_not`, reason
``"sharded"``), so the two substrates stay exclusive.  Results are
byte-identical either way.

The policy never asks for devices that are not there: the shard count is
clamped to the devices available (the service's pinned
:class:`~waffle_con_tpu_torch.parallel.mesh.DeviceSet`, else the local
devices of the job's device type) and to the job's reads, and rounded
down to a power of two so it divides the store's power-of-two read axis.
Below 2 shards the job stays on the pool.  Only ``"torch"`` jobs are
placed: ``mesh_shards`` is a feature of the torch store.

**Learned placement** (``learned=True``, the JAX package's
``WAFFLE_PLACEMENT_LEARNED``): the service appends one
``placement_profile`` record a finished job to the perf database at
``perfdb_path`` (the JAX package's ``WAFFLE_PERFDB``; the port has no
default file, so learning without a path raises ``ValueError``), and
:meth:`PlacementPolicy.classify` compares the rolling medians of the two
substrates' decision seconds in the job's power-of-two reads bucket
(:func:`~waffle_con_tpu_torch.obs.perfdb.decision_seconds`).  The
learned choice applies only when BOTH substrates have at least
:data:`MIN_PROFILE_SAMPLES` records in the bucket; otherwise the static
threshold decides.  The history is re-read only when the file's
(path, mtime, size) stamp changes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import perfdb
from waffle_con_tpu_torch.serve.job import JobRequest

#: both substrates need this many profile records in a job's reads
#: bucket before the learned decision overrides the static threshold
MIN_PROFILE_SAMPLES = 3


def _pow2_floor(n: int) -> int:
    return 1 << (n.bit_length() - 1) if n > 0 else 0


class _ProfileCache:
    """Placement-profile history, cached on the database file's stamp
    ``(path, mtime, size)``: another path, or an append, re-reads it."""

    def __init__(self) -> None:
        self._lock = lockcheck.make_lock("placement.profiles")
        self._stamp: Optional[tuple] = None
        self._records: List[Dict] = []
        self._medians: Dict[int, Dict[str, Dict]] = {}

    def decide(self, path: str, bucket: int) -> Optional[str]:
        """``"mesh"`` / ``"arena"`` when the history of ``path`` is warm
        enough to choose, else ``None`` (the threshold decides)."""
        medians = self._bucket_medians(path, bucket)
        mesh = medians.get("mesh")
        arena = medians.get("arena")
        if (mesh is None or arena is None
                or mesh["n"] < MIN_PROFILE_SAMPLES
                or arena["n"] < MIN_PROFILE_SAMPLES):
            return None
        return "mesh" if mesh["median"] < arena["median"] else "arena"

    def _bucket_medians(self, path: str, bucket: int) -> Dict[str, Dict]:
        try:
            st = os.stat(path)
            stamp = (path, st.st_mtime_ns, st.st_size)
        except OSError:
            stamp = (path, None, None)
        with self._lock:
            if stamp != self._stamp:
                self._records = perfdb.load_records(
                    path, kind=perfdb.PLACEMENT_KIND
                )
                self._medians = {}
                self._stamp = stamp
            if bucket not in self._medians:
                self._medians[bucket] = perfdb.substrate_medians(
                    self._records, bucket
                )
            return self._medians[bucket]

    def reset(self) -> None:
        with self._lock:
            self._stamp = None
            self._records = []
            self._medians = {}


_PROFILES = _ProfileCache()


def reset_profile_cache() -> None:
    """Drop the cached placement-profile history."""
    _PROFILES.reset()


def record_outcome(substrate: str, n_reads: int, wall_s: float,
                   phases: Optional[Dict[str, float]] = None,
                   path: Optional[str] = None) -> str:
    """Append one ``placement_profile`` record for a finished job to the
    database at ``path`` (``ValueError`` without one); returns the
    path."""
    extra: Dict = {
        "substrate": substrate,
        "n_reads": int(n_reads),
        "reads_bucket": perfdb.reads_bucket(n_reads),
    }
    if phases:
        extra["phases"] = {k: round(float(v), 6)
                           for k, v in phases.items()}
    record = perfdb.make_record(
        perfdb.PLACEMENT_KIND, f"job_wall_s_{substrate}",
        round(float(wall_s), 6), "s", **extra,
    )
    return perfdb.append_record(record, path)


@dataclasses.dataclass(frozen=True)
class PlacementPolicy:
    """Classify admitted jobs by read count and pick their substrate.

    * ``large_read_threshold`` — jobs with at least this many reads are
      mesh candidates; smaller jobs stay on the serving pool.
    * ``mesh_shards`` — read shards asked for a promoted job (clamped to
      the devices available at placement, power-of-two floored).
    * ``learned`` — learn mesh-vs-pool routing from the placement
      profiles in ``perfdb_path`` (and append one a finished job).
    * ``perfdb_path`` — the perf database file; required with
      ``learned``.
    """

    large_read_threshold: int = 64
    mesh_shards: int = 2
    learned: bool = False
    perfdb_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.large_read_threshold < 1:
            raise ValueError("large_read_threshold must be >= 1")
        if self.mesh_shards < 2:
            raise ValueError(
                "mesh_shards must be >= 2 (1 shard is just the "
                "unsharded engine; use placement=None instead)"
            )
        if self.learned and not self.perfdb_path:
            raise ValueError(
                "learned placement needs perfdb_path (the port has no "
                "default perf database)"
            )

    def classify(self, request: JobRequest) -> str:
        """``"mesh"`` or ``"arena"`` for one job.  Learned: the substrate
        with the lower rolling median of decision seconds in the job's
        reads bucket, when both have :data:`MIN_PROFILE_SAMPLES` records
        there; otherwise (and not learned) the static
        ``large_read_threshold``."""
        n_reads = len(request.reads)
        if self.learned:
            learned = _PROFILES.decide(os.fspath(self.perfdb_path),
                                       perfdb.reads_bucket(n_reads))
            if learned is not None:
                return learned
        return (
            "mesh" if n_reads >= self.large_read_threshold
            else "arena"
        )

    def effective_shards(self, n_reads: int, available_devices: int) -> int:
        """The shards a promoted job gets: the policy's ask, clamped to
        the devices and to the job's reads, power-of-two floored.  Below
        2: no promotion."""
        return _pow2_floor(
            min(self.mesh_shards, available_devices, max(n_reads, 0))
        )

    def place(self, request: JobRequest,
              available_devices: int) -> Optional[JobRequest]:
        """The mesh-promoted request, or ``None`` to leave the job on the
        pool.  Declines a small job, a job without a config or not on the
        ``"torch"`` backend, a job whose config already names a shard
        count (the caller's choice wins), and too few devices for 2
        shards."""
        if self.classify(request) != "mesh":
            return None
        config = request.config
        if config is None or getattr(config, "backend", None) != "torch":
            return None
        if getattr(config, "mesh_shards", 0):
            return None
        shards = self.effective_shards(len(request.reads),
                                       available_devices)
        if shards < 2:
            return None
        return dataclasses.replace(
            request, config=dataclasses.replace(config, mesh_shards=shards)
        )
