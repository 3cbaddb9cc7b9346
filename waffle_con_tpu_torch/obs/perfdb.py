"""Persistent performance history: an append-only JSONL perf database.

The port of ``waffle_con_tpu``'s ``obs/perfdb.py``, with its record
schema: a file written by either package reads the same in the other.

Records are one JSON object per line::

    {"schema": 1, "kind": "microbench", "unix_time": ..., "host": ...,
     "metric": ..., "value": 1063.2, "unit": "steps/s", ...}

``schema`` is the record major; readers skip records with a LARGER major
than they understand (forward-written history must not brick an older
reader) and tolerate unparsable lines (a torn write from a killed run
must not poison the database).

The port reads no environment variable and has no default database
path: every write and read names its file (the JAX package's
``WAFFLE_PERFDB`` is the ``path`` argument here, and
:class:`~waffle_con_tpu_torch.serve.placement.PlacementPolicy`'s
``perfdb_path`` field).  A call without a path raises ``ValueError``.

The module also carries the bench evidence-line contract
(:data:`EVIDENCE_SCHEMA`, :func:`stamp_evidence`, :func:`load_evidence`
and the per-mode tables), so the port reads the JAX package's evidence
lines by the same rules.
"""

from __future__ import annotations

import json
import os
import platform as _platform
import time
from typing import Dict, List, Optional, Tuple

#: perfdb record major: bump ONLY on a field-meaning change readers
#: cannot tolerate; additive fields do not bump it
SCHEMA = 1

#: bench evidence-line major (the ``"schema"`` field of every evidence
#: line; a line without one parses as 1, the unversioned format)
EVIDENCE_SCHEMA = 2

#: record kind of per-job placement outcomes (the learned placement of
#: :mod:`waffle_con_tpu_torch.serve.placement` reads these)
PLACEMENT_KIND = "placement_profile"

#: evidence fields every mode must carry
EVIDENCE_REQUIRED = ("metric", "value", "unit", "schema")

#: per-mode required evidence fields (the JAX package's table)
EVIDENCE_MODE_FIELDS: Dict[str, Tuple[str, ...]] = {
    "serve": (
        "jobs", "jobs_per_s", "parity", "p50_job_latency_s",
        "p95_job_latency_s", "serve_stats", "mean_batch_occupancy",
        "slo", "incidents",
    ),
    "serve-mix": (
        "parity", "ragged_occupancy", "compiles_ragged",
        "ragged_stats", "bucketed_run_occupancy", "jobs_per_s_ragged",
        "mixed_w",
    ),
    "storm": (
        "parity", "jobs_per_s", "jobs_per_s_single",
        "speedup_vs_single", "p95_job_latency_s", "p99_job_latency_s",
        "replicas", "per_replica", "mesh_placed", "shed",
    ),
    "storm-procs": (
        "parity", "procs", "jobs_per_s", "jobs_per_s_single",
        "speedup_vs_single", "p95_job_latency_s", "p99_job_latency_s",
        "per_worker", "workers_participating", "requeues",
        "worker_lost_incidents", "mesh_placed", "fleet",
    ),
    "storm-procs-ckpt": (
        "parity", "procs", "jobs_per_s", "per_worker",
        "worker_lost_incidents", "checkpoints", "migrated",
        "restarted_started", "wasted_work_s", "migration_jobs",
        "fleet",
    ),
    "storm-cache": (
        "parity", "jobs_per_s", "hit_rate", "cache_hits", "cache",
        "exact_hits_dispatch_free", "checkpoint_hits_all_iters",
        "checkpoint_jobs", "resumed_wall_total_s",
        "scratch_wall_total_s", "statuses", "slo", "incidents",
    ),
    "microbench": ("parity", "steps", "stop_code", "breakdown"),
    "north-star": ("parity", "vs_baseline", "breakdown"),
}


def _need_path(path: Optional[str]) -> str:
    if not path:
        raise ValueError(
            "the perf database needs a path (the port has no default "
            "database file)"
        )
    return os.fspath(path)


def make_record(kind: str, metric: str, value: float, unit: str,
                **extra) -> Dict:
    """A schema-stamped record; ``extra`` fields ride along verbatim
    (``phases``, ``substrate``, ``reads_bucket``, ...)."""
    rec = {
        "schema": SCHEMA,
        "kind": kind,
        "unix_time": round(time.time(), 3),
        "host": _platform.node() or "unknown",
        "machine": _platform.machine() or "unknown",
        "metric": metric,
        "value": value,
        "unit": unit,
    }
    rec.update(extra)
    return rec


def append_record(record: Dict, path: Optional[str]) -> str:
    """Append one record (newline-delimited JSON) to the database at
    ``path``, creating its directory on first write; returns the path.
    Raises ``ValueError`` without a path or for a record of another
    schema major."""
    if int(record.get("schema", 0)) != SCHEMA:
        raise ValueError(
            f"refusing to write schema {record.get('schema')!r} "
            f"record (writer is schema {SCHEMA})"
        )
    path = _need_path(path)
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a") as fh:
        fh.write(json.dumps(record, sort_keys=True) + "\n")
    return path


def load_records(path: Optional[str],
                 kind: Optional[str] = None) -> List[Dict]:
    """Parse the database at ``path``, oldest first (a missing file is
    empty).  Unparsable lines, non-objects and records of a NEWER major
    than :data:`SCHEMA` (or below 1) are skipped; ``kind`` filters to one
    record kind.  Raises ``ValueError`` without a path."""
    path = _need_path(path)
    out: List[Dict] = []
    try:
        with open(path) as fh:
            lines = fh.readlines()
    except OSError:
        return out
    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        try:
            major = int(rec.get("schema", 0))
        except (TypeError, ValueError):
            continue
        if major > SCHEMA or major < 1:
            continue
        if kind is not None and rec.get("kind") != kind:
            continue
        out.append(rec)
    return out


def _median(values: List[float]) -> float:
    values = sorted(values)
    n = len(values)
    mid = n // 2
    return values[mid] if n % 2 else (values[mid - 1] + values[mid]) / 2


def rolling_baseline(records: List[Dict], metric: Optional[str] = None,
                     window: int = 10) -> Optional[float]:
    """Median ``value`` of the last ``window`` numeric records
    (optionally of one metric); ``None`` without usable history."""
    values = [
        float(r["value"]) for r in records
        if isinstance(r.get("value"), (int, float))
        and (metric is None or r.get("metric") == metric)
    ][-window:]
    return _median(values) if values else None


# -- placement profiles (serve/placement.py learned routing) ----------


def reads_bucket(n_reads: int) -> int:
    """The power-of-two bucket a placement profile is keyed by (the
    stores' rounding of their read axis)."""
    n = max(int(n_reads), 1)
    return 1 << (n - 1).bit_length()


def decision_seconds(record: Dict) -> Optional[float]:
    """The seconds a placement decision compares for one profile record:
    ``host_prep + device_compute + transfer`` from its ``phases`` when
    all three are there, else the job wall in ``value``; ``None`` for a
    record with neither."""
    phases = record.get("phases")
    if isinstance(phases, dict):
        parts = [phases.get(k)
                 for k in ("host_prep", "device_compute", "transfer")]
        if all(isinstance(p, (int, float)) for p in parts):
            return float(sum(parts))
    value = record.get("value")
    return float(value) if isinstance(value, (int, float)) else None


def substrate_medians(records: List[Dict], bucket: int,
                      window: int = 32) -> Dict[str, Dict]:
    """Rolling per-substrate medians of the decision seconds in one reads
    bucket: ``{"mesh": {"n": ..., "median": ...}, "arena": {...}}``, an
    absent substrate left out; the last ``window`` records of each
    count."""
    out: Dict[str, Dict] = {}
    for substrate in ("mesh", "arena"):
        values = [
            s for s in (
                decision_seconds(r) for r in records
                if r.get("kind") == PLACEMENT_KIND
                and r.get("substrate") == substrate
                and r.get("reads_bucket") == bucket
            ) if s is not None
        ][-window:]
        if values:
            out[substrate] = {"n": len(values), "median": _median(values)}
    return out


# -- bench evidence schema --------------------------------------------


def stamp_evidence(out: Dict) -> Dict:
    """Stamp an evidence line with the current schema major."""
    out["schema"] = EVIDENCE_SCHEMA
    return out


def load_evidence(line_or_dict) -> Dict:
    """Parse and validate one evidence line.

    Raises ``ValueError`` for unparsable JSON, a non-object, an unknown
    (newer) or nonsense major, or a line of major 2 or more missing the
    cross-mode or its mode's required fields.  A missing ``schema``
    parses as major 1 and skips the field checks."""
    if isinstance(line_or_dict, str):
        evidence = json.loads(line_or_dict)
    else:
        evidence = dict(line_or_dict)
    if not isinstance(evidence, dict):
        raise ValueError("evidence line is not a JSON object")
    major = int(evidence.get("schema", 1))
    if major > EVIDENCE_SCHEMA:
        raise ValueError(
            f"evidence schema {major} is newer than this reader "
            f"(max {EVIDENCE_SCHEMA}); refusing to guess"
        )
    if major < 1:
        raise ValueError(f"nonsense evidence schema {major}")
    if major >= 2:
        missing = [k for k in EVIDENCE_REQUIRED if k not in evidence]
        if missing:
            raise ValueError(f"evidence line missing {missing}")
        mode = evidence.get("mode")
        for key in EVIDENCE_MODE_FIELDS.get(mode, ()):
            if key not in evidence:
                raise ValueError(
                    f"mode {mode!r} evidence missing {key!r}"
                )
    return evidence
