"""Always-on flight recorder: bounded in-memory ring + incident dumps.

The port of ``waffle_con_tpu``'s ``obs/flight.py``.  When one of many
concurrent jobs blows its deadline, demotes a backend, or trips the
admission queue, the operator needs that job's recent timeline *without
having pre-enabled tracing*.  The recorder therefore runs always-on and
lock-cheap — a fixed-size ``collections.deque`` ring of pre-rendered
tuples (``deque.append`` with ``maxlen`` is atomic under the GIL, so
the hot recording path takes no lock and allocates one small tuple per
record) — and only does real work when an **anomaly trigger** fires.

Triggers (see :data:`TRIGGER_REASONS`): ``deadline_exceeded``,
``backend_demoted``, ``service_overloaded``,
``watchdog_budget_exceeded``, the SLO layer's ``slow_search`` (current
search > k x rolling p95, :mod:`waffle_con_tpu_torch.obs.slo`),
``checkpoint_rejected``, the consensus cache's ``cache_quarantine`` (a
corrupt stored entry moved aside) and the lock checker's
``lock_order_inversion``.

On a trigger the recorder assembles a self-contained JSON **incident**:
the triggering job's records (filtered from the ring by trace id),
the recent ring tail, the runtime event log, a metrics snapshot (when
metrics are on), and the rolling SLO snapshot.  Incidents stay in
memory (:meth:`FlightRecorder.incidents`) unless a directory is set
with :func:`set_incident_dir` (or ``ServeConfig.flight_dir``): then each
is also written to ``<dir>/incident-<seq>-<reason>.json`` (atomic
rename).  The port reads no environment variable.

Incidents are deduplicated on ``(reason, trace_id)`` within a rolling
time window (default 300 s; 0 disables dedupe; :func:`configure`) —
a retry storm produces one dump, not hundreds, but a recurring incident
re-fires once the window expires.  The ring holds 2,048 records by
default.  Trigger listeners (:func:`add_trigger_listener`) see every
trigger before dedupe: the replicated front door
(:mod:`waffle_con_tpu_torch.serve.replicas`) drains and sheds replicas
from them.

Overhead: the engines' scorer calls make no call into this module
(recording happens at the serve layer's dispatch and job boundaries and
at anomaly sites); a record is one deque append.
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from waffle_con_tpu_torch.analysis import lockcheck

#: every reason :func:`trigger` is called with somewhere in the codebase
TRIGGER_REASONS = (
    "deadline_exceeded",
    "backend_demoted",
    "cache_quarantine",
    "service_overloaded",
    "watchdog_budget_exceeded",
    "slow_search",
    "checkpoint_rejected",
    "lock_order_inversion",
)

DEFAULT_RING_SIZE = 2048
#: in-memory incident cap (dumped files are bounded by dedupe instead)
MAX_INCIDENTS = 64
INCIDENT_SCHEMA = "waffle-flight-incident/1"
#: default (reason, trace_id) dedupe window in seconds
DEFAULT_DEDUPE_S = 300.0


#: process settings, changed in code only (:func:`configure`,
#: :func:`set_incident_dir`)
_SETTINGS = {"ring": DEFAULT_RING_SIZE, "dedupe_s": DEFAULT_DEDUPE_S,
             "dir": None}


def configure(ring_size: Optional[int] = None,
              dedupe_s: Optional[float] = None) -> None:
    """Set the ring size of recorders built after the call (at least
    16) and the dedupe window (seconds, 0 disables dedupe); ``None``
    leaves a setting as it is."""
    if ring_size is not None:
        _SETTINGS["ring"] = max(16, int(ring_size))
    if dedupe_s is not None:
        if dedupe_s < 0:
            raise ValueError("dedupe_s must be >= 0")
        _SETTINGS["dedupe_s"] = float(dedupe_s)


def set_incident_dir(path: Optional[str]) -> Optional[str]:
    """Write each incident to ``path`` as well (``None``: memory only,
    the default); returns the previous directory."""
    previous = _SETTINGS["dir"]
    _SETTINGS["dir"] = path or None
    return previous


def incident_dir() -> Optional[str]:
    return _SETTINGS["dir"]


def _ring_size() -> int:
    return _SETTINGS["ring"]


def _dedupe_window_s() -> float:
    return _SETTINGS["dedupe_s"]


def _jsonable(value):
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    return repr(value)


class FlightRecorder:
    """Bounded ring of recent records plus incident assembly/dump."""

    def __init__(self, ring_size: Optional[int] = None,
                 dedupe_s: Optional[float] = None) -> None:
        self._ring: "collections.deque[Tuple]" = collections.deque(
            maxlen=ring_size or _ring_size()
        )
        self._lock = lockcheck.make_lock("obs.flight.FlightRecorder")
        #: (reason, trace_id) -> last fire timestamp; entries older
        #: than the dedupe window expire, so a RECURRING incident
        #: re-fires (constructor arg pins the window for tests; None
        #: reads the process setting per trigger)
        self._seen: Dict[Tuple[str, Optional[str]], float] = {}
        self._dedupe_s = dedupe_s
        self._seq = 0
        self._incidents: List[Dict] = []

    # -- hot path ------------------------------------------------------

    def record(self, kind: str, /, trace_id: Optional[str] = None,
               **fields) -> None:
        """Append one pre-rendered record to the ring (no lock: deque
        append with ``maxlen`` is atomic).  ``kind`` is positional-only
        so callers may carry a ``kind=...`` field of their own."""
        self._ring.append(
            (time.time(), kind, trace_id, tuple(fields.items()))
        )

    # -- reads ---------------------------------------------------------

    def records(self, trace_id: Optional[str] = None,
                limit: Optional[int] = None) -> List[Dict]:
        """Point-in-time copy of the ring as dicts, oldest first,
        optionally filtered to one trace and/or tail-limited."""
        snap = list(self._ring)
        if trace_id is not None:
            snap = [r for r in snap if r[2] == trace_id]
        if limit is not None:
            snap = snap[-limit:]
        return [
            {**dict(fields), "ts": ts, "kind": kind, "trace_id": tid}
            for ts, kind, tid, fields in snap
        ]

    def incidents(self) -> List[Dict]:
        with self._lock:
            return [dict(i) for i in self._incidents]

    # -- anomaly path --------------------------------------------------

    def _admit(self, reason: str,
               trace_id: Optional[str]) -> Optional[int]:
        """Dedupe on ``(reason, trace_id)`` and allocate a sequence
        number; ``None`` means suppressed within the rolling window."""
        key = (reason, trace_id)
        window = (
            self._dedupe_s if self._dedupe_s is not None
            else _dedupe_window_s()
        )
        now = time.time()
        with self._lock:
            last = self._seen.get(key)
            if last is not None and window > 0 and now - last < window:
                return None
            self._seen[key] = now
            if len(self._seen) > 4 * MAX_INCIDENTS:
                # bound the dedupe table: expired entries are dead
                # weight once their window passed
                self._seen = {
                    k: t for k, t in self._seen.items()
                    if now - t < window
                }
            self._seq += 1
            return self._seq

    def _dump_and_keep(self, incident: Dict, seq: int,
                       reason: str) -> Dict:
        """Write the incident to the incident directory (atomic rename,
        when one is set) and append it to the in-memory list."""
        dump_dir = incident_dir()
        if dump_dir:
            try:
                os.makedirs(dump_dir, exist_ok=True)
                path = os.path.join(
                    dump_dir, f"incident-{seq:04d}-{reason}.json"
                )
                tmp = f"{path}.tmp-{os.getpid()}"
                with open(tmp, "w") as fh:
                    json.dump(incident, fh, indent=1, default=repr)
                os.replace(tmp, path)
                incident["path"] = path
            except OSError:
                # a full/readonly dump dir must never take down serving;
                # the incident still lands in memory below
                incident["path"] = None
        with self._lock:
            self._incidents.append(incident)
            del self._incidents[:-MAX_INCIDENTS]
        return incident

    def trigger(self, reason: str, trace_id: Optional[str] = None,
                **detail) -> Optional[Dict]:
        """Fire an anomaly trigger: assemble an incident (and dump it to
        the incident directory when one is set).  Returns the incident
        dict, or ``None`` when ``(reason, trace_id)`` fired within the
        dedupe window (default 300 s; expired entries re-fire so
        recurring incidents stay visible)."""
        seq = self._admit(reason, trace_id)
        if seq is None:
            return None
        incident = self._build_incident(seq, reason, trace_id, detail)
        return self._dump_and_keep(incident, seq, reason)

    def _build_incident(self, seq: int, reason: str,
                        trace_id: Optional[str], detail: Dict) -> Dict:
        from waffle_con_tpu_torch.obs import metrics as obs_metrics
        from waffle_con_tpu_torch.obs import slo as obs_slo
        from waffle_con_tpu_torch.runtime import events as runtime_events

        incident: Dict = {
            "schema": INCIDENT_SCHEMA,
            "seq": seq,
            "reason": reason,
            "trace_id": trace_id,
            "unix_time": time.time(),
            "detail": {str(k): _jsonable(v) for k, v in detail.items()},
            "trace": self.records(trace_id=trace_id) if trace_id else [],
            "recent": self.records(limit=256),
            "events": runtime_events.get_events()[-256:],
            "slo": obs_slo.snapshot(),
        }
        if obs_metrics.metrics_enabled():
            incident["metrics"] = obs_metrics.registry().snapshot()
        return incident

    def reset(self) -> None:
        """Drop ring, dedupe state, and in-memory incidents (tests)."""
        with self._lock:
            self._ring.clear()
            self._seen.clear()
            self._incidents.clear()
            self._seq = 0


_RECORDER = FlightRecorder()

#: trigger listeners: called with ``(reason, trace_id, detail)`` on every
#: module-level trigger, before dedupe (the replicated front door's
#: health logic needs each occurrence, not each unique incident).  A
#: listener that raises is skipped: it never breaks the trigger path.
_LISTENERS: List = []
_LISTENER_LOCK = lockcheck.make_lock("obs.flight.LISTENERS")


def add_trigger_listener(fn) -> None:
    """Register ``fn(reason, trace_id, detail)`` on every trigger (once:
    a second registration of the same callable is ignored)."""
    with _LISTENER_LOCK:
        if fn not in _LISTENERS:
            _LISTENERS.append(fn)


def remove_trigger_listener(fn) -> None:
    with _LISTENER_LOCK:
        try:
            _LISTENERS.remove(fn)
        except ValueError:
            pass


def _notify_listeners(reason: str, trace_id: Optional[str],
                      detail: Dict) -> None:
    with _LISTENER_LOCK:
        listeners = list(_LISTENERS)
    for fn in listeners:
        try:
            fn(reason, trace_id, detail)
        except Exception:  # noqa: BLE001 - listeners must never break
            pass


def get_recorder() -> FlightRecorder:
    return _RECORDER


def record(kind: str, /, trace_id: Optional[str] = None, **fields) -> None:
    _RECORDER.record(kind, trace_id=trace_id, **fields)


def trigger(reason: str, trace_id: Optional[str] = None,
            **detail) -> Optional[Dict]:
    _notify_listeners(reason, trace_id, detail)
    return _RECORDER.trigger(reason, trace_id=trace_id, **detail)


def incidents() -> List[Dict]:
    return _RECORDER.incidents()


def reset() -> None:
    _RECORDER.reset()
