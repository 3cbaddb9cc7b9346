"""Process-wide runtime event log.

The port of ``waffle_con_tpu``'s ``runtime/events.py``: one append-only
list shared by the supervisor (demotions, promotions, failed dispatches,
restores), the fault hooks (each injected fault) and the watchdog (budget
overruns, deadlines).  Tests and ``chip_smoke.py`` assert on it, so a
degraded run is visibly degraded.

Events are plain dicts with a ``kind`` key; everything else is
kind-specific detail.  The log is capped: past ``_MAX_EVENTS`` events are
counted on a trailing ``event_log_saturated`` marker instead of stored,
so a pathological retry loop cannot turn the log into a leak.

Every append (:func:`record`), drain (:func:`clear_events`) and read
(:func:`get_events`, :func:`summarize_events`) holds ``_LOCK``, and
readers get copies, never live aliases.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

_LOCK = threading.Lock()
_EVENTS: List[Dict] = []
#: hard cap; beyond it new events are counted on a marker
_MAX_EVENTS = 10_000


def record(kind: str, **details) -> Dict:
    """Append an event and return it.  When the metrics pipeline is on,
    every event also bumps ``waffle_runtime_events_total{kind=...}``."""
    event = {"kind": kind, **details}
    dropped = False
    with _LOCK:
        if len(_EVENTS) < _MAX_EVENTS:
            _EVENTS.append(event)
        elif _EVENTS[-1].get("kind") == "event_log_saturated":
            _EVENTS[-1]["dropped"] += 1
            dropped = True
        else:
            _EVENTS.append({"kind": "event_log_saturated", "dropped": 1})
            dropped = True
    from waffle_con_tpu_torch.obs import metrics as obs_metrics

    if obs_metrics.metrics_enabled():
        obs_metrics.registry().counter(
            "waffle_runtime_events_total", kind=kind
        ).inc()
        if dropped:
            obs_metrics.registry().counter(
                "waffle_runtime_events_dropped_total"
            ).inc()
    return event


def get_events(kind: Optional[str] = None) -> List[Dict]:
    """Snapshot of recorded events (optionally filtered by kind)."""
    with _LOCK:
        return [
            dict(e) for e in _EVENTS if kind is None or e["kind"] == kind
        ]


def summarize_events() -> Dict[str, int]:
    """``{kind: count}`` over the log."""
    with _LOCK:
        out: Dict[str, int] = {}
        for e in _EVENTS:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
        return out


def clear_events() -> None:
    with _LOCK:
        del _EVENTS[:]
