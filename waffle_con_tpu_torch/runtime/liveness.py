"""Worker-process liveness: heartbeat tracking and the typed loss error.

The port of ``waffle_con_tpu``'s ``runtime/liveness.py``.  The
out-of-process front door (:mod:`waffle_con_tpu_torch.serve.procs.door`)
cannot observe a worker's threads the way the in-process replica set can:
all it sees is the socket.  :class:`Heartbeats` is the door-side ledger:
every frame a worker sends (results, pongs, forwarded flight triggers)
counts as a beat, and :meth:`Heartbeats.lapsed` names the workers whose
last beat is older than ``ProcConfig.liveness_s``, so the watchdog can
declare them lost even when the operating system keeps the dead peer's
socket open (a worker wedged in a device call, not crashed).

:class:`WorkerLost` is the typed error a job fails with when its worker
dies and the door can neither migrate it (no ``CHECKPOINT`` frame arrived
yet, or ``ProcConfig.checkpoint_migrate`` is off) nor restart it
(``ProcConfig.restart_lost=False``): callers can tell "your worker
crashed" from an engine failure.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

from waffle_con_tpu_torch.analysis import lockcheck


class WorkerLost(RuntimeError):
    """The worker process running (or queued to run) a job died or went
    silent past the liveness lapse before finishing it."""


class Heartbeats:
    """Monotonic last-seen ledger keyed by worker name.

    Thread-safe: the door's reader threads :meth:`beat` concurrently with
    the watchdog thread calling :meth:`lapsed`.  ``clock`` replaces
    ``time.monotonic`` (tests).
    """

    def __init__(self, clock: Optional[Callable[[], float]] = None) -> None:
        self._clock = clock or time.monotonic
        self._lock = lockcheck.make_lock("runtime.liveness.Heartbeats")
        self._seen: Dict[str, float] = {}

    def beat(self, name: str) -> None:
        """Record activity from ``name`` now."""
        with self._lock:
            self._seen[name] = self._clock()

    def forget(self, name: str) -> None:
        """Stop tracking ``name`` (a worker deliberately shut down)."""
        with self._lock:
            self._seen.pop(name, None)

    def age(self, name: str) -> Optional[float]:
        """Seconds since ``name``'s last beat (``None`` if never seen)."""
        with self._lock:
            seen = self._seen.get(name)
        return None if seen is None else self._clock() - seen

    def lapsed(self, older_than_s: float) -> List[str]:
        """Names whose last beat is more than ``older_than_s`` ago."""
        cutoff = self._clock() - older_than_s
        with self._lock:
            return [n for n, t in self._seen.items() if t < cutoff]
