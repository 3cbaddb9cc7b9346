"""Runtime lock-order checker: deadlock inversions caught without the
deadlock.

The port of ``waffle_con_tpu``'s ``analysis/lockcheck.py``.  Every lock
of the serving path is created through :func:`make_lock` /
:func:`make_rlock`, each with a stable creation-site *name*
(``"serve.service.ConsensusService"``).  With :func:`enable_lockcheck`
on, the factories return a :class:`_CheckedLock` proxy; otherwise they
return the plain ``threading`` primitive — the checker costs nothing
when off, because the decision happens once at lock *creation*, not per
acquire.  The port reads no environment variable: the checker is
switched on in code only.

The proxy maintains a per-thread stack of held locks and a global
directed graph over lock *names*: a blocking acquire of ``B`` while
holding ``A`` records the edge ``A -> B``.  Before a new edge is added,
a DFS asks whether ``B`` can already reach ``A`` — if so, some other
code path acquires these locks in the opposite order, which is a
potential deadlock even if the two paths never actually collided.  The
checker then dumps both acquisition stacks to the flight recorder and
raises :class:`LockOrderError`.

Design notes:

* Edges are name-level, so two *instances* of the same class lock (for
  example two jobs' ``serve.job._lock``) acquired nested record a
  self-edge ``A -> A``.  Self-edges are recorded but never flagged:
  instance-ordered acquisition of sibling locks is a legitimate
  pattern, and flagging it would be pure false positive.
* Non-blocking acquires (``blocking=False``) never record edges — a
  try-lock cannot participate in a deadlock cycle.
* RLock re-acquisition by the holding thread records nothing (the lock
  is already owned; no new wait-for relation exists).
* The graph's own mutex is a raw ``threading.Lock``.
"""

from __future__ import annotations

import threading
import traceback
from typing import Dict, List, Optional, Set, Tuple

__all__ = [
    "LockOrderError", "lockcheck_enabled", "enable_lockcheck",
    "make_lock", "make_rlock", "make_thread", "edges", "reset",
]


class LockOrderError(RuntimeError):
    """Two code paths acquire the same locks in conflicting order."""


#: set by :func:`enable_lockcheck` (off by default)
_ENABLED = False


def lockcheck_enabled() -> bool:
    return _ENABLED


def enable_lockcheck(on: bool = True) -> None:
    """Switch the checker on or off.  Only affects locks created *after*
    the call — module-level locks resolve at import time."""
    global _ENABLED
    _ENABLED = bool(on)


def reset_enabled() -> None:
    """Back to the default (off)."""
    enable_lockcheck(False)


# ---------------------------------------------------------------------
# global order graph

_graph_mu = threading.Lock()  # raw on purpose: guards the graph itself
#: name -> names acquired while it was held
_graph: Dict[str, Set[str]] = {}
#: (a, b) -> short formatted stack of the acquire that created the edge
_edge_sites: Dict[Tuple[str, str], str] = {}

_tls = threading.local()


def _held_stack() -> List["_CheckedLock"]:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


def _reaches(src: str, dst: str) -> bool:
    """DFS: is there a path src -> ... -> dst in the edge graph?
    Caller holds ``_graph_mu``."""
    seen: Set[str] = set()
    frontier = [src]
    while frontier:
        node = frontier.pop()
        if node == dst:
            return True
        if node in seen:
            continue
        seen.add(node)
        frontier.extend(_graph.get(node, ()))
    return False


def _acquire_site(skip: int = 3) -> str:
    frames = traceback.format_stack()[:-skip]
    return "".join(frames[-6:])


def edges() -> Set[Tuple[str, str]]:
    """Snapshot of the recorded order edges (test API)."""
    with _graph_mu:
        return {(a, b) for a, succs in _graph.items() for b in succs}


def reset() -> None:
    """Clear the global order graph (test API)."""
    with _graph_mu:
        _graph.clear()
        _edge_sites.clear()


def _record_edges(lock: "_CheckedLock") -> None:
    """Record held -> lock edges; raise on an order inversion."""
    held = _held_stack()
    if not held:
        return
    here: Optional[str] = None
    inversion: Optional[Tuple[str, str, str]] = None
    for prior in held:
        a, b = prior.name, lock.name
        if a == b:
            continue  # sibling instances: instance-ordered, not flagged
        if here is None:
            here = _acquire_site(skip=4)
        with _graph_mu:
            succs = _graph.setdefault(a, set())
            if b in succs:
                continue
            if _reaches(b, a):
                inversion = (a, b, _edge_sites.get((b, a)) or "")
                break
            succs.add(b)
            _edge_sites[(a, b)] = here
    if inversion is None:
        return
    # NOTE: _graph_mu is released here — the flight trigger below
    # acquires (checked) flight locks and must not nest under it
    a, b, other_site = inversion
    held_names = [p.name for p in held]
    message = (
        f"lock-order inversion: acquiring {b!r} while holding {a!r}, "
        f"but an established order already reaches {a!r} from {b!r}\n"
        f"--- established {b!r} -> ... -> {a!r} edge recorded at ---\n"
        f"{other_site}"
        f"--- conflicting acquire of {b!r} (holding {held_names}) "
        f"at ---\n{here}"
    )
    try:  # best-effort flight incident before raising
        from waffle_con_tpu_torch.obs import flight

        flight.trigger(
            "lock_order_inversion",
            holding=a, acquiring=b, held=held_names,
        )
    except Exception:
        pass
    raise LockOrderError(message)


class _CheckedLock:
    """Order-checking proxy over ``threading.Lock``/``RLock``."""

    __slots__ = ("_lock", "name", "_reentrant")

    def __init__(self, lock, name: str, reentrant: bool) -> None:
        self._lock = lock
        self.name = name
        self._reentrant = reentrant

    def acquire(self, blocking: bool = True, timeout: float = -1):
        held = _held_stack()
        if blocking and not (
            self._reentrant and any(p is self for p in held)
        ):
            _record_edges(self)
        if timeout == -1:
            ok = self._lock.acquire(blocking)
        else:
            ok = self._lock.acquire(blocking, timeout)
        if ok:
            held.append(self)
        return ok

    def release(self) -> None:
        held = _held_stack()
        for i in range(len(held) - 1, -1, -1):
            if held[i] is self:
                del held[i]
                break
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"<_CheckedLock {self.name!r} of {self._lock!r}>"


# ---------------------------------------------------------------------
# factories


def make_lock(name: str):
    """A ``threading.Lock``, order-checked when lockcheck is enabled.

    ``name`` is the stable creation-site identity (module.owner); all
    instances created at one site share it, so ordering is checked at
    the class/site level."""
    if lockcheck_enabled():
        return _CheckedLock(threading.Lock(), name, reentrant=False)
    return threading.Lock()


def make_rlock(name: str):
    """A ``threading.RLock``, order-checked when lockcheck is enabled
    (re-acquisition by the holding thread records no edges)."""
    if lockcheck_enabled():
        return _CheckedLock(threading.RLock(), name, reentrant=True)
    return threading.RLock()


def make_thread(**kwargs) -> threading.Thread:
    """The ``threading.Thread`` seam of the serving path.  A passthrough
    — one place to hang thread instrumentation (naming, crash funnels)
    later."""
    return threading.Thread(**kwargs)
