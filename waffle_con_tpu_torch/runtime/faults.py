"""Deterministic fault injection for the port's runtime.

The port of ``waffle_con_tpu``'s ``runtime/faults.py``.  A
:class:`FaultPlan` is a list of :class:`FaultSpec` rules; a rule fires
when a poll matches its ``(kind, backend, op, at)`` filter, at most
``count`` times, so a plan is exactly reproducible: the same search sees
the same faults at the same points on every run.  For the dispatch kinds
the poll index is the supervisor's attempt counter.  Plans are installed
in code only (:func:`install` / :func:`clear`); the port reads no
environment variable, so there is no ``WAFFLE_FAULTS``.

Fault kinds:

* ``timeout`` — the supervisor raises :class:`InjectedTimeout` before
  touching the backend (state unmutated, so a retry is safe).
* ``device_loss`` — :class:`InjectedDeviceLoss` before the backend call,
  a card that fell off the bus.
* ``garbage`` — the dispatch runs, then every ``BranchStats`` in its
  result is corrupted (NaN distances, negative tip totals); the
  supervisor's validation must refuse it and retry from the ledger.
* ``pallas_compile`` — a kernel that fails to build or launch: the
  dispatch function of a kernel (:func:`check_kernel`, called by every
  ``ops/*_kernel.py`` dispatch rule before it picks the CUDA kernel or
  its plain twin) raises :class:`InjectedKernelFailure`.  Nothing falls
  back to the twin: unsupervised the search raises, supervised the
  supervisor demotes it (an event and a counter).
* ``flip_vote`` — the single engine's pop loop (via
  :func:`maybe_flip_vote`) silently replaces the sole passing symbol
  with a different alphabet symbol before committing it — a wrong
  *decision*, invisible to every result check of the scorer, that only
  the audit plane (:mod:`waffle_con_tpu_torch.obs.audit`: the lockstep
  shadow and ``diff_logs``) can catch.  The poll index is the popped
  node's consensus length, so a length-pinned rule replays
  deterministically through a checkpoint resume.
* ``cache_corrupt`` — the build cache's check before a library load
  (:func:`maybe_corrupt_cache`, called by
  :func:`waffle_con_tpu_torch.utils.cache.check_library`) flips bytes in
  the middle of the build directory's first library: the check must
  quarantine it and the loader build it again.  It records a
  ``cache_corruption_injected`` event.

Every fired dispatch or kernel fault records a ``fault_injected`` event
(:mod:`waffle_con_tpu_torch.runtime.events`); ``flip_vote`` records
none.

Example::

    from waffle_con_tpu_torch.runtime import faults

    faults.install(faults.FaultPlan()).add(
        "flip_vote", backend="torch", op="vote", at=120, count=1)
    try:
        engine.consensus()
    finally:
        faults.clear()
"""

from __future__ import annotations

import dataclasses
import threading
from typing import List, Optional

import numpy as np

from waffle_con_tpu_torch.runtime import events

FAULT_KINDS = (
    "timeout", "device_loss", "garbage", "pallas_compile", "flip_vote",
    "cache_corrupt",
)
#: the kinds the supervisor polls at each dispatch attempt
DISPATCH_KINDS = ("timeout", "device_loss", "garbage")


class InjectedFault(Exception):
    """Base class for exceptions raised by injected faults."""


class InjectedTimeout(InjectedFault):
    """Injected dispatch timeout (raised before the backend runs)."""


class InjectedDeviceLoss(InjectedFault):
    """Injected device loss (raised before the backend runs)."""


class InjectedKernelFailure(InjectedFault):
    """Injected kernel build or launch failure (``pallas_compile``)."""


@dataclasses.dataclass
class FaultSpec:
    """One injection rule.  ``backend``/``op`` filter with ``"*"`` as
    the wildcard; ``at`` pins a single poll index (``None`` = every
    matching poll); ``count`` bounds total firings (``None`` =
    unlimited)."""

    kind: str
    backend: str = "*"
    op: str = "*"
    at: Optional[int] = None
    count: Optional[int] = 1
    fired: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: {FAULT_KINDS})"
            )

    def _exhausted(self) -> bool:
        return self.count is not None and self.fired >= self.count

    def matches(self, backend: str, op: str, index: Optional[int]) -> bool:
        if self._exhausted():
            return False
        if self.backend != "*" and self.backend != backend:
            return False
        if self.op != "*" and self.op != op:
            return False
        if self.at is not None and index != self.at:
            return False
        return True


class FaultPlan:
    """An ordered set of fault rules consulted by the runtime hooks.
    ``poll`` is serialized by a plan-level lock, so a ``count``-bounded
    rule fires exactly ``count`` times however many threads poll it."""

    def __init__(self, specs: Optional[List[FaultSpec]] = None) -> None:
        self.specs: List[FaultSpec] = list(specs or [])
        self._lock = threading.Lock()

    def add(
        self,
        kind: str,
        backend: str = "*",
        op: str = "*",
        at: Optional[int] = None,
        count: Optional[int] = 1,
    ) -> "FaultPlan":
        self.specs.append(FaultSpec(kind, backend, op, at, count))
        return self

    def poll(
        self, backend: str, op: str, index: Optional[int],
        kinds: Optional[tuple] = None,
    ) -> Optional[FaultSpec]:
        """First matching rule (its firing consumed), or ``None``."""
        with self._lock:
            for spec in self.specs:
                if kinds is not None and spec.kind not in kinds:
                    continue
                if spec.matches(backend, op, index):
                    spec.fired += 1
                    return spec
        return None


#: the installed plan (``None``: no fault armed)
_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """Install (or with ``None``: clear) the process-wide fault plan."""
    global _ACTIVE
    _ACTIVE = plan
    return plan


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    """The installed plan, or ``None``."""
    return _ACTIVE


def maybe_flip_vote(backend: str, length: int) -> bool:
    """Single-engine pop-loop hook: ``True`` when a ``flip_vote`` fault
    is armed for this backend at this consensus length.  The engine only
    polls at pops where a flip can commit (exactly one passing symbol),
    so a ``count=1`` rule lands on the first such pop."""
    plan = _ACTIVE
    if plan is None:
        return False
    return plan.poll(backend, "vote", length, kinds=("flip_vote",)) is not None


def poll(backend: str, op: str, index: int) -> Optional[FaultSpec]:
    """Supervisor-side hook: the dispatch kinds only."""
    plan = _ACTIVE
    if plan is None:
        return None
    spec = plan.poll(backend, op, index, kinds=DISPATCH_KINDS)
    if spec is not None:
        events.record("fault_injected", fault=spec.kind, backend=backend,
                      op=op, index=index)
    return spec


def check_kernel(name: str) -> None:
    """Kernel dispatch hook: raise :class:`InjectedKernelFailure` when a
    ``pallas_compile`` fault is armed for kernel ``name`` (the rule's
    ``op``; its backend is ``"torch"``)."""
    plan = _ACTIVE
    if plan is None:
        return
    if plan.poll("torch", name, None, kinds=("pallas_compile",)):
        events.record("fault_injected", fault="pallas_compile",
                      backend="torch", op=name, index=None)
        raise InjectedKernelFailure(
            f"injected kernel build/launch failure ({name})")


def maybe_corrupt_cache(path) -> Optional[str]:
    """Build-cache hook: when a ``cache_corrupt`` fault is armed, flip
    bytes in the middle of the first library of the build directory
    ``path`` (name order: deterministic) and return its name."""
    plan = _ACTIVE
    if plan is None:
        return None
    if not plan.poll("cache", "load", None, kinds=("cache_corrupt",)):
        return None
    from waffle_con_tpu_torch.utils.cache import cache_entries

    entries = cache_entries(path)
    if not entries:
        return None
    name, target = entries[0]
    with open(target, "r+b") as f:
        data = f.read()
        mid = len(data) // 2
        f.seek(mid)
        f.write(bytes(b ^ 0xFF for b in data[mid:mid + 16]) or b"\xff")
    events.record("cache_corruption_injected", entry=name)
    return name


def mangle_stats(result):
    """Corrupt every ``BranchStats`` reachable in a dispatch result (NaN
    distances, negative tip totals): the ``garbage`` payload."""
    from waffle_con_tpu_torch.ops.scorer import BranchStats

    def walk(obj):
        if isinstance(obj, BranchStats):
            obj.eds = np.full(np.shape(obj.eds), np.nan)
            obj.split = np.full(np.shape(obj.split), -1, dtype=np.int64)
            return obj
        if isinstance(obj, list):
            return [walk(x) for x in obj]
        if isinstance(obj, tuple):
            return tuple(walk(x) for x in obj)
        return obj

    return walk(result)
