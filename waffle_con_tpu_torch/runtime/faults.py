"""Deterministic fault injection: the ``flip_vote`` fault.

The port of the ``flip_vote`` kind of ``waffle_con_tpu``'s
``runtime/faults.py``.  A :class:`FaultPlan` is a list of
:class:`FaultSpec` rules; a rule fires when a poll matches its
``(kind, backend, op, at)`` filter, at most ``count`` times, so a plan is
exactly reproducible: the same search sees the same faults at the same
points on every run.  Plans are installed programmatically only
(:func:`install` / :func:`clear`; the port reads no environment
variable).

``flip_vote``: the single engine's pop loop (via :func:`maybe_flip_vote`)
silently replaces the sole passing symbol with a different alphabet
symbol before committing it — a wrong *decision*, invisible to every
result check of the scorer, that only the audit plane
(:mod:`waffle_con_tpu_torch.obs.audit`: the lockstep shadow and
``diff_logs``) can catch.  The poll index is the popped node's consensus
length, so a length-pinned rule replays deterministically through a
checkpoint resume.

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

FAULT_KINDS = ("flip_vote",)


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
