"""Engagement watchdog: dispatch budgets and deadlines.

The port of ``waffle_con_tpu``'s ``runtime/watchdog.py``.  The device
fast paths (the run kernels, the arena, the batched branch step) are what
keep a search's scorer calls few; a change that silently falls back to
one call a symbol passes every parity test and only shows as a slower
wall.  The engines call :func:`enforce_dispatch_budget` at the end of
every search with their scorer counters: a search over its pinned
``config.dispatch_budget`` records an event and warns, or raises
:class:`WatchdogError` when ``config.watchdog_strict`` is set.  Strict
mode comes from the config only; the port reads no environment variable.

:func:`enforce_deadline` raises :class:`DeadlineExceeded` once a
``time.monotonic()`` deadline has passed; the
:class:`~waffle_con_tpu_torch.models.checkpoint.CheckpointController`
calls it at a pop boundary after taking a final checkpoint.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Optional

from waffle_con_tpu_torch.obs.report import dispatch_total
from waffle_con_tpu_torch.runtime import events

logger = logging.getLogger(__name__)


class WatchdogError(RuntimeError):
    """Strict-mode budget violation."""


class DeadlineExceeded(WatchdogError):
    """A wall-clock deadline expired.  A :class:`WatchdogError`, so
    callers that treat watchdog stops as deliberate handle it alike."""


def enforce_deadline(
    deadline_monotonic: Optional[float], label: str = ""
) -> None:
    """Raise :class:`DeadlineExceeded` when ``time.monotonic()`` is past
    ``deadline_monotonic`` (``None``: no deadline, a no-op), recording a
    ``deadline_exceeded`` event on the way out."""
    if deadline_monotonic is None:
        return
    now = time.monotonic()
    if now >= deadline_monotonic:
        overrun = now - deadline_monotonic
        events.record(
            "deadline_exceeded", label=label, overrun_s=round(overrun, 6)
        )
        from waffle_con_tpu_torch.obs import flight, trace

        flight.trigger(
            "deadline_exceeded", trace_id=trace.current_trace_id(),
            label=label, overrun_s=round(overrun, 6),
        )
        raise DeadlineExceeded(
            f"deadline exceeded{f' ({label})' if label else ''}: "
            f"{overrun * 1000:.1f} ms past the budget"
        )


def enforce_dispatch_budget(
    config, counters: Dict[str, int], engine: str
) -> Optional[int]:
    """Check one search's scorer calls against its pinned budget.

    Returns the total (``None`` when no budget is set).  Over budget: a
    ``watchdog_budget_exceeded`` event and a warning, or
    :class:`WatchdogError` when ``config.watchdog_strict`` is set.
    """
    budget = getattr(config, "dispatch_budget", None)
    if budget is None:
        return None
    total = dispatch_total(counters)
    if total > budget:
        events.record(
            "watchdog_budget_exceeded", engine=engine, total=total,
            budget=budget,
        )
        from waffle_con_tpu_torch.obs import flight, trace

        flight.trigger(
            "watchdog_budget_exceeded",
            trace_id=trace.current_trace_id(),
            engine=engine, total=total, budget=budget,
        )
        message = (
            f"{engine} consensus used {total} blocking dispatches, over "
            f"its pinned budget of {budget} — a device fast path likely "
            "disengaged (see counter breakdown in last_search_stats)"
        )
        if getattr(config, "watchdog_strict", False):
            raise WatchdogError(message)
        logger.warning("%s", message)
    return total
