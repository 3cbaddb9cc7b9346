"""Structured per-search report returned alongside consensus results.

The port of ``waffle_con_tpu``'s ``obs/report.py``.  Every engine's
``consensus()`` runs through :func:`run_reported_search`, which opens a
``search`` tracer span, runs the lockstep shadow when one is asked for
(:func:`~waffle_con_tpu_torch.obs.audit.shadow_override`), and stores a
:class:`SearchReport` as ``engine.last_search_report`` (the dict-shaped
``last_search_stats`` stays).  One summary line is logged — at INFO when
``config.log_search_summary`` is set, else at DEBUG.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, Optional

logger = logging.getLogger(__name__)

#: the scorer counters that each count one blocking scorer call
DISPATCH_COUNTER_KEYS = (
    "push_calls", "run_calls", "stats_calls", "clone_calls",
    "clone_push_calls", "activate_calls", "finalize_calls",
    "arena_calls", "run_dual_calls",
)


def dispatch_total(counters: Dict[str, int]) -> int:
    """Blocking scorer calls: the sum of ``DISPATCH_COUNTER_KEYS``."""
    return sum(int(counters.get(k, 0)) for k in DISPATCH_COUNTER_KEYS)


class SearchReport:
    """Search-shape and time accounting for one ``consensus()`` call."""

    __slots__ = (
        "engine", "backend", "wall_s", "nodes_explored", "nodes_ignored",
        "peak_queue_size", "dispatch_counts", "dispatch_total",
        "time_breakdown", "n_results", "consensus_len", "extra",
    )

    def __init__(
        self,
        engine: str,
        backend: str,
        wall_s: float,
        nodes_explored: int,
        nodes_ignored: int,
        peak_queue_size: int,
        dispatch_counts: Dict[str, int],
        time_breakdown: Optional[Dict[str, float]] = None,
        n_results: int = 0,
        consensus_len: int = 0,
        extra: Optional[Dict] = None,
    ) -> None:
        self.engine = engine
        self.backend = backend
        self.wall_s = float(wall_s)
        self.nodes_explored = int(nodes_explored)
        self.nodes_ignored = int(nodes_ignored)
        self.peak_queue_size = int(peak_queue_size)
        self.dispatch_counts = dict(dispatch_counts)
        self.dispatch_total = dispatch_total(self.dispatch_counts)
        self.time_breakdown = dict(time_breakdown or {})
        self.n_results = int(n_results)
        self.consensus_len = int(consensus_len)
        self.extra = dict(extra or {})

    def to_dict(self) -> Dict:
        out = {
            "engine": self.engine,
            "backend": self.backend,
            "wall_s": round(self.wall_s, 6),
            "nodes_explored": self.nodes_explored,
            "nodes_ignored": self.nodes_ignored,
            "peak_queue_size": self.peak_queue_size,
            "dispatch_total": self.dispatch_total,
            "dispatch_counts": dict(self.dispatch_counts),
            "n_results": self.n_results,
            "consensus_len": self.consensus_len,
        }
        if self.time_breakdown:
            out["time_breakdown"] = {
                k: round(v, 6) for k, v in sorted(self.time_breakdown.items())
            }
        if self.extra:
            out["extra"] = dict(self.extra)
        return out

    def summary_line(self) -> str:
        """The single one-line search summary (log surface; tests format
        it, so keep it %-free and stable-prefixed)."""
        return (
            f"search summary: engine={self.engine} backend={self.backend} "
            f"nodes_explored={self.nodes_explored} "
            f"nodes_ignored={self.nodes_ignored} "
            f"peak_queue={self.peak_queue_size} "
            f"dispatches={self.dispatch_total} "
            f"results={self.n_results} wall_s={self.wall_s:.4f}"
        )

    def __repr__(self) -> str:
        return f"SearchReport({self.to_dict()!r})"


def run_reported_search(engine, engine_label: str, impl: Callable):
    """Run one engine search under a ``search`` tracer span and publish
    its :class:`SearchReport`.

    The engines' public ``consensus()`` methods are thin wrappers over
    this: ``impl`` is the search body, which must leave
    ``engine.last_search_stats`` populated (``nodes_explored`` /
    ``nodes_ignored`` / ``peak_queue_size`` / ``scorer_counters`` /
    ``backend``).  On return the report is stored as
    ``engine.last_search_report`` and its one-line summary is logged.
    """
    # lazy submodule imports keep obs.report importable mid-package-init
    from waffle_con_tpu_torch.obs import audit as obs_audit
    from waffle_con_tpu_torch.obs import flight as obs_flight
    from waffle_con_tpu_torch.obs import metrics as obs_metrics
    from waffle_con_tpu_torch.obs import phases as obs_phases
    from waffle_con_tpu_torch.obs import slo as obs_slo
    from waffle_con_tpu_torch.obs import trace as obs_trace

    tracer = obs_trace.get_tracer()
    totals_before = tracer.category_totals() if tracer.enabled else None
    phases_before = (
        obs_phases.totals() if obs_phases.profiling_enabled() else None
    )
    #: lockstep shadow execution (a debug tool): the python-oracle twin
    #: runs in step with this search and per-pop decisions are compared
    shadow = obs_audit.maybe_shadow(engine, engine_label)
    t0 = time.perf_counter()
    with tracer.span("search", "search", engine=engine_label):
        results = impl() if shadow is None else shadow.run(impl)
    wall_s = time.perf_counter() - t0

    stats = getattr(engine, "last_search_stats", None) or {}
    breakdown: Dict[str, float] = {}
    if totals_before is not None:
        for cat, total in tracer.category_totals().items():
            if cat == "search":
                continue
            delta = total - totals_before.get(cat, 0.0)
            if delta > 0.0:
                breakdown[cat] = delta

    n_results, consensus_len = _result_shape(results)
    report = SearchReport(
        engine=engine_label,
        backend=stats.get("backend")
        or getattr(engine.config, "backend", "unknown"),
        wall_s=wall_s,
        nodes_explored=stats.get("nodes_explored", 0),
        nodes_ignored=stats.get("nodes_ignored", 0),
        peak_queue_size=stats.get("peak_queue_size", 0),
        dispatch_counts=stats.get("scorer_counters", {}),
        time_breakdown=breakdown,
        n_results=n_results,
        consensus_len=consensus_len,
    )
    trace_id = obs_trace.current_trace_id()
    if trace_id is not None:
        report.extra["trace_id"] = trace_id
    if phases_before is not None:
        # per-phase dispatch time spent during this search (process-wide
        # totals diffed around it)
        deltas = {
            p: round(total - phases_before.get(p, 0.0), 6)
            for p, total in obs_phases.totals().items()
        }
        if any(v > 0.0 for v in deltas.values()):
            report.extra["phases"] = deltas
    # the rolling-SLO check before this sample joins the window (a
    # pathological search must not dilute the baseline it is judged
    # against); fires the flight recorder's slow_search trigger
    if obs_slo.observe_search(wall_s, trace_id=trace_id):
        report.extra["slow_search"] = True
    obs_flight.record(
        "search", trace_id=trace_id, engine=engine_label,
        backend=report.backend, wall_s=round(wall_s, 6),
        dispatches=report.dispatch_total,
    )
    engine.last_search_report = report

    if obs_metrics.metrics_enabled():
        reg = obs_metrics.registry()
        reg.counter("waffle_searches_total", engine=engine_label).inc()
        reg.gauge(
            "waffle_search_peak_queue_depth", engine=engine_label
        ).set(report.peak_queue_size)

    level = (
        logging.INFO
        if getattr(engine.config, "log_search_summary", False)
        else logging.DEBUG
    )
    if logger.isEnabledFor(level):
        logger.log(level, "%s", report.summary_line())
    return results


def _result_shape(results) -> "tuple[int, int]":
    """(result count, best consensus length) across the engines' three
    return shapes: ``[Consensus]``, ``[DualConsensus]``, and the
    priority engine's ``PriorityConsensus``."""
    try:
        if results is None:
            return 0, 0
        seq = getattr(results, "consensuses", results)
        n = len(seq)
        if n == 0:
            return 0, 0
        first = seq[0]
        if hasattr(first, "sequence"):
            return n, len(first.sequence)
        inner = getattr(first, "consensus1", None)
        if inner is not None:
            return n, len(inner.sequence)
        return n, 0
    except Exception:  # observability must never break the search
        return 0, 0
