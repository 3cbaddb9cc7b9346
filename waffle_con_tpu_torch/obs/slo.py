"""Rolling SLO windows: sliding percentiles + EWMA over recent latency.

The port of ``waffle_con_tpu``'s ``obs/slo.py``.  The fixed-bucket
histograms in :mod:`waffle_con_tpu_torch.obs.metrics`
accumulate forever, so they cannot answer "is this search slow
*relative to the last five minutes*".  This module keeps **sliding
windows** (age- and count-bounded) over the two latencies that define
the serving SLO — per-dispatch wall clock and per-job/search wall
clock — and derives nearest-rank p50/p95/p99 plus an EWMA baseline
from each.

Anomaly hook: :func:`observe_search` first *checks* the elapsed time
against the job window's rolling p95 (before adding the sample, so a
pathological search cannot dilute the baseline it is judged against)
and fires the flight recorder's ``slow_search`` trigger when
``elapsed > k * p95``; only then does the sample join the window.  The
check needs :data:`MIN_SAMPLES` prior samples — cold windows never
alarm.

Exposition: the tracker registers a **collector** with the process
metrics registry on first use, so every
:meth:`~waffle_con_tpu_torch.obs.metrics.MetricsRegistry.snapshot` /
``render_prometheus`` call re-publishes
``waffle_slo_dispatch_latency_seconds`` /
``waffle_slo_job_latency_seconds`` gauges (labelled
``quantile="p50"|"p95"|"p99"|"ewma"``) plus per-window sample counts.
:func:`snapshot` returns the same data as a JSON-ready dict for the
service's stats and incident dumps.

Settings, in code only (the port reads no environment variable):
:func:`configure` sets the window age (default 300 s) and the
slow-search multiplier ``k`` (default 3.0).
"""

from __future__ import annotations

import collections
import time
from typing import Deque, Dict, Optional, Tuple

from waffle_con_tpu_torch.analysis import lockcheck

DEFAULT_WINDOW_S = 300.0
DEFAULT_K = 3.0
#: slow-search checks need this many prior samples in the job window
MIN_SAMPLES = 20
#: EWMA smoothing factor (weight of the newest sample)
EWMA_ALPHA = 0.1

QUANTILES = (("p50", 0.50), ("p95", 0.95), ("p99", 0.99))


_SETTINGS = {"window_s": DEFAULT_WINDOW_S, "k": DEFAULT_K}


def configure(window_s: Optional[float] = None,
              k: Optional[float] = None) -> None:
    """Set the window age (seconds; windows built after the call, and
    :func:`reset`, use it) and the slow-search multiplier; ``None``
    leaves a setting as it is."""
    if window_s is not None:
        if window_s <= 0:
            raise ValueError("window_s must be > 0")
        _SETTINGS["window_s"] = float(window_s)
    if k is not None:
        if k <= 0:
            raise ValueError("k must be > 0")
        _SETTINGS["k"] = float(k)


def window_age_s() -> float:
    return _SETTINGS["window_s"]


def slow_search_k() -> float:
    return _SETTINGS["k"]


class RollingWindow:
    """Age- and count-bounded sample window with EWMA baseline.

    Not thread-safe on its own; :class:`SloTracker` serializes access.
    """

    __slots__ = ("max_age_s", "_samples", "ewma", "total")

    def __init__(self, max_age_s: float, max_count: int) -> None:
        self.max_age_s = max_age_s
        self._samples: Deque[Tuple[float, float]] = collections.deque(
            maxlen=max_count
        )
        self.ewma: Optional[float] = None
        self.total = 0

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        self._samples.append((now, float(value)))
        self.total += 1
        if self.ewma is None:
            self.ewma = float(value)
        else:
            self.ewma += EWMA_ALPHA * (float(value) - self.ewma)
        self._prune(now)

    def _prune(self, now: float) -> None:
        cutoff = now - self.max_age_s
        samples = self._samples
        while samples and samples[0][0] < cutoff:
            samples.popleft()

    def percentiles(self, now: Optional[float] = None) -> Dict[str, float]:
        """Nearest-rank p50/p95/p99 over the live window (empty dict
        when the window has no samples)."""
        self._prune(time.monotonic() if now is None else now)
        values = sorted(v for _ts, v in self._samples)
        if not values:
            return {}
        n = len(values)
        return {
            name: values[min(n - 1, max(0, int(q * n + 0.5) - 1))]
            for name, q in QUANTILES
        }

    def __len__(self) -> int:
        return len(self._samples)


class SloTracker:
    """Dispatch-latency + job-latency windows with slow-search check."""

    WINDOW_NAMES = ("dispatch", "job")

    def __init__(self, window_s: Optional[float] = None) -> None:
        age = window_age_s() if window_s is None else window_s
        self._lock = lockcheck.make_lock("obs.slo.SloTracker")
        self._windows: Dict[str, RollingWindow] = {
            "dispatch": RollingWindow(age, max_count=4096),
            "job": RollingWindow(age, max_count=1024),
        }
        self.slow_searches = 0

    def observe_dispatch(self, seconds: float) -> None:
        with self._lock:
            self._windows["dispatch"].observe(seconds)

    def observe_job(self, seconds: float) -> None:
        with self._lock:
            self._windows["job"].observe(seconds)

    def observe_search(self, seconds: float,
                       trace_id: Optional[str] = None) -> bool:
        """Check ``seconds`` against the rolling job p95 *before* adding
        it to the window; fire the ``slow_search`` flight trigger (and
        return True) when ``seconds > k * p95`` with a warm window."""
        k = slow_search_k()
        slow = False
        with self._lock:
            window = self._windows["job"]
            if len(window) >= MIN_SAMPLES:
                p95 = window.percentiles().get("p95")
                if p95 is not None and seconds > k * p95:
                    slow = True
                    self.slow_searches += 1
                    baseline = p95
            window.observe(seconds)
        if slow:
            from waffle_con_tpu_torch.obs import flight
            from waffle_con_tpu_torch.obs import metrics as obs_metrics

            flight.trigger(
                "slow_search", trace_id=trace_id,
                elapsed_s=round(seconds, 6), p95_s=round(baseline, 6),
                k=k,
            )
            if obs_metrics.metrics_enabled():
                obs_metrics.registry().counter(
                    "waffle_slo_slow_search_total"
                ).inc()
        return slow

    def snapshot(self) -> Dict:
        """JSON-ready rolling stats per window (embedded in the
        service's stats and in incident dumps)."""
        out: Dict = {"k": slow_search_k(), "slow_searches": 0}
        with self._lock:
            out["slow_searches"] = self.slow_searches
            for name, window in self._windows.items():
                stats = window.percentiles()
                out[name] = {
                    "window_s": window.max_age_s,
                    "count": len(window),
                    "total": window.total,
                    "ewma_s": window.ewma,
                    **{f"{q}_s": v for q, v in stats.items()},
                }
        return out

    def publish(self, registry) -> None:
        """Set ``waffle_slo_*`` gauges on ``registry`` from the live
        windows (collector hook; skips empty windows so unit-test
        registries stay untouched by cold trackers)."""
        with self._lock:
            if not any(len(w) for w in self._windows.values()):
                return
            for name, window in self._windows.items():
                if not len(window):
                    continue
                family = f"waffle_slo_{name}_latency_seconds"
                for q, v in window.percentiles().items():
                    registry.gauge(family, quantile=q).set(v)
                if window.ewma is not None:
                    registry.gauge(family, quantile="ewma").set(window.ewma)
                registry.gauge(
                    "waffle_slo_window_samples", window=name
                ).set(len(window))
            registry.gauge("waffle_slo_slow_searches").set(
                self.slow_searches
            )

    def reset(self) -> None:
        with self._lock:
            age = window_age_s()
            self._windows = {
                "dispatch": RollingWindow(age, max_count=4096),
                "job": RollingWindow(age, max_count=1024),
            }
            self.slow_searches = 0


_TRACKER = SloTracker()
_COLLECTOR_REGISTERED = False
_COLLECTOR_LOCK = lockcheck.make_lock("obs.slo.COLLECTOR")


def tracker() -> SloTracker:
    return _TRACKER


def _ensure_collector() -> None:
    """Register the exposition collector with the process registry once
    (lazily, on first observation, to keep import side-effect free)."""
    global _COLLECTOR_REGISTERED
    if _COLLECTOR_REGISTERED:
        return
    with _COLLECTOR_LOCK:
        if _COLLECTOR_REGISTERED:
            return
        from waffle_con_tpu_torch.obs import metrics as obs_metrics

        reg = obs_metrics.registry()
        reg.register_collector(lambda: _TRACKER.publish(reg))
        _COLLECTOR_REGISTERED = True


def observe_dispatch(seconds: float) -> None:
    _ensure_collector()
    _TRACKER.observe_dispatch(seconds)


def observe_job(seconds: float) -> None:
    _ensure_collector()
    _TRACKER.observe_job(seconds)


def observe_search(seconds: float, trace_id: Optional[str] = None) -> bool:
    _ensure_collector()
    return _TRACKER.observe_search(seconds, trace_id=trace_id)


def snapshot() -> Dict:
    return _TRACKER.snapshot()


def reset() -> None:
    _TRACKER.reset()
