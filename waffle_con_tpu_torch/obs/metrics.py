"""Process-wide metrics registry: counters, gauges, histograms.

The port of ``waffle_con_tpu``'s ``obs/metrics.py``.  The engines' host
loop is one blocking scorer call per event, so the registry's first-class
citizens are the per-backend dispatch latency **histograms** (recorded
by :class:`~waffle_con_tpu_torch.obs.instrument.TimedScorer`), alongside
queue depth, branches-per-dispatch and handle-arena occupancy.

Exposition: :meth:`MetricsRegistry.snapshot` (a JSON-ready dict) and
:meth:`MetricsRegistry.render_prometheus` (Prometheus text format 0.0.4).

Overhead contract: everything here is **off by default** and switched on
by :func:`enable_metrics` only (the port reads no environment variable);
with metrics off no instrument objects are created and the engines'
per-search cost is a handful of boolean checks.

Example::

    from waffle_con_tpu_torch.obs import metrics

    metrics.enable_metrics(True)
    engine.consensus()
    print(metrics.registry().render_prometheus())
"""

from __future__ import annotations

import bisect
import threading
from typing import Callable, Dict, Iterable, List, Optional, Tuple

#: default latency buckets (seconds): from a fast host call to a
#: multi-second search, roughly x2.5 per step like Prometheus' defaults
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

#: default buckets for small-count histograms (branches per dispatch)
DEFAULT_COUNT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)


class Counter:
    """Monotonically increasing counter."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def read(self) -> float:
        with self._lock:
            return self.value


class Gauge:
    """Point-in-time value (queue depth, arena occupancy)."""

    __slots__ = ("value", "_lock")

    def __init__(self) -> None:
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    def read(self) -> float:
        with self._lock:
            return self.value


class Histogram:
    """Fixed-bucket histogram with Prometheus semantics.

    ``bounds`` are the inclusive upper edges of the finite buckets; one
    implicit ``+Inf`` bucket catches the overflow.  ``counts[i]`` is the
    NON-cumulative count of observations with
    ``bounds[i-1] < v <= bounds[i]`` (Prometheus exposition cumulates at
    render time).
    """

    __slots__ = ("bounds", "counts", "sum", "count", "_lock")

    def __init__(self, bounds: Iterable[float]) -> None:
        self.bounds = tuple(sorted(float(b) for b in bounds))
        if not self.bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0
        self._lock = threading.Lock()

    def _bucket_index(self, value: float) -> int:
        # bisect_left matches the inclusive-upper-edge contract
        # (value == bounds[i] lands in bucket i); NaN compares False
        # against everything, which bisect would place at index 0 —
        # route it to the +Inf overflow bucket like the scan it replaced
        if value != value:
            return len(self.bounds)
        return bisect.bisect_left(self.bounds, value)

    def observe(self, value: float) -> None:
        i = self._bucket_index(value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1

    def read(self) -> Tuple[list, float, int]:
        """Consistent ``(counts, sum, count)`` triple taken under the
        instrument lock — exposition must not see a half-applied
        ``observe`` from a concurrently recording thread (the serve
        layer records from many workers at once)."""
        with self._lock:
            return list(self.counts), self.sum, self.count

    def cumulative(self) -> list:
        """Cumulative counts per bound (Prometheus ``le`` semantics),
        with the ``+Inf`` total last."""
        counts, _sum, _count = self.read()
        out = []
        running = 0
        for c in counts:
            running += c
            out.append(running)
        return out


_LabelKey = Tuple[Tuple[str, str], ...]


def _label_key(labels: Dict[str, str]) -> _LabelKey:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _format_labels(key: _LabelKey, extra: str = "") -> str:
    parts = [f'{k}="{v}"' for k, v in key]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class MetricsRegistry:
    """Thread-safe named-metric store with labelled children.

    One metric name maps to a family; each distinct label set is its own
    child instrument.  Families are type-stable: registering the same
    name as a different type raises.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        #: name -> (kind, {label_key: instrument}, histogram bounds)
        self._families: Dict[str, Tuple[str, Dict[_LabelKey, object], Optional[tuple]]] = {}
        self._collectors: List[Callable[[], None]] = []

    def register_collector(self, fn: Callable[[], None]) -> None:
        """Register a callback run at the start of every :meth:`snapshot`
        and :meth:`render_prometheus`, so derived metrics (the rolling
        percentiles of :mod:`~waffle_con_tpu_torch.obs.slo`) are fresh
        at read time."""
        with self._lock:
            self._collectors.append(fn)

    def _collect(self) -> None:
        with self._lock:
            collectors = list(self._collectors)
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001 - never break a read
                pass

    def _child(self, kind: str, name: str, labels: Dict[str, str],
               bounds: Optional[Iterable[float]] = None):
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (kind, {}, tuple(bounds) if bounds else None)
                self._families[name] = fam
            elif fam[0] != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {fam[0]}"
                )
            child = fam[1].get(key)
            if child is None:
                if kind == "counter":
                    child = Counter()
                elif kind == "gauge":
                    child = Gauge()
                else:
                    child = Histogram(fam[2] or DEFAULT_LATENCY_BUCKETS)
                fam[1][key] = child
            return child

    def counter(self, name: str, **labels) -> Counter:
        return self._child("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._child("gauge", name, labels)

    def histogram(
        self, name: str, buckets: Optional[Iterable[float]] = None, **labels
    ) -> Histogram:
        return self._child("histogram", name, labels, bounds=buckets)

    def reset(self) -> None:
        with self._lock:
            self._families.clear()

    # -- exposition ----------------------------------------------------

    def snapshot(self) -> Dict:
        """JSON-ready dump: ``{name: {"type": ..., "series": {labelstr:
        value-or-histogram-dict}}}``."""
        self._collect()
        with self._lock:
            families = {
                name: (kind, dict(children))
                for name, (kind, children, _b) in self._families.items()
            }
        out: Dict[str, Dict] = {}
        for name, (kind, children) in sorted(families.items()):
            series = {}
            for key, child in sorted(children.items()):
                label_str = _format_labels(key) or "{}"
                if kind == "histogram":
                    counts, h_sum, h_count = child.read()
                    series[label_str] = {
                        "buckets": {
                            str(b): c
                            for b, c in zip(child.bounds, counts)
                        },
                        "overflow": counts[-1],
                        "sum": h_sum,
                        "count": h_count,
                    }
                else:
                    series[label_str] = child.read()
            out[name] = {"type": kind, "series": series}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self._collect()
        with self._lock:
            families = {
                name: (kind, dict(children))
                for name, (kind, children, _b) in self._families.items()
            }
        lines = []
        for name, (kind, children) in sorted(families.items()):
            lines.append(f"# TYPE {name} {kind}")
            for key, child in sorted(children.items()):
                if kind == "histogram":
                    counts, h_sum, h_count = child.read()
                    cumulative, running = [], 0
                    for c in counts:
                        running += c
                        cumulative.append(running)
                    for b, c in zip(child.bounds, cumulative):
                        le = _format_labels(key, f'le="{b}"')
                        lines.append(f"{name}_bucket{le} {c}")
                    le = _format_labels(key, 'le="+Inf"')
                    lines.append(f"{name}_bucket{le} {cumulative[-1]}")
                    lines.append(
                        f"{name}_sum{_format_labels(key)} {h_sum}"
                    )
                    lines.append(
                        f"{name}_count{_format_labels(key)} {h_count}"
                    )
                else:
                    lines.append(
                        f"{name}{_format_labels(key)} {child.read()}"
                    )
        return "\n".join(lines) + "\n"


#: the process-wide registry every component records into
_REGISTRY = MetricsRegistry()
#: whether instrumentation records (off until :func:`enable_metrics`)
_ENABLED = False


def registry() -> MetricsRegistry:
    return _REGISTRY


def metrics_enabled() -> bool:
    """Whether instrumentation should record."""
    return _ENABLED


def enable_metrics(on: bool = True) -> None:
    """Switch metrics recording on or off for the whole process."""
    global _ENABLED
    _ENABLED = bool(on)


def reset_metrics_enabled() -> None:
    """Back to the default: metrics off."""
    enable_metrics(False)
