"""Observability of the port: tracing, metrics, search reports, audits.

The port of ``waffle_con_tpu``'s ``obs`` package.  Every piece is **off
by default** and near-zero-cost when off, and is switched on in code (the
port reads no environment variable):

* :mod:`~waffle_con_tpu_torch.obs.trace` — span-based host tracer
  (search -> scorer call) exporting Chrome trace-event JSON, with an
  optional :func:`torch.profiler.record_function` bridge:
  ``get_tracer().enable(True)``, ``.enable_profiler_bridge(True)``.
* :mod:`~waffle_con_tpu_torch.obs.metrics` — process-wide registry of
  counters, gauges and histograms (per-backend scorer-call latency,
  queue depth, branches per call, live branch handles) with JSON and
  Prometheus-text exposition: ``enable_metrics(True)``.
* :mod:`~waffle_con_tpu_torch.obs.report` — :class:`SearchReport`, the
  structured per-search summary every engine stores as
  ``last_search_report`` (always on).
* :mod:`~waffle_con_tpu_torch.obs.instrument` — the ``TimedScorer``
  proxy metrics and tracing install, and the frontier sampler.
* :mod:`~waffle_con_tpu_torch.obs.audit` — the decision recorder
  (``capture()``), the first-divergence differ (``diff_logs``) and the
  lockstep shadow against the python oracle (``shadow_override``).
"""

from waffle_con_tpu_torch.obs.metrics import (  # noqa: F401
    DEFAULT_COUNT_BUCKETS,
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    enable_metrics,
    metrics_enabled,
    registry,
    reset_metrics_enabled,
)
from waffle_con_tpu_torch.obs.report import SearchReport  # noqa: F401
from waffle_con_tpu_torch.obs.trace import (  # noqa: F401
    JOB_PID_BASE,
    NULL_SPAN,
    TraceContext,
    Tracer,
    current_context,
    current_trace_id,
    get_tracer,
    set_current_context,
    span,
    tracing_enabled,
)

