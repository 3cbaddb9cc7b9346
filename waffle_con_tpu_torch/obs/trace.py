"""Span-based host-side tracer with Chrome trace-event export.

The port of ``waffle_con_tpu``'s ``obs/trace.py``.  The engines (one
``search`` span per ``consensus()``) and the scorer instrumentation
(:class:`~waffle_con_tpu_torch.obs.instrument.TimedScorer`, one
``dispatch:<op>`` span per scorer call) open nested wall-clock
**spans**; finished spans are recorded as Chrome trace-event ``"ph":
"X"`` complete events, exported with :meth:`Tracer.write_chrome_trace`
and viewable in Perfetto (https://ui.perfetto.dev) or
``chrome://tracing``.

Profiler bridge: with :meth:`Tracer.enable_profiler_bridge` on, every
span also enters a :func:`torch.profiler.record_function` range, so in a
:mod:`torch.profiler` trace a span encloses the kernel launches made
inside it (the JAX package bridges to ``jax.profiler.TraceAnnotation``
the same way).

Overhead contract: with tracing off (the default; the port reads no
environment variable, :meth:`Tracer.enable` switches it), :func:`span`
returns a shared no-op context manager singleton — no allocation, no
timestamps, no lock.

Trace contexts: a :class:`TraceContext` gives a search its own trace
identity — a ``trace_id`` string, a dedicated Chrome ``pid`` and a stack
of open span ids carrying parent linkage.  :func:`set_current_context`
activates one for the calling thread; :func:`current_trace_id` is what
search reports and audit records carry.

Example::

    from waffle_con_tpu_torch.obs import trace

    tracer = trace.get_tracer()
    tracer.enable(True)
    tracer.enable_profiler_bridge(True)
    engine.consensus()
    tracer.write_chrome_trace("search.json")
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional


class _NullSpan:
    """Shared no-op span: the entire disabled-mode cost."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class TraceContext:
    """Per-search trace identity and parent linkage.

    ``trace_id`` names the trace (e.g. ``"consensus/search-3"``),
    ``chrome_pid`` is the Chrome trace ``pid`` the search's spans render
    under, and the span-id stack carries parent linkage for spans opened
    on the thread that runs the search.
    """

    __slots__ = ("trace_id", "chrome_pid", "label", "root_parent",
                 "_stack", "_next_id")

    def __init__(self, trace_id: str, chrome_pid: int, label: str = "",
                 span_base: int = 0,
                 root_parent: Optional[int] = None) -> None:
        self.trace_id = trace_id
        self.chrome_pid = int(chrome_pid)
        self.label = label or trace_id
        #: parent span id for stack-root spans
        self.root_parent = root_parent
        self._stack: List[int] = []
        #: span ids count up from here
        self._next_id = int(span_base)

    def _open_span(self) -> "tuple[int, Optional[int]]":
        """Allocate a span id, returning ``(span_id, parent_id)``."""
        parent = self._stack[-1] if self._stack else self.root_parent
        self._next_id += 1
        span_id = self._next_id
        self._stack.append(span_id)
        return span_id, parent

    def _close_span(self, span_id: int) -> None:
        if self._stack and self._stack[-1] == span_id:
            self._stack.pop()
        elif span_id in self._stack:  # unbalanced exit: drop through it
            while self._stack and self._stack.pop() != span_id:
                pass

    def __repr__(self) -> str:
        return f"TraceContext({self.trace_id!r}, pid={self.chrome_pid})"


#: Chrome pids for trace contexts start here so they can never collide
#: with a real process pid on the same timeline
JOB_PID_BASE = 1_000_000


_CTX = threading.local()


def current_context() -> Optional[TraceContext]:
    """The calling thread's active trace context (``None`` when none is
    set)."""
    return getattr(_CTX, "ctx", None)


def current_trace_id() -> Optional[str]:
    ctx = getattr(_CTX, "ctx", None)
    return ctx.trace_id if ctx is not None else None


def set_current_context(ctx: Optional[TraceContext]) -> Optional[TraceContext]:
    """Install ``ctx`` as the calling thread's trace context; returns
    the previous one so callers can restore it (always-on and cheap: a
    single thread-local assignment)."""
    previous = getattr(_CTX, "ctx", None)
    _CTX.ctx = ctx
    return previous


class _Span:
    """A live span; appends one Chrome complete event on exit.  It binds
    to the calling thread's :class:`TraceContext` at entry."""

    __slots__ = (
        "_tracer", "name", "cat", "args", "_start_ns", "_prof_ctx",
        "_ctx", "_span_id", "_parent_id",
    )

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: Dict):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._prof_ctx = None

    def __enter__(self):
        ann = self._tracer._profiler_range
        if ann is not None:
            self._prof_ctx = ann(self.name)
            self._prof_ctx.__enter__()
        ctx = current_context()
        self._ctx = ctx
        if ctx is not None:
            self._span_id, self._parent_id = ctx._open_span()
        else:
            self._span_id = self._parent_id = None
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end_ns = time.perf_counter_ns()
        if self._prof_ctx is not None:
            self._prof_ctx.__exit__(*(exc or (None, None, None)))
        if self._ctx is not None:
            self._ctx._close_span(self._span_id)
        self._tracer._finish(self, self._start_ns, end_ns)
        return False


class Tracer:
    """Collects finished spans as Chrome trace events.

    Also keeps per-category cumulative inclusive wall time
    (:meth:`category_totals`), which the engines diff across a search to
    build the :class:`~waffle_con_tpu.obs.report.SearchReport` time
    breakdown.
    """

    def __init__(self) -> None:
        self._on = False
        self._lock = threading.Lock()
        self._events: List[Dict] = []
        self._totals: Dict[str, float] = {}
        self._t0_ns = time.perf_counter_ns()
        self._profiler_range = None  # set by enable_profiler_bridge()
        self._pid = os.getpid()
        self._named_pids: set = set()

    # -- enablement ----------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._on

    def enable(self, on: bool = True) -> None:
        self._on = bool(on)

    def reset_enabled(self) -> None:
        """Back to the default: tracing and the profiler bridge off."""
        self._on = False
        self._profiler_range = None

    def enable_profiler_bridge(self, on: bool = True) -> bool:
        """Wire spans to :func:`torch.profiler.record_function`; returns
        whether the bridge is active."""
        if not on:
            self._profiler_range = None
            return False
        from torch.profiler import record_function

        self._profiler_range = record_function
        return True

    # -- span lifecycle ------------------------------------------------

    def span(self, name: str, cat: str = "host", **args):
        """A context manager timing one nested region; the no-op
        singleton when tracing is disabled."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, cat, args)

    def _finish(self, span: _Span, start_ns: int, end_ns: int) -> None:
        ctx = span._ctx
        event = {
            "name": span.name,
            "cat": span.cat,
            "ph": "X",
            "ts": (start_ns - self._t0_ns) / 1e3,
            "dur": (end_ns - start_ns) / 1e3,
            "pid": self._pid if ctx is None else ctx.chrome_pid,
            "tid": threading.get_ident() % 2**31,
        }
        args = dict(span.args) if span.args else {}
        if ctx is not None:
            args["trace_id"] = ctx.trace_id
            args["span_id"] = span._span_id
            args["parent_id"] = span._parent_id
        if args:
            event["args"] = args
        dt = (end_ns - start_ns) / 1e9
        with self._lock:
            if ctx is not None and ctx.chrome_pid not in self._named_pids:
                self._named_pids.add(ctx.chrome_pid)
                self._events.append({
                    "name": "process_name",
                    "ph": "M",
                    "pid": ctx.chrome_pid,
                    "args": {"name": ctx.label},
                })
            self._events.append(event)
            self._totals[span.cat] = self._totals.get(span.cat, 0.0) + dt

    # -- export --------------------------------------------------------

    def chrome_events(self) -> List[Dict]:
        with self._lock:
            return [dict(e) for e in self._events]

    def category_totals(self) -> Dict[str, float]:
        """Cumulative inclusive seconds per span category."""
        with self._lock:
            return dict(self._totals)

    def clear(self) -> None:
        with self._lock:
            del self._events[:]
            self._totals.clear()
            self._named_pids.clear()

    def write_chrome_trace(self, path: str, events: Optional[List[Dict]] = None) -> None:
        """Write a Chrome trace-event JSON file (Perfetto-loadable)."""
        payload = {
            "traceEvents": self.chrome_events() if events is None else events,
            "displayTimeUnit": "ms",
        }
        with open(path, "w") as fh:
            json.dump(payload, fh)


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def span(name: str, cat: str = "host", **args):
    """Module-level shortcut for ``get_tracer().span(...)``."""
    return _TRACER.span(name, cat, **args)


def tracing_enabled() -> bool:
    return _TRACER.enabled
