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

Across processes (:mod:`waffle_con_tpu_torch.serve.procs`): the front
door ships a job's context on its ``SUBMIT`` frame
(:func:`context_to_wire`), the worker adopts it
(:func:`context_from_wire`: same trace id and Chrome pid, disjoint span
ids, root spans parented under the door's per-job span), drains the
job's events (:meth:`Tracer.drain_events`) onto its result frames, and
the door merges them onto its own clock
(:meth:`Tracer.ingest_remote_events`); :meth:`Tracer.flow` draws the
socket hops and :meth:`Tracer.record_span` the door's own phases.

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


def context_to_wire(ctx: TraceContext,
                    parent_span_id: Optional[int] = None,
                    span_base: int = 0,
                    flow_id: Optional[int] = None) -> Dict:
    """A :class:`TraceContext` as the plain-JSON dict a ``SUBMIT`` frame
    carries to a worker process (``serve.procs.wire.decode_trace``
    validates it on the receiving side)."""
    return {
        "trace_id": ctx.trace_id,
        "chrome_pid": ctx.chrome_pid,
        "label": ctx.label,
        "parent_span_id": parent_span_id,
        "span_base": int(span_base),
        "flow_id": flow_id,
    }


def context_from_wire(obj: Dict) -> TraceContext:
    """Rebuild an adopted :class:`TraceContext` from a wire dict: the
    minting process's trace id and Chrome pid, span ids allocated from the
    shipped disjoint base, stack-root spans parented under the minting
    side's per-job root span."""
    return TraceContext(
        str(obj["trace_id"]),
        int(obj["chrome_pid"]),
        label=str(obj.get("label") or ""),
        span_base=int(obj.get("span_base") or 0),
        root_parent=(int(obj["parent_span_id"])
                     if obj.get("parent_span_id") is not None else None),
    )


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
            if ctx is not None:
                self._name_pid(ctx)
            self._events.append(event)
            self._totals[span.cat] = self._totals.get(span.cat, 0.0) + dt

    def _name_pid(self, ctx: TraceContext) -> None:
        """The process-name metadata event of ``ctx``'s Chrome pid, once
        (call with the lock held)."""
        if ctx.chrome_pid not in self._named_pids:
            self._named_pids.add(ctx.chrome_pid)
            self._events.append({
                "name": "process_name",
                "ph": "M",
                "pid": ctx.chrome_pid,
                "args": {"name": ctx.label},
            })

    def flow(self, phase: str, flow_id: int, name: str = "coalesce",
             ctx: Optional[TraceContext] = None) -> None:
        """Append a Chrome flow event (``phase`` ``"s"`` where the hop
        starts, ``"f"`` where it ends), so a hop between threads or across
        the worker socket renders as an arrow in Perfetto.  ``ctx``
        overrides the thread's context (the front door and the worker
        draw socket-hop arrows from threads that never activate the
        job's context).  No-op when tracing is off."""
        if not self.enabled:
            return
        if ctx is None:
            ctx = current_context()
        event = {
            "name": name,
            "cat": "flow",
            "ph": phase,
            "id": int(flow_id),
            "ts": (time.perf_counter_ns() - self._t0_ns) / 1e3,
            "pid": self._pid if ctx is None else ctx.chrome_pid,
            "tid": threading.get_ident() % 2**31,
        }
        if phase == "f":
            event["bp"] = "e"  # bind the finish to the enclosing slice
        with self._lock:
            self._events.append(event)

    def record_span(self, ctx: TraceContext, name: str, cat: str,
                    start_mono_s: float, end_mono_s: float,
                    span_id: Optional[int] = None,
                    parent_id: Optional[int] = None, **args) -> None:
        """Append one complete event under ``ctx`` after the fact (the
        front door's queue wait and its whole per-job envelope):
        ``start_mono_s`` / ``end_mono_s`` are ``time.monotonic()``
        readings, mapped onto this tracer's clock through a paired sample
        of both clocks.  No-op when tracing is off."""
        if not self.enabled:
            return
        now_us = (time.perf_counter_ns() - self._t0_ns) / 1e3
        now_mono = time.monotonic()
        event = {
            "name": name,
            "cat": cat,
            "ph": "X",
            "ts": now_us - (now_mono - start_mono_s) * 1e6,
            "dur": max(0.0, (end_mono_s - start_mono_s) * 1e6),
            "pid": ctx.chrome_pid,
            "tid": threading.get_ident() % 2**31,
            "args": dict(args, trace_id=ctx.trace_id, span_id=span_id,
                         parent_id=parent_id),
        }
        dt = max(0.0, end_mono_s - start_mono_s)
        with self._lock:
            self._name_pid(ctx)
            self._events.append(event)
            self._totals[cat] = self._totals.get(cat, 0.0) + dt

    # -- cross-process stitching ---------------------------------------

    def unix_origin_us(self) -> float:
        """Unix-epoch microseconds at ``ts == 0`` of this tracer's clock,
        shipped beside a drained span buffer so another process can rebase
        it onto its own timeline."""
        return time.time() * 1e6 - (
            time.perf_counter_ns() - self._t0_ns
        ) / 1e3

    def drain_events(self, pid: int,
                     limit: Optional[int] = None) -> List[Dict]:
        """Remove and return this tracer's events of one Chrome pid (a
        served job's): the worker-side span buffer a ``RESULT`` /
        ``ERROR`` / ``CHECKPOINT`` frame carries back to the door.

        Process-name metadata stays (the door names the pid on its side).
        ``limit`` keeps only the latest events: spans complete children
        first, so the tail holds the enclosing spans and the job's root.
        """
        kept: List[Dict] = []
        out: List[Dict] = []
        with self._lock:
            for event in self._events:
                if event.get("pid") == pid and event.get("ph") != "M":
                    out.append(event)
                else:
                    kept.append(event)
            self._events[:] = kept
        if limit is not None and limit >= 0 and len(out) > limit:
            out = out[len(out) - limit:]
        return out

    def ingest_remote_events(self, events: List[Dict],
                             origin_us: Optional[float] = None,
                             worker: Optional[str] = None) -> int:
        """Merge another process's drained span events into this tracer,
        rebasing their timestamps onto this tracer's clock (``origin_us``
        is the remote :meth:`unix_origin_us`) and tagging each with
        ``worker``.  Returns the number of events kept."""
        if not self.enabled or not events:
            return 0
        shift = 0.0
        if origin_us is not None:
            try:
                shift = float(origin_us) - self.unix_origin_us()
            except (TypeError, ValueError):
                shift = 0.0
        stitched: List[Dict] = []
        for event in events:
            if not isinstance(event, dict):
                continue
            event = dict(event)
            try:
                event["ts"] = float(event.get("ts", 0.0)) + shift
            except (TypeError, ValueError):
                continue
            if worker:
                args = dict(event.get("args") or {})
                args.setdefault("worker", worker)
                event["args"] = args
            stitched.append(event)
        with self._lock:
            self._events.extend(stitched)
        return len(stitched)

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


def unix_origin_us() -> float:
    """Module-level :meth:`Tracer.unix_origin_us` passthrough."""
    return _TRACER.unix_origin_us()
