"""Dispatch instrumentation: a transparent latency-recording scorer proxy.

The port of ``waffle_con_tpu``'s ``obs/instrument.py``.
:class:`TimedScorer` wraps a concrete backend scorer and times every
scorer call the engines make, recording:

* ``waffle_dispatch_latency_seconds`` histogram per ``(backend, op)``;
* ``waffle_dispatch_total`` counter per ``(backend, op)``;
* ``waffle_dispatch_branches`` histogram per ``(backend, op)`` for the
  batched multi-branch calls (branches per call);
* ``waffle_handle_arena_live`` gauge, sampled every few calls from the
  backend's ``live_handles()`` (a host count, never a device read);
* a phase record (:mod:`~waffle_con_tpu_torch.obs.phases`) when phase
  profiling is on;

and opens a ``dispatch:<op>`` tracer span (category ``dispatch``) so
scorer calls nest inside the engines' ``search`` spans in the Chrome
trace — and, with the tracer's profiler bridge on, the kernel launches
of a call nest inside its ``record_function`` range.

The proxy is installed by ``construct_backend``
(:mod:`waffle_con_tpu_torch.ops.scorer`) only when metrics, tracing or
phase profiling is on; a run with all three off never pays for it. It is
transparent to the engines' capability probes (``FastPaths``): every
other attribute — the kernel launch planners' answers ``run_takes`` /
``run_dual_takes`` / ``arena_takes``, the ``ARENA_*`` sizes,
``ragged_run_probe``, the ``counters`` dict — falls through to the
wrapped backend, so ``getattr(scorer, "run_extend", None)`` is ``None``
exactly when the backend lacks the kernel and a wrapped search launches
the same kernels as a bare one.

:class:`FrontierSampler` is the search-frontier telemetry half: a
decimated per-pop sampler the engines feed (queue depth, live branch
count, best-vs-next cost gap, committed steps per run call, gang commit
rate) from host values only; its records land in a bounded ring
(:func:`frontier_samples`).
"""

from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional

from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import phases as obs_phases
from waffle_con_tpu_torch.obs import trace as obs_trace

#: scorer method -> short op label (the same vocabulary as the scorer
#: counter keys)
TIMED_OPS: Dict[str, str] = {
    "root": "root",
    "push": "push",
    "push_many": "push",
    "stats": "stats",
    "clone": "clone",
    "clone_many": "clone",
    "clone_push_many": "clone_push",
    "activate": "activate",
    "deactivate": "activate",
    "deactivate_many": "activate",
    "finalized_eds": "finalize",
    "best_activation_offset": "offset_scan",
    "run_extend": "run",
    "run_extend_dual": "run_dual",
    "run_arena": "arena",
}

#: ops whose first positional argument is a spec list (batched calls)
_BATCHED_OPS = frozenset(
    {"push_many", "clone_many", "clone_push_many", "deactivate_many"}
)

#: sample the handle-arena occupancy gauge every this many calls
_GAUGE_SAMPLE_EVERY = 16


class TimedScorer:
    """Latency/trace-recording proxy over a concrete backend scorer."""

    def __init__(self, base, backend: str) -> None:
        self._base = base
        self._backend = backend
        self._calls_since_gauge = 0

    # ``counters`` stays a live view of the backend's dict in both
    # directions
    @property
    def counters(self):
        return self._base.counters

    @counters.setter
    def counters(self, value):
        self._base.counters = value

    def _sample_arena_gauge(self) -> None:
        live_handles = getattr(self._base, "live_handles", None)
        if live_handles is None:
            return
        live = live_handles()
        obs_metrics.registry().gauge(
            "waffle_handle_arena_live", backend=self._backend
        ).set(live)

    def _wrap(self, name: str, op: str, fn):
        backend = self._backend
        batched = name in _BATCHED_OPS
        span = obs_trace.span

        def timed(*args, **kwargs):
            metrics_on = obs_metrics.metrics_enabled()
            # phase record: the dispatch seam attributes device and
            # transfer time into it; one boolean check when profiling
            # is off
            rec = obs_phases.begin(op, backend)
            with span(f"dispatch:{op}", "dispatch", backend=backend):
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    obs_phases.end(rec)
                    if metrics_on:
                        dt = time.perf_counter() - t0
                        reg = obs_metrics.registry()
                        reg.histogram(
                            "waffle_dispatch_latency_seconds",
                            backend=backend, op=op,
                        ).observe(dt)
                        reg.counter(
                            "waffle_dispatch_total", backend=backend, op=op
                        ).inc()
                        if batched and args:
                            reg.histogram(
                                "waffle_dispatch_branches",
                                buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
                                backend=backend, op=op,
                            ).observe(len(args[0]))
                        self._calls_since_gauge += 1
                        if self._calls_since_gauge >= _GAUGE_SAMPLE_EVERY:
                            self._calls_since_gauge = 0
                            self._sample_arena_gauge()

        timed.__name__ = name
        return timed

    def __getattr__(self, name: str):
        # normal lookup failed: delegate to the backend, wrapping timed
        # scorer methods once and caching the wrapper on the instance
        base = self.__dict__["_base"]
        attr = getattr(base, name)
        op = TIMED_OPS.get(name)
        if op is None or not callable(attr):
            return attr
        wrapped = self._wrap(name, op, attr)
        self.__dict__[name] = wrapped
        return wrapped


def maybe_instrument(scorer, backend: str):
    """Wrap ``scorer`` in a :class:`TimedScorer` when metrics, tracing or
    phase profiling is on; return it unchanged otherwise."""
    if (
        obs_metrics.metrics_enabled()
        or obs_trace.tracing_enabled()
        or obs_phases.profiling_enabled()
    ):
        return TimedScorer(scorer, backend)
    return scorer


#: pop decimation of the frontier sampler: one record per this many pops
#: (0 disables)
FRONTIER_SAMPLE_DEFAULT = 64

#: the most recent frontier records, oldest first
_FRONTIER_RING: collections.deque = collections.deque(maxlen=4096)


def frontier_samples() -> List[Dict]:
    """The most recent frontier records (up to 4,096), oldest first."""
    return list(_FRONTIER_RING)


class FrontierSampler:
    """Decimated per-pop search-frontier telemetry.

    One per search; the engine pop loops call :meth:`due` every pop (a
    modulo on an int) and, when it fires, :meth:`sample` with the
    frontier state in hand: pop count, queue depth, live branch count,
    best-vs-next cost gap, consensus progress, committed steps per run
    call and the frontier gang's commit rate — host values the engine
    already holds.
    """

    __slots__ = ("engine", "interval", "_t0", "_n")

    def __init__(self, engine_label: str) -> None:
        self.engine = engine_label
        self.interval = FRONTIER_SAMPLE_DEFAULT
        self._t0 = time.perf_counter()
        self._n = 0

    def due(self, pops: int) -> bool:
        return self.interval > 0 and pops % self.interval == 0

    def sample(
        self,
        pops: int,
        queue_depth: int,
        live_branches: int,
        top_cost: int,
        next_cost: Optional[int],
        top_len: int,
        farthest: int,
        counters: Optional[Dict[str, int]] = None,
        gang_width: Optional[int] = None,
    ) -> None:
        self._n += 1
        fields = {
            "engine": self.engine,
            "t_s": round(time.perf_counter() - self._t0, 4),
            "pops": int(pops),
            "queue": int(queue_depth),
            "live": int(live_branches),
            "top_cost": int(top_cost),
            "gap": (
                int(next_cost) - int(top_cost)
                if next_cost is not None else None
            ),
            "top_len": int(top_len),
            "farthest": int(farthest),
        }
        if counters:
            committed = (
                counters.get("run_steps", 0)
                + counters.get("run_dual_steps", 0)
            )
            calls = (
                counters.get("run_calls", 0)
                + counters.get("run_dual_calls", 0)
            )
            fields["steps_per_run"] = (
                round(committed / calls, 2) if calls else None
            )
            gi = counters.get("run_gang_injected", 0)
            gm = counters.get("run_gang_mispredict", 0)
            fields["gang_commit_rate"] = (
                round(gi / (gi + gm), 4) if (gi + gm) else None
            )
        if gang_width is not None:
            fields["gang_width"] = int(gang_width)
        fields["trace_id"] = obs_trace.current_trace_id()
        _FRONTIER_RING.append(fields)

    @property
    def samples_taken(self) -> int:
        return self._n
