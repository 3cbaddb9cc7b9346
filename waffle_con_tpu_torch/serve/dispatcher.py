"""Cross-job dynamic batching at the scorer-call boundary.

The port of ``waffle_con_tpu``'s ``serve/dispatcher.py``.  The engines'
host search is strictly sequential *within* a job — each blocking scorer
call depends on the previous one's result — so a single job can never
batch with itself.  But N concurrent jobs each have at most one call in
flight at any moment, and each call pays the same launch and transfer
overhead.  :class:`BatchingDispatcher` is the coalescing point: worker
threads park their job's next call in a shared pend list, a single
dispatcher thread collects everything that arrives within a bounded
batching window, gangs the parked ``run_extend`` calls of different jobs
into one launch of the gang kernel through the serving pool
(:mod:`waffle_con_tpu_torch.ops.ragged`: different read counts, band
widths and search constants in one launch), then runs the batch grouped
by *bucket* (backend + padded read count and read length + alphabet),
each call its own ``fn()`` against its own scorer, in submission order
within a group; a ganged call's ``fn()`` returns its deposit at once.

Results stay byte-identical to serial execution: a ganged member's
result is its solo launch's, and every other call runs as it would
alone.  Batch occupancy (calls per executed group) and the gang's
occupancy are the quantities to watch (:meth:`BatchingDispatcher.stats`).

When a job is alone (``active_jobs <= 1``), a call falls through to a
direct call on the worker thread: a single-tenant service pays no
batching-window latency at all.

:class:`CoalescingScorer` is the per-job proxy that routes the scorer
protocol's blocking calls (the vocabulary of ``obs.TimedScorer``) into
the dispatcher; everything else — attribute reads, capability probes
(``getattr(scorer, "run_extend", None)``), the two-way live ``counters``
view — passes through untouched, so engines cannot tell they are being
served.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import slo as obs_slo
from waffle_con_tpu_torch.obs import trace as obs_trace
from waffle_con_tpu_torch.obs.instrument import TIMED_OPS
from waffle_con_tpu_torch.ops import ragged as ops_ragged
from waffle_con_tpu_torch.ops.scorer import resolve_stats
from waffle_con_tpu_torch.serve.job import ServiceClosed

logger = logging.getLogger(__name__)


def _pow2_ceil(n: int) -> int:
    return 1 << (n - 1).bit_length() if n > 0 else 0


def bucket_key(scorer) -> tuple:
    """Shape bucket of a job's scorer: jobs in the same bucket launch the
    same kernel plans (backend + power-of-two-padded read count and max
    read length + alphabet size), so running them consecutively keeps one
    geometry's state hot instead of ping-ponging."""
    reads = getattr(scorer, "reads", []) or []
    config = getattr(scorer, "config", None)
    backend = getattr(config, "backend", "?")
    max_len = max((len(r) for r in reads), default=0)
    return (
        backend,
        _pow2_ceil(len(reads)),
        _pow2_ceil(max_len),
        int(getattr(scorer, "num_symbols", 0) or 0),
    )


class _DispatchRequest:
    __slots__ = ("ticket", "bucket", "op", "fn", "ragged", "result",
                 "exception", "done", "ctx", "enqueued_at")

    def __init__(self, ticket, bucket, op, fn, ragged=None) -> None:
        self.ticket = ticket
        self.bucket = bucket
        self.op = op
        self.fn = fn
        # optional ragged payload (probe_fn, args, kwargs): the
        # dispatcher may gang this run_extend with other jobs' through
        # the serving pool (see ops.ragged)
        self.ragged = ragged
        self.result = None
        self.exception: Optional[BaseException] = None
        self.done = threading.Event()
        # the submitting worker's trace context rides along so the
        # dispatcher thread can re-activate it around execution — the
        # dispatch span then lands under the job's pid, parented by the
        # worker-side search span (see obs/trace.py context contract)
        self.ctx = obs_trace.current_context()
        self.enqueued_at = time.perf_counter()


class BatchingDispatcher:
    """Single-threaded executor coalescing concurrent scorer dispatches.

    ``window_s`` bounds how long the first request of a batch waits for
    company; ``max_batch`` bounds how much company it waits *for* (the
    wait target is ``min(max_batch, active_jobs)`` — there is no point
    waiting for more requests than there are jobs able to send one).

    With ``adaptive_window`` (default on) the wait inside that cap is
    arrival-rate-predictive: the dispatcher keeps an EWMA of recent
    inter-arrival gaps and, after each arrival, holds only
    ``max(4 x ewma_gap, window_s / 4)`` for the next one (clamped to
    the configured window).  Under a burst the gaps are tiny, the hold
    refreshes per arrival, and the gang fills to target; when arrivals
    stall the batch launches early instead of idling out the full
    fixed window.  Worst-case added latency is unchanged (the absolute
    ``window_s`` cap from first park still applies); a cold EWMA falls
    back to the fixed window.  The chosen hold is surfaced in
    :meth:`stats` (and from there in serve evidence).

    ``arena`` pins the ragged pass to one serving pool; ``None`` uses the
    process arena.
    """

    #: EWMA smoothing for inter-arrival gaps (~last 10 arrivals)
    EWMA_ALPHA = 0.2

    def __init__(
        self,
        window_s: float = 0.002,
        max_batch: int = 8,
        name: str = "consensus",
        adaptive_window: bool = True,
        arena=None,
    ) -> None:
        if window_s < 0:
            raise ValueError("window_s must be >= 0")
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.window_s = window_s
        self.max_batch = max_batch
        self.adaptive_window = adaptive_window
        self._arena = arena
        self._name = name
        self._cond = threading.Condition()
        self._pending: List[_DispatchRequest] = []
        self._active_jobs = 0
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        # adaptive-hold state (all under the lock): monotonic time of
        # the last routed arrival, the smoothed gap, and the hold the
        # batching loop last chose
        self._last_arrival: Optional[float] = None
        self._ewma_gap: Optional[float] = None
        self._last_hold_s: float = window_s
        self._hold_sum = 0.0
        self._hold_batches = 0
        # internal stats, always maintained (cheap ints under the lock);
        # the obs serve_* metrics mirror them when metrics are enabled
        self._stats = {
            "coalesced_batches": 0,   # executed groups with >= 2 requests
            "solo_batches": 0,        # executed groups of exactly 1
            "routed_requests": 0,     # requests through the dispatcher
            "direct_dispatches": 0,   # fell through (job alone / closed)
            "occupancy_sum": 0,
            "occupancy_max": 0,
            # ragged gang accounting (tentpole) plus the bucketed
            # baseline's run-dispatch clustering, so the two occupancy
            # numbers compare apples to apples in bench evidence
            "ragged_groups": 0,       # ragged kernel calls (>= 2 members)
            "ragged_members": 0,      # run dispatches ganged into them
            "ragged_occupancy_max": 0,
            "run_clusters": 0,        # executed groups containing runs
            "run_cluster_requests": 0,
        }

    # -- lifecycle -----------------------------------------------------

    def start(self) -> None:
        with self._cond:
            if self._thread is not None or self._closed:
                return
            self._thread = lockcheck.make_thread(
                target=self._loop,
                name=f"waffle-serve-{self._name}-dispatcher",
                daemon=True,
            )
            self._thread.start()

    def close(self) -> None:
        """Stop the dispatcher thread; drains already-parked requests
        before exiting, then fails anything that raced in."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            thread = self._thread
        if thread is not None:
            thread.join()
        with self._cond:
            leftovers = self._pending[:]
            del self._pending[:]
        for req in leftovers:
            req.exception = ServiceClosed("dispatcher closed mid-dispatch")
            req.done.set()

    # -- job accounting ------------------------------------------------

    def job_started(self) -> None:
        with self._cond:
            self._active_jobs += 1

    def job_finished(self) -> None:
        with self._cond:
            self._active_jobs = max(0, self._active_jobs - 1)

    # -- the dispatch path ---------------------------------------------

    def dispatch(self, ticket, bucket: tuple, op: str, fn, ragged=None):
        """Run one blocking scorer dispatch, coalescing with concurrent
        jobs when possible.  ``ticket.check_abort(op)`` gates both entry
        and execution so cancellations/deadlines bite at this boundary.
        ``ragged`` optionally carries the probe payload letting the
        dispatcher gang this call across jobs (direct fall-through
        ignores it — a lone job has nobody to gang with).
        """
        if ticket is not None:
            ticket.check_abort(op)
        with self._cond:
            direct = (
                self._closed
                or self._thread is None
                or not self._thread.is_alive()
                or self._active_jobs <= 1
                or self.window_s <= 0
                or threading.current_thread() is self._thread
            )
            if direct:
                self._stats["direct_dispatches"] += 1
            else:
                req = _DispatchRequest(ticket, bucket, op, fn, ragged)
                now = time.monotonic()
                if self._last_arrival is not None:
                    # idle stretches are not "inter-arrival" signal:
                    # clamp the sample so one quiet second cannot park
                    # the EWMA above the window for the next burst
                    gap = min(now - self._last_arrival, 4 * self.window_s)
                    self._ewma_gap = (
                        gap if self._ewma_gap is None
                        else (self.EWMA_ALPHA * gap
                              + (1 - self.EWMA_ALPHA) * self._ewma_gap)
                    )
                self._last_arrival = now
                self._pending.append(req)
                self._stats["routed_requests"] += 1
                self._cond.notify_all()
        if direct:
            if obs_metrics.metrics_enabled():
                obs_metrics.registry().counter(
                    "waffle_serve_direct_dispatches_total",
                    service=self._name,
                ).inc()
            t0 = time.perf_counter()
            try:
                return fn()
            finally:
                dt = time.perf_counter() - t0
                obs_slo.observe_dispatch(dt)
                obs_flight.record(
                    "dispatch", trace_id=obs_trace.current_trace_id(),
                    op=op, path="direct", total_ms=round(dt * 1e3, 3),
                )
        # park until the dispatcher delivers; poll so a dispatcher that
        # died on an unexpected error cannot strand the worker forever
        while not req.done.wait(0.25):
            with self._cond:
                thread_dead = (
                    self._thread is None or not self._thread.is_alive()
                )
            if thread_dead and not req.done.is_set():
                raise ServiceClosed(
                    "batching dispatcher thread died mid-dispatch"
                )
        if req.exception is not None:
            raise req.exception
        return req.result

    # -- dispatcher thread ---------------------------------------------

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._closed:
                    self._cond.wait()
                if self._closed and not self._pending:
                    return
                # bounded batching window: wait for company up to
                # window_s, but never for more requests than there are
                # other active jobs to send them.  Inside that cap the
                # adaptive hold trims the wait to a multiple of the
                # observed inter-arrival gap, refreshed per arrival.
                target = min(self.max_batch, max(2, self._active_jobs))
                cap = time.monotonic() + self.window_s
                hold = self.window_s
                while len(self._pending) < target and not self._closed:
                    now = time.monotonic()
                    if self.adaptive_window and self._ewma_gap is not None:
                        hold = min(
                            self.window_s,
                            max(4 * self._ewma_gap, self.window_s / 4),
                        )
                        deadline = min(
                            cap, (self._last_arrival or now) + hold
                        )
                    else:
                        deadline = cap
                    remaining = deadline - now
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                self._last_hold_s = hold
                self._hold_sum += hold
                self._hold_batches += 1
                batch = self._pending[:]
                del self._pending[:]
            self._execute(batch)

    def _execute(self, batch: List[_DispatchRequest]) -> None:
        # ragged pass FIRST: gang eligible run_extend calls from
        # different buckets and band widths into gang launches.  Each
        # member's result is deposited as a consume-once result that its
        # ordinary fn() below returns at once, so execution order,
        # tracing, supervision and error delivery are untouched (a failed
        # launch's deposit raises in the member's fn()); anything the
        # pass cannot take runs solo, counted by reason in the pool.
        injected_keys: List[tuple] = []
        if len(batch) > 1 and ops_ragged.enabled(self._arena):
            injected_keys = self._ragged_pass(batch)
        try:
            self._execute_groups(batch)
        finally:
            # a member whose dispatch raised before reaching the scorer
            # (abort/deadline) must not leave a stale injection behind
            if injected_keys:
                ops_ragged.discard_injected(injected_keys, arena=self._arena)

    def _ragged_pass(self, batch: List[_DispatchRequest]) -> List[tuple]:
        specs = []
        seen_scorers = set()
        for req in batch:
            if req.ragged is None:
                continue
            try:
                spec = ops_ragged.probe(
                    req.ragged, req.ticket, arena=self._arena
                )
            except Exception:  # noqa: BLE001 - probe failure = solo
                logger.debug("ragged probe failed", exc_info=True)
                continue
            if spec is None:
                continue
            # one scorer may not appear twice in a gang (its page run
            # would collide); the duplicate runs solo this round
            sid = id(spec.scorer)
            if sid in seen_scorers:
                continue
            seen_scorers.add(sid)
            specs.append(spec)
        if len(specs) < 2:
            return []
        keys: List[tuple] = []
        gang = ops_ragged.gang_width(self._arena)
        for i in range(0, len(specs), gang):
            chunk = specs[i:i + gang]
            if len(chunk) < 2:
                break  # a trailing singleton just runs solo
            with obs_trace.span(
                "serve:ragged", "serve", members=len(chunk)
            ):
                got = ops_ragged.run_group(chunk, arena=self._arena)
            if not got:
                continue
            keys.extend(got)
            with self._cond:
                self._stats["ragged_groups"] += 1
                self._stats["ragged_members"] += len(got)
                self._stats["ragged_occupancy_max"] = max(
                    self._stats["ragged_occupancy_max"], len(got)
                )
        return keys

    def _execute_groups(self, batch: List[_DispatchRequest]) -> None:
        # group by shape bucket, preserving arrival order within and
        # across groups (first-seen bucket runs first)
        groups: Dict[tuple, List[_DispatchRequest]] = {}
        for req in batch:
            groups.setdefault(req.bucket, []).append(req)
        metrics_on = obs_metrics.metrics_enabled()
        for bucket, reqs in groups.items():
            occupancy = len(reqs)
            run_reqs = sum(1 for r in reqs if r.op == "run")
            with self._cond:
                if occupancy > 1:
                    self._stats["coalesced_batches"] += 1
                else:
                    self._stats["solo_batches"] += 1
                self._stats["occupancy_sum"] += occupancy
                self._stats["occupancy_max"] = max(
                    self._stats["occupancy_max"], occupancy
                )
                if run_reqs:
                    self._stats["run_clusters"] += 1
                    self._stats["run_cluster_requests"] += run_reqs
            if metrics_on:
                obs_metrics.registry().histogram(
                    "waffle_serve_batch_occupancy",
                    buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
                    service=self._name,
                ).observe(occupancy)
            with obs_trace.span(
                "serve:batch", "serve",
                bucket=str(bucket), occupancy=occupancy,
            ):
                for req in reqs:
                    # run under the submitting job's trace context: the
                    # dispatch span gets the job's pid and parents under
                    # the parked worker's search span (safe: that worker
                    # is blocked on req.done until we set it)
                    prev_ctx = obs_trace.set_current_context(req.ctx)
                    t0 = time.perf_counter()
                    try:
                        if req.ticket is not None:
                            req.ticket.check_abort(req.op)
                        # coalesced execution crosses a thread boundary:
                        # force any deferred-sync stats NOW, on the
                        # dispatching thread, so the worker receives a
                        # fully materialized result (async-seam
                        # fall-through — deferral is only safe while
                        # the consumer is the dispatching thread)
                        req.result = resolve_stats(req.fn())
                    except BaseException as exc:  # delivered to the worker
                        req.exception = exc
                    finally:
                        dt = time.perf_counter() - t0
                        obs_slo.observe_dispatch(
                            time.perf_counter() - req.enqueued_at
                        )
                        obs_flight.record(
                            "dispatch",
                            trace_id=(req.ctx.trace_id
                                      if req.ctx is not None else None),
                            op=req.op, path="coalesced",
                            occupancy=occupancy,
                            exec_ms=round(dt * 1e3, 3),
                            queue_ms=round(
                                (t0 - req.enqueued_at) * 1e3, 3
                            ),
                            error=(repr(req.exception)
                                   if req.exception is not None else None),
                        )
                        obs_trace.set_current_context(prev_ctx)
                        req.done.set()

    # -- introspection -------------------------------------------------

    def stats(self) -> Dict:
        with self._cond:
            s = dict(self._stats)
            s["adaptive_window"] = self.adaptive_window
            s["window_s"] = self.window_s
            s["last_hold_ms"] = round(self._last_hold_s * 1e3, 4)
            s["mean_hold_ms"] = round(
                (self._hold_sum / self._hold_batches * 1e3)
                if self._hold_batches else self.window_s * 1e3, 4
            )
            s["ewma_arrival_gap_ms"] = (
                round(self._ewma_gap * 1e3, 4)
                if self._ewma_gap is not None else None
            )
        batches = s["coalesced_batches"] + s["solo_batches"]
        s["batches"] = batches
        s["mean_batch_occupancy"] = (
            s["occupancy_sum"] / batches if batches else 0.0
        )
        s["ragged_mean_occupancy"] = (
            s["ragged_members"] / s["ragged_groups"]
            if s["ragged_groups"] else 0.0
        )
        s["run_cluster_mean_occupancy"] = (
            s["run_cluster_requests"] / s["run_clusters"]
            if s["run_clusters"] else 0.0
        )
        return s


class CoalescingScorer:
    """Per-job scorer proxy routing blocking calls into a shared
    :class:`BatchingDispatcher`.

    Same transparency contract as ``obs.TimedScorer`` (which it may be
    stacked on top of): attribute access falls through to the wrapped
    scorer so capability feature-tests see exactly the backend's
    surface, ``counters`` stays a live two-way view (the supervisor
    swaps in shared dicts by plain assignment), and wrapped methods are
    cached in the instance dict after first touch — safe because the
    wrapped scorer's capability surface is fixed after construction.
    """

    def __init__(self, base, dispatcher: BatchingDispatcher, ticket) -> None:
        self._base = base
        self._dispatcher = dispatcher
        self._ticket = ticket
        self._bucket = bucket_key(base)

    @property
    def counters(self):
        return self._base.counters

    @counters.setter
    def counters(self, value):
        self._base.counters = value

    @property
    def coalesce_bucket(self) -> tuple:
        return self._bucket

    def __getattr__(self, name: str):
        base = self.__dict__["_base"]
        attr = getattr(base, name)
        op = TIMED_OPS.get(name)
        if op is None or not callable(attr):
            return attr
        dispatcher = self.__dict__["_dispatcher"]
        ticket = self.__dict__["_ticket"]
        bucket = self.__dict__["_bucket"]
        # run_extend calls carry the ragged probe hop when the wrapped
        # stack exposes one (TorchScorer and BackendSupervisor do; the
        # python and native backends don't) — resolution down to the
        # live endpoint happens on the dispatcher thread, so a
        # mid-flight backend demotion is seen, not raced
        probe_attr = (
            getattr(base, "ragged_run_probe", None)
            if name == "run_extend" else None
        )

        def routed(*args, **kwargs):
            payload = (
                (probe_attr, args, kwargs)
                if probe_attr is not None else None
            )
            return dispatcher.dispatch(
                ticket, bucket, op, lambda: attr(*args, **kwargs),
                ragged=payload,
            )

        routed.__name__ = name
        self.__dict__[name] = routed
        return routed
