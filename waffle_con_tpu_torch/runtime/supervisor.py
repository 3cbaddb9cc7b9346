"""Supervised backend dispatch with retry, demotion and re-promotion.

The port of ``waffle_con_tpu``'s ``runtime/supervisor.py``.
:class:`BackendSupervisor` is a
:class:`~waffle_con_tpu_torch.ops.scorer.WavefrontScorer` that owns a real
backend scorer and wraps every blocking scorer call with:

* an optional wall-clock timeout (``config.dispatch_timeout_s``);
* bounded retry with exponential backoff and jitter
  (``dispatch_retries`` / ``retry_backoff_s`` / ``retry_jitter``);
* result validation (NaN or negative score arrays raise
  :class:`GarbageStats` instead of poisoning the search);
* a circuit breaker: after ``breaker_threshold`` consecutive failures
  the live search is demoted to the next backend of the chain
  (:func:`effective_chain`: torch -> native -> python) and, after
  ``repromote_after`` clean calls, probed back up.

Demotion mid-search is exact because a branch's state is a deterministic
function of ``(read, consensus, offset, active)`` on every backend.  The
supervisor keeps a per-handle **ledger** of that tuple, updated only
after a call commits, and rebuilds branches from it as a checkpoint
resume does: fresh roots with no read active, the consensuses replayed
column by column through ``push_many`` (batched across branches; the
branch-step kernel on a CUDA device), then one ``activate`` per active
read at its offset (the column-replay kernel).  A retry of a call that
may have half-applied rebuilds the involved branches first; a demotion
or a re-promotion rebuilds every live branch on the new backend.

Every demotion is a ``backend_demoted`` event and a
``waffle_backend_demotions_total`` counter; a kernel that fails never
gives way quietly to its plain twin (the ``pallas_compile`` fault raises
in the kernel's dispatch rule, and only the supervisor's demotion moves
the search off the device).

The capability surface (``run_extend`` / ``run_extend_dual`` /
``run_arena`` / ``clone_push_many`` / ``ARENA_*``) is frozen at
construction, since the engines snapshot it once a search.  On a backend
lacking a frozen capability the wrapper reports a zero-step stop (the
run and arena paths; the engines fall through to the expand path) or
emulates it with clone and push (``clone_push_many``), both exact.  The
launch planners' answers (``run_takes`` and friends) are asked of the
current backend at call time.  The frontier gang's probe is not
forwarded: a gang deposit would bypass the ledger, so a supervised
search runs without that speculation (results are the same by
construction).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FuturesTimeout
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.ops.scorer import (
    BranchStats,
    WavefrontScorer,
    resolve_stats,
)
from waffle_con_tpu_torch.runtime import events, faults

logger = logging.getLogger(__name__)


def _metric_inc(name: str, **labels) -> None:
    """Bump a supervisor counter when the metrics pipeline is on."""
    if obs_metrics.metrics_enabled():
        obs_metrics.registry().counter(name, **labels).inc()


#: fallback order when ``config.backend_chain`` is not set: the device
#: branch store first, the Python executable-specification oracle last
_HEALTH_ORDER = ("torch", "native", "python")

#: optional fast paths the engines snapshot once a search
_FAST_PATHS = ("run_extend", "run_extend_dual", "run_arena",
               "clone_push_many")

#: every executor a supervisor made, live or abandoned after a timeout
#: (see :func:`shutdown_executors`)
_EXECUTORS: List[ThreadPoolExecutor] = []
_EXECUTORS_LOCK = threading.Lock()


def shutdown_executors(wait: bool = True) -> int:
    """Shut down (and with ``wait`` join) every executor a supervisor
    made, including those abandoned by a timeout whose call is still
    running.  Returns how many there were."""
    with _EXECUTORS_LOCK:
        pending = list(_EXECUTORS)
        del _EXECUTORS[:]
    for ex in pending:
        ex.shutdown(wait=wait)
    return len(pending)


class DispatchTimeout(RuntimeError):
    """A blocking scorer call exceeded ``config.dispatch_timeout_s``."""


class GarbageStats(RuntimeError):
    """A scorer call returned non-finite or negative score arrays."""


class BackendFailure(RuntimeError):
    """Every backend in the chain failed; the search cannot continue."""


def effective_chain(config: CdwfaConfig) -> Tuple[str, ...]:
    """The health-ordered backend chain of a config: the explicit
    ``backend_chain`` (deduplicated, forced to start at
    ``config.backend``), else the suffix of torch -> native -> python
    that starts at ``config.backend``."""
    explicit = getattr(config, "backend_chain", None)
    if explicit:
        chain = [config.backend]
        for b in explicit:
            if b not in chain:
                chain.append(b)
        return tuple(chain)
    return _HEALTH_ORDER[_HEALTH_ORDER.index(config.backend):]


class _HandleState:
    """Ledger entry: the portable state of one branch handle."""

    __slots__ = ("backend_h", "consensus", "active", "offsets")

    def __init__(self, backend_h, consensus, active, offsets):
        self.backend_h = backend_h
        self.consensus = bytes(consensus)
        self.active = list(active)
        self.offsets = list(offsets)

    def copy_state(self):
        return bytes(self.consensus), list(self.active), list(self.offsets)


def rebuild_branches(scorer: WavefrontScorer, states) -> List[int]:
    """Rebuild branches on ``scorer`` from ``(consensus, active,
    offsets)`` states and return their handles: roots with no read
    active, every consensus replayed column by column through
    ``push_many`` (batched across the branches), then each active read
    activated at its offset (offset 0 for a read tracked from the root:
    activation behind the frontier replays from its offset, so the state
    is the same)."""
    from waffle_con_tpu_torch.models.consensus import _replay_consensus

    states = list(states)
    zeros = np.zeros(scorer.num_reads, dtype=bool)
    handles = [scorer.root(zeros) for _ in states]
    _replay_consensus(scorer, [(h, c) for h, (c, _a, _o) in
                               zip(handles, states)])
    for h, (c, active, offsets) in zip(handles, states):
        for r, (a, off) in enumerate(zip(active, offsets)):
            if a:
                scorer.activate(h, r, int(off or 0), c)
    return handles


class BackendSupervisor(WavefrontScorer):
    """A fault-tolerant ``WavefrontScorer`` over a backend chain."""

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig) -> None:
        # no WavefrontScorer.__init__: the symbol table is the backend's
        # (every backend builds the same one), taken once one is built
        self.reads = list(reads)
        self.config = config
        self.counters: Dict[str, int] = {}
        self.chain = effective_chain(config)
        self._ledger: Dict[int, _HandleState] = {}
        self._next_handle = 0
        self._dispatch_index = 0
        self._consecutive_failures = 0
        self._successes_since_demotion = 0
        self._probe_interval = config.repromote_after
        #: a re-promotion probe is due before the next call (not at the
        #: end of the call that earned it: that call's caller has not yet
        #: entered its new handles in the ledger, and a migration then
        #: would leave them pointing into the old backend)
        self._probe_due = False
        self._executor: Optional[ThreadPoolExecutor] = None
        #: bumped on every backend swap, so :func:`fast_paths` snapshots
        #: over this scorer (or a view of it) re-resolve
        self.fastpath_gen = 0
        #: the device set pinned where the supervisor is built (a served
        #: job's worker thread): every backend it builds later, on
        #: whichever thread the failing call runs, is built under it
        from waffle_con_tpu_torch.parallel.mesh import current_device_set

        self._device_set = current_device_set()

        self._pos = None
        last_exc: Optional[Exception] = None
        for i, backend in enumerate(self.chain):
            try:
                scorer = self._new_backend(backend)
            except Exception as exc:  # noqa: BLE001 - any constructor failure
                events.record(
                    "backend_unavailable", backend=backend, error=repr(exc)
                )
                logger.warning("backend %s unavailable: %r", backend, exc)
                last_exc = exc
                continue
            self._pos = i
            self._scorer = scorer
            self._adopt_counters(scorer)
            break
        if self._pos is None:
            raise BackendFailure(
                f"no backend in chain {self.chain} could be constructed"
            ) from last_exc
        self.symtab, self.sym_id = self._scorer.symtab, self._scorer.sym_id
        self._capabilities = {
            name: getattr(self._scorer, name, None) is not None
            for name in _FAST_PATHS
        }
        events.record(
            "supervisor_started", chain=list(self.chain), backend=self.backend
        )

    # ------------------------------------------------------------------
    # backend life-cycle

    @property
    def backend(self) -> str:
        """Name of the backend currently serving calls."""
        return self.chain[self._pos]

    def _new_backend(self, backend: str) -> WavefrontScorer:
        from waffle_con_tpu_torch.ops.scorer import construct_backend
        from waffle_con_tpu_torch.parallel.mesh import use_device_set

        with use_device_set(self._device_set):
            return construct_backend(self.reads, self.config, backend)

    def _adopt_counters(self, scorer: WavefrontScorer) -> None:
        # accumulate across backends, then share one dict so both the
        # backend's increments and the engines' direct writes land here
        for k, v in dict(getattr(scorer, "counters", {}) or {}).items():
            self.counters[k] = self.counters.get(k, 0) + int(v)
        scorer.counters = self.counters

    def _migrate(self, scorer: WavefrontScorer) -> None:
        """Rebuild every ledger handle on ``scorer`` (all or nothing: the
        handles are swapped in once every rebuild worked)."""
        keys = list(self._ledger)
        rebuilt = rebuild_branches(
            scorer, [self._ledger[h].copy_state() for h in keys])
        for h, bh in zip(keys, rebuilt):
            self._ledger[h].backend_h = bh

    def _swap(self, pos: int, scorer: WavefrontScorer) -> str:
        old = self.backend
        self._release_ragged()
        self._pos = pos
        self._scorer = scorer
        self.fastpath_gen += 1
        self._probe_interval = self.config.repromote_after
        return old

    def _release_ragged(self) -> None:
        """A backend swap (demotion or re-promotion) rebuilds the live
        search on a fresh backend, so the outgoing scorer's serving-pool
        residency, if it has any, is released now: its pages would
        otherwise stay held until the job ends, and its pending deposits
        are stale against the rebuilt state."""
        rel = getattr(self._scorer, "ragged_release", None)
        if rel is None:
            return
        try:
            rel()
        except Exception:  # noqa: BLE001 - release must never block a swap
            logger.warning(
                "serving-pool release failed during backend swap",
                exc_info=True,
            )

    def ragged_run_probe(self, h: int):
        """The serving pool's hop through the supervisor: translate the
        engine's handle to the current backend's and delegate.  None
        whenever the live backend cannot take part; the call then runs
        solo through the supervised path."""
        inner = getattr(self._scorer, "ragged_run_probe", None)
        if inner is None:
            return None
        try:
            bh = self._ledger[h].backend_h
        except KeyError:
            return None
        return inner(bh)

    def _demote(self, cause: Exception) -> None:
        """Move down the chain, migrating the live search; raises
        :class:`BackendFailure` when the chain is exhausted."""
        while True:
            next_pos = self._pos + 1
            if next_pos >= len(self.chain):
                raise BackendFailure(
                    f"backend chain {self.chain} exhausted"
                ) from cause
            target = self.chain[next_pos]
            try:
                scorer = self._new_backend(target)
                self._adopt_counters(scorer)
                self._migrate(scorer)
            except Exception as exc:  # noqa: BLE001 - skip a dead rung
                events.record(
                    "backend_unavailable", backend=target, error=repr(exc)
                )
                logger.warning(
                    "fallback backend %s unavailable: %r", target, exc
                )
                self._pos = next_pos
                continue
            old = self._swap(next_pos, scorer)
            self._consecutive_failures = 0
            self._successes_since_demotion = 0
            events.record(
                "backend_demoted", from_backend=old, to_backend=target,
                handles=len(self._ledger), cause=repr(cause),
            )
            _metric_inc(
                "waffle_backend_demotions_total",
                from_backend=old, to_backend=target,
            )
            from waffle_con_tpu_torch.obs import flight, trace

            flight.trigger(
                "backend_demoted", trace_id=trace.current_trace_id(),
                from_backend=old, to_backend=target,
                handles=len(self._ledger), cause=repr(cause),
            )
            logger.warning(
                "demoting backend %s -> %s (%d live handles migrated): %r",
                old, target, len(self._ledger), cause,
            )
            return

    def _note_success(self) -> None:
        self._consecutive_failures = 0
        if self._pos == 0 or self._probe_interval is None:
            return
        self._successes_since_demotion += 1
        if self._successes_since_demotion >= self._probe_interval:
            self._successes_since_demotion = 0
            self._probe_due = True

    def _probe(self) -> None:
        """Try to re-promote one chain level: build the better backend,
        prove it live with a trivial call, then migrate."""
        target_pos = self._pos - 1
        target = self.chain[target_pos]
        try:
            if faults.poll(target, "probe", None) is not None:
                raise faults.InjectedFault("injected probe failure")
            scorer = self._new_backend(target)
            ph = scorer.root(np.zeros(self.num_reads, dtype=bool))
            self._validate(scorer.stats(ph, b""))
            scorer.free(ph)
            self._adopt_counters(scorer)
            self._migrate(scorer)
        except Exception as exc:  # noqa: BLE001 - a failed probe is benign
            events.record("probe_failed", backend=target, error=repr(exc))
            logger.info("re-promotion probe of %s failed: %r", target, exc)
            # back off exponentially so a flapping device is not probed
            # (and the search re-migrated) on a tight loop
            self._probe_interval *= 2
            return
        old = self._swap(target_pos, scorer)
        events.record(
            "backend_promoted", from_backend=old, to_backend=target,
            handles=len(self._ledger),
        )
        _metric_inc(
            "waffle_backend_promotions_total",
            from_backend=old, to_backend=target,
        )
        logger.warning(
            "re-promoted backend %s -> %s (%d live handles migrated)",
            old, target, len(self._ledger),
        )

    # ------------------------------------------------------------------
    # the supervised dispatch loop

    def _call_with_timeout(self, call):
        timeout = self.config.dispatch_timeout_s
        if not timeout:
            return call()
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="waffle-dispatch")
            with _EXECUTORS_LOCK:
                _EXECUTORS.append(self._executor)
        future = self._executor.submit(call)
        try:
            return future.result(timeout=timeout)
        except _FuturesTimeout:
            # the worker may still be inside the backend: abandon this
            # executor (shutdown_executors joins it) so the next call
            # gets a fresh thread
            future.cancel()
            self._executor.shutdown(wait=False)
            self._executor = None
            raise DispatchTimeout(
                f"dispatch exceeded {timeout}s on backend {self.backend}"
            ) from None

    @staticmethod
    def _validate(result) -> None:
        bad = _find_invalid(result)
        if bad is not None:
            raise GarbageStats(f"backend returned garbage scores: {bad}")

    def _sleep_backoff(self, attempt: int) -> None:
        base = self.config.retry_backoff_s
        if base <= 0:
            return
        delay = base * (2 ** (attempt - 1))
        delay *= 1.0 + self.config.retry_jitter * random.random()
        time.sleep(delay)

    def _supervised(
        self, op: str, involved: List[int], call,
        mutating: bool = True, validate: bool = True, scores=None,
    ):
        """Run ``call`` under the full policy: fault hooks, timeout,
        validation, retry with restore, circuit breaker, demotion.

        ``call`` must resolve backend handles through the ledger *at call
        time* (``self._bh``), so a re-run after a restore or a demotion
        targets the rebuilt handles on the current backend.  ``scores``
        picks the part of the result that holds its ``BranchStats`` (the
        whole result when ``None``), so resolution and validation do not
        walk an arena's event history or a run's integer records.
        """
        if self._probe_due:
            self._probe_due = False
            self._probe()
        attempts = 0
        while True:
            idx = self._dispatch_index
            self._dispatch_index += 1
            attempts += 1
            started = False
            try:
                spec = faults.poll(self.backend, op, idx)
                if spec is not None and spec.kind == "timeout":
                    raise faults.InjectedTimeout(
                        f"injected timeout at dispatch {idx} ({op})"
                    )
                if spec is not None and spec.kind == "device_loss":
                    raise faults.InjectedDeviceLoss(
                        f"injected device loss at dispatch {idx} ({op})"
                    )
                started = True
                result = self._call_with_timeout(call)
                if spec is not None and spec.kind == "garbage":
                    result = faults.mangle_stats(result)
                if validate:
                    part = result if scores is None else scores(result)
                    self._validate(resolve_stats(part))
            except Exception as exc:  # noqa: BLE001 - policy boundary
                self._consecutive_failures += 1
                events.record(
                    "dispatch_failed", backend=self.backend, op=op,
                    index=idx, attempt=attempts, error=repr(exc),
                )
                _metric_inc(
                    "waffle_dispatch_failures_total",
                    backend=self.backend, op=op,
                )
                logger.warning(
                    "dispatch %s failed on %s (attempt %d): %r",
                    op, self.backend, attempts, exc,
                )
                exhausted = attempts > self.config.dispatch_retries
                tripped = (
                    self._consecutive_failures
                    >= self.config.breaker_threshold
                )
                if exhausted or tripped:
                    self._demote(exc)
                    attempts = 0
                    continue
                _metric_inc(
                    "waffle_dispatch_retries_total",
                    backend=self.backend, op=op,
                )
                self._sleep_backoff(attempts)
                if mutating and started:
                    # the failed call may have half-applied: rebuild the
                    # involved branches from the ledger before retrying
                    try:
                        self._restore(involved)
                    except Exception as restore_exc:  # noqa: BLE001
                        self._demote(restore_exc)
                        attempts = 0
                continue
            self._note_success()
            return result

    def _restore(self, involved: List[int]) -> None:
        keys = [h for h in dict.fromkeys(involved) if h in self._ledger]
        for h in keys:
            try:
                self._scorer.free(self._ledger[h].backend_h)
            except Exception:  # noqa: BLE001 - stale slot on a sick device
                pass
        rebuilt = rebuild_branches(
            self._scorer, [self._ledger[h].copy_state() for h in keys])
        for h, bh in zip(keys, rebuilt):
            self._ledger[h].backend_h = bh
        events.record(
            "handles_restored", backend=self.backend, handles=len(involved)
        )

    # ------------------------------------------------------------------
    # ledger plumbing

    def _register(self, backend_h, consensus, active, offsets) -> int:
        h = self._next_handle
        self._next_handle += 1
        self._ledger[h] = _HandleState(backend_h, consensus, active, offsets)
        return h

    def _bh(self, h: int):
        return self._ledger[h].backend_h

    def live_handles(self) -> int:
        """Branch handles allocated and not yet freed."""
        return len(self._ledger)

    @staticmethod
    def _prune_active(st: _HandleState, act) -> None:
        for r in range(len(st.active)):
            if st.active[r] and not bool(act[r]):
                st.active[r] = False
                st.offsets[r] = None

    # ------------------------------------------------------------------
    # WavefrontScorer surface (core ops)

    def root(self, active: np.ndarray) -> int:
        mask = np.asarray(active, dtype=bool).copy()
        bh = self._supervised(
            "root", [], lambda: self._scorer.root(mask),
            mutating=False, validate=False,
        )
        return self._register(
            bh, b"",
            [bool(a) for a in mask],
            [0 if a else None for a in mask],
        )

    def clone(self, h: int) -> int:
        bh = self._supervised(
            "clone", [h], lambda: self._scorer.clone(self._bh(h)),
            mutating=False, validate=False,
        )
        return self._register(bh, *self._ledger[h].copy_state())

    def clone_many(self, hs: List[int]) -> List[int]:
        bhs = self._supervised(
            "clone", list(hs),
            lambda: self._scorer.clone_many([self._bh(x) for x in hs]),
            mutating=False, validate=False,
        )
        return [
            self._register(bh, *self._ledger[x].copy_state())
            for bh, x in zip(bhs, hs)
        ]

    def free(self, h: int) -> None:
        st = self._ledger.pop(h, None)
        if st is None:
            return
        try:
            self._scorer.free(st.backend_h)
        except Exception as exc:  # noqa: BLE001 - never fail a free
            logger.debug("backend free failed (ignored): %r", exc)

    def push(self, h: int, consensus: bytes) -> BranchStats:
        stats = self._supervised(
            "push", [h], lambda: self._scorer.push(self._bh(h), consensus)
        )
        self._ledger[h].consensus = bytes(consensus)
        return stats

    def push_many(
        self, specs: List[Tuple[int, bytes]]
    ) -> List[BranchStats]:
        out = self._supervised(
            "push",
            [h for h, _ in specs],
            lambda: self._scorer.push_many(
                [(self._bh(h), c) for h, c in specs]
            ),
        )
        for h, c in specs:
            self._ledger[h].consensus = bytes(c)
        return out

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        return self._supervised(
            "stats", [h],
            lambda: self._scorer.stats(self._bh(h), consensus),
            mutating=False,
        )

    def activate(
        self, h: int, read_index: int, offset: int, consensus: bytes
    ) -> None:
        self._supervised(
            "activate", [h],
            lambda: self._scorer.activate(
                self._bh(h), read_index, offset, consensus
            ),
            validate=False,
        )
        st = self._ledger[h]
        st.active[read_index] = True
        st.offsets[read_index] = int(offset)

    def deactivate(self, h: int, read_index: int) -> None:
        self._supervised(
            "activate", [h],
            lambda: self._scorer.deactivate(self._bh(h), read_index),
            validate=False,
        )
        st = self._ledger[h]
        st.active[read_index] = False
        st.offsets[read_index] = None

    def deactivate_many(self, pairs: List[Tuple[int, int]]) -> None:
        self._supervised(
            "activate", [h for h, _ in pairs],
            lambda: self._scorer.deactivate_many(
                [(self._bh(h), r) for h, r in pairs]
            ),
            validate=False,
        )
        for h, r in pairs:
            st = self._ledger[h]
            st.active[r] = False
            st.offsets[r] = None

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        return self._supervised(
            "finalize", [h],
            lambda: self._scorer.finalized_eds(self._bh(h), consensus),
            mutating=False,
        )

    def best_activation_offset(
        self, consensus, seq_index, offset_window, offset_compare_length,
        wildcard,
    ) -> int:
        return self._supervised(
            "activation_offset", [],
            lambda: self._scorer.best_activation_offset(
                consensus, seq_index, offset_window, offset_compare_length,
                wildcard,
            ),
            mutating=False, validate=False,
        )

    # ------------------------------------------------------------------
    # the launch planners' answers, asked of the current backend

    def run_takes(self) -> bool:
        fn = getattr(self._scorer, "run_takes", None)
        return True if fn is None else fn()

    def run_dual_takes(self) -> bool:
        fn = getattr(self._scorer, "run_dual_takes", None)
        return True if fn is None else fn()

    def arena_takes(self, Lw: int) -> bool:
        fn = getattr(self._scorer, "arena_takes", None)
        return True if fn is None else fn(Lw)

    # ------------------------------------------------------------------
    # optional fast paths (frozen capability surface, see docstring)

    @property
    def run_extend(self):
        return self._run_extend if self._capabilities["run_extend"] else None

    @property
    def run_extend_dual(self):
        if not self._capabilities["run_extend_dual"]:
            return None
        return self._run_extend_dual

    @property
    def run_arena(self):
        return self._run_arena if self._capabilities["run_arena"] else None

    @property
    def clone_push_many(self):
        if not self._capabilities["clone_push_many"]:
            return None
        return self._clone_push_many

    @property
    def ARENA_CAP(self):
        return getattr(self._scorer, "ARENA_CAP", 0)

    @property
    def ARENA_K(self):
        return getattr(self._scorer, "ARENA_K", 1)

    @property
    def ARENA_CRE_PER_EVENT(self):
        return getattr(self._scorer, "ARENA_CRE_PER_EVENT", 0)

    @property
    def ARENA_TAKE_MAX(self):
        return getattr(self._scorer, "ARENA_TAKE_MAX", 0)

    def _run_extend(self, h, consensus, *args, **kwargs):
        def call():
            fn = getattr(self._scorer, "run_extend", None)
            if fn is None:
                # demoted to a backend without the run kernel: a
                # zero-step stop; the engine adopts the (identical)
                # snapshot and takes the expand path
                return (
                    0, 0, b"",
                    self._scorer.stats(self._bh(h), consensus), [],
                )
            return fn(self._bh(h), consensus, *args, **kwargs)

        result = self._supervised("run", [h], call,
                                  scores=lambda r: r[3])
        if result[0] > 0:
            self._ledger[h].consensus = bytes(consensus) + result[2]
        return result

    def _run_extend_dual(self, h1, h2, consensus1, consensus2,
                         *args, **kwargs):
        def call():
            fn = getattr(self._scorer, "run_extend_dual", None)
            if fn is None:
                st1, st2 = self._ledger[h1], self._ledger[h2]
                return (
                    0, 0, b"", b"",
                    self._scorer.stats(self._bh(h1), consensus1),
                    self._scorer.stats(self._bh(h2), consensus2),
                    np.asarray(st1.active, dtype=bool),
                    np.asarray(st2.active, dtype=bool),
                    [],
                )
            return fn(
                self._bh(h1), self._bh(h2), consensus1, consensus2,
                *args, **kwargs,
            )

        result = self._supervised("run", [h1, h2], call,
                                  scores=lambda r: r[4:6])
        steps, _code, app1, app2 = result[:4]
        if steps > 0:
            st1, st2 = self._ledger[h1], self._ledger[h2]
            st1.consensus = bytes(consensus1) + app1
            st2.consensus = bytes(consensus2) + app2
            self._prune_active(st1, result[6])
            self._prune_active(st2, result[7])
        return result

    def _run_arena(self, node_specs, *args, **kwargs):
        create_mode = kwargs.get("create_mode", 0)

        def call():
            fn = getattr(self._scorer, "run_arena", None)
            if fn is None:
                # zero-step refusal: the engines' nsteps == 0 path
                # restores their queue state and falls back
                n = len(node_specs)
                return ([], 0, 0, -1, [0] * n, [], [], [], [True] * n, [])
            mapped = [
                (self._bh(h1), self._bh(h2) if h2 is not None else None,
                 l1, l2)
                for h1, h2, l1, l2 in node_specs
            ]
            return fn(mapped, *args, **kwargs)

        involved = [h for h1, h2, _, _ in node_specs
                    for h in (h1, h2) if h is not None]
        result = self._supervised("arena", involved, call,
                                  scores=lambda r: r[6])
        (_events, nsteps, _code, _stop, node_steps, appended,
         _sides_stats, sides_act, _alive, creations) = result
        if nsteps == 0:
            return result

        # mirror the engines' commit (models/consensus.py and
        # models/dual_consensus.py after the arena): extensions of the
        # original nodes first, then children in creation order — a
        # child's parent (possibly itself a child) is always built
        entries = [(h1, h2) for h1, h2, _, _ in node_specs]
        for i, (h1, h2) in enumerate(entries):
            if node_steps[i] == 0:
                continue
            st1 = self._ledger[h1]
            st1.consensus = st1.consensus + appended[2 * i]
            if create_mode == 2:
                self._prune_active(st1, sides_act[2 * i])
            if h2 is not None:
                st2 = self._ledger[h2]
                st2.consensus = st2.consensus + appended[2 * i + 1]
                if create_mode == 2:
                    self._prune_active(st2, sides_act[2 * i + 1])

        n_live = len(node_specs)
        for j, cre in enumerate(creations):
            idx = n_live + j
            ph1, ph2 = entries[cre["parent"]]
            p1 = self._ledger[ph1]
            cut = cre["created_len"] - 1
            cons1 = (p1.consensus[:cut] + bytes([cre["sym1"]])
                     + appended[2 * idx])
            if create_mode == 1:
                active1 = list(p1.active)
                offsets1 = list(p1.offsets)
            else:
                a1 = sides_act[2 * idx]
                active1 = [bool(a) for a in a1[: len(p1.active)]]
                offsets1 = [
                    p1.offsets[r] if active1[r] else None
                    for r in range(len(p1.active))
                ]
            ch1 = self._register(cre["h1"], cons1, active1, offsets1)
            cre["h1"] = ch1
            ch2 = None
            if cre["kind"] == 1 and cre.get("h2") is not None:
                src = self._ledger[ph2] if ph2 is not None else p1
                cons2 = (src.consensus[:cut] + bytes([cre["sym2"]])
                         + appended[2 * idx + 1])
                a2 = sides_act[2 * idx + 1]
                active2 = [bool(a) for a in a2[: len(src.active)]]
                offsets2 = [
                    src.offsets[r] if active2[r] else None
                    for r in range(len(src.active))
                ]
                ch2 = self._register(cre["h2"], cons2, active2, offsets2)
                cre["h2"] = ch2
            entries.append((ch1, ch2))
        return result

    def _clone_push_many(self, specs):
        def call():
            fn = getattr(self._scorer, "clone_push_many", None)
            if fn is not None:
                return fn([(self._bh(h), c, ip) for h, c, ip in specs])
            # emulated on a backend without the fused path (clone-only
            # gives stats None, in_place reuses the source slot)
            out = []
            for h, c, ip in specs:
                bh = self._bh(h)
                if c is None:
                    out.append((self._scorer.clone(bh), None))
                elif ip:
                    out.append((bh, self._scorer.push(bh, c)))
                else:
                    nh = self._scorer.clone(bh)
                    out.append((nh, self._scorer.push(nh, c)))
            return out

        res = self._supervised("clone_push", [h for h, _, _ in specs], call)
        out = []
        for (bh, st_stats), (h, c, ip) in zip(res, specs):
            src = self._ledger[h]
            if ip:
                src.consensus = bytes(c)
                src.backend_h = bh
                out.append((h, st_stats))
            else:
                cons = src.consensus if c is None else bytes(c)
                nh = self._register(bh, cons, src.active, src.offsets)
                out.append((nh, st_stats))
        return out


def _find_invalid(obj) -> Optional[str]:
    """First non-finite or negative score array in a call's result."""
    if isinstance(obj, BranchStats):
        for name in ("eds", "split", "occ"):
            bad = _bad_array(np.asarray(getattr(obj, name)), True)
            if bad is not None:
                return f"{bad} {name}"
        if obj.fin is not None:
            bad = _bad_array(np.asarray(obj.fin), False)
            if bad is not None:
                return f"{bad} fin"
        return None
    if isinstance(obj, np.ndarray):
        bad = _bad_array(obj, False)
        return None if bad is None else f"{bad} array"
    if isinstance(obj, (list, tuple)):
        for x in obj:
            if x is None or isinstance(x, (int, str, bytes)):
                continue
            bad = _find_invalid(x)
            if bad is not None:
                return bad
    return None


def _bad_array(arr: np.ndarray, signed: bool) -> Optional[str]:
    """``"non-finite"`` for a float array holding NaN or inf,
    ``"negative"`` (when ``signed``) for one below 0, else ``None``;
    integer arrays skip the finiteness test."""
    if not arr.size or arr.dtype.kind == "b":
        return None
    if arr.dtype.kind == "f" and not np.isfinite(arr).all():
        return "non-finite"
    if signed and arr.min() < 0:
        return "negative"
    return None
