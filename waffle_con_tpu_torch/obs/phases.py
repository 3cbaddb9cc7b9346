"""Phase-attributed dispatch profiling: where did each dispatch go?

The port of ``waffle_con_tpu``'s ``obs/phases.py``.  The dispatch
latency histograms (:mod:`waffle_con_tpu_torch.obs.instrument`) answer
*how long* each dispatch took; this module answers *where the time
went* inside one.  Every profiled dispatch is split into four phases:

* ``host_prep`` — host-side argument marshalling before the first
  device interaction (parameter rows, table padding, slot bookkeeping);
* ``device_compute`` — kernel execution.  On a CUDA device a pair of
  ``torch.cuda.Event`` s is recorded around the launches
  (:func:`device_scope`) and read when the record closes, so the card's
  own clock times the kernels and profiling adds no synchronisation of
  its own; on the CPU the launches are synchronous and the scope's wall
  is the compute;
* ``transfer`` — device-to-host result movement (the packed fetch),
  including a :class:`~waffle_con_tpu_torch.ops.scorer.DeferredStats`
  resolve that lands after the dispatch returned;
* ``host_post`` — the remainder: result decode, counter bookkeeping
  between the last device interaction and the dispatch's return.

Records are labelled by kernel family (``solo`` / ``dual`` / ``arena``
/ ``ragged`` / ``other``) and a geometry bucket (``B<br>R<reads>W<band>``)
so one run's profile separates the north-star geometry from small draws
sharing the process.

Enabling: :func:`enable_profiling` (the port reads no environment
variable).  With profiling off, :func:`begin` returns ``None`` after one
boolean check and no phase scope allocates anything.  Profiling is
independent of metrics — phase totals always aggregate process-wide
(for ``SearchReport`` and the service's stats); labelled histograms are
published only when metrics are also on.

Conservation property (tested): for an eagerly synced dispatch the four
phases sum to the dispatch wall exactly, because ``host_prep``,
``device_compute`` and ``transfer`` are measured and ``host_post`` is
defined as the remainder.  (On a CUDA device the device phase is the
card's time between the events; the dispatch waits for it in its fetch,
so it lies inside the wall.)  A deferred resolve after close is
accounted as late ``transfer`` in the aggregate (and flagged ``late`` on
the record).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

from waffle_con_tpu_torch.analysis import lockcheck

PHASES = ("host_prep", "device_compute", "transfer", "host_post")

#: kernel-family vocabulary for the ``kernel`` label
KERNEL_FAMILIES = ("solo", "dual", "arena", "ragged", "other")

#: bounded ring of recently closed records kept for introspection/tests
_RECENT_MAX = 256

#: set by :func:`enable_profiling` (off by default)
_ENABLED = False


def profiling_enabled() -> bool:
    """Whether dispatches record phase breakdowns."""
    return _ENABLED


def enable_profiling(on: bool = True) -> None:
    """Switch phase profiling on or off for the whole process."""
    global _ENABLED
    _ENABLED = bool(on)


def reset_profiling_enabled() -> None:
    """Back to the default: profiling off."""
    enable_profiling(False)


class DispatchRecord:
    """Phase accounting for ONE dispatch.

    Built by :func:`begin`, closed by :func:`end`.  The dispatch seam
    (``ops/torch_scorer.py`` / ``ops/ragged.py``) attributes device and
    transfer time into the active record via :func:`device_scope` /
    :func:`transfer_scope` and labels it via :meth:`annotate`;
    ``host_prep`` is everything before the first attributed phase and
    ``host_post`` is the unattributed remainder at close.  CUDA event
    pairs of the device phase wait in ``events`` until the record
    closes."""

    __slots__ = (
        "op", "backend", "kernel", "k", "geom", "t0", "device_s",
        "transfer_s", "t_first_phase", "wall_s", "closed", "late",
        "events",
    )

    def __init__(self, op: str, backend: str) -> None:
        self.op = op
        self.backend = backend
        self.kernel = "other"
        self.k = 1
        self.geom = ""
        self.device_s = 0.0
        self.transfer_s = 0.0
        self.t_first_phase: Optional[float] = None
        self.wall_s = 0.0
        self.closed = False
        self.late = False
        self.events: List = []
        self.t0 = time.perf_counter()

    def annotate(self, kernel: Optional[str] = None,
                 k: Optional[int] = None,
                 geom: Optional[str] = None) -> None:
        if kernel is not None:
            self.kernel = kernel
        if k is not None:
            self.k = int(k)
        if geom is not None:
            self.geom = geom

    def add_device(self, seconds: float, when: float) -> None:
        if self.t_first_phase is None:
            self.t_first_phase = when
        self.device_s += seconds

    def add_device_events(self, start, stop, when: float) -> None:
        """A CUDA event pair around launches; its time is read (and
        added to ``device_s``) when the record closes."""
        if self.t_first_phase is None:
            self.t_first_phase = when
        self.events.append((start, stop))

    def resolve_events(self) -> None:
        """Read every pending event pair's time into ``device_s`` (waits
        for the last one to complete)."""
        for start, stop in self.events:
            stop.synchronize()
            self.device_s += start.elapsed_time(stop) / 1e3
        self.events = []

    def add_transfer(self, seconds: float, when: float) -> None:
        if self.t_first_phase is None:
            self.t_first_phase = when
        self.transfer_s += seconds
        if self.closed:
            # a DeferredStats resolved after the dispatch returned:
            # publish the late transfer into the aggregate (the wall
            # time of the ORIGINAL dispatch is already final)
            self.late = True
            _publish_phase(self, "transfer", seconds)

    def phases(self) -> Dict[str, float]:
        """The four-phase breakdown (closed records only)."""
        prep = (
            (self.t_first_phase - self.t0)
            if self.t_first_phase is not None else 0.0
        )
        post = max(
            0.0, self.wall_s - prep - self.device_s - self.transfer_s
        )
        return {
            "host_prep": prep,
            "device_compute": self.device_s,
            "transfer": self.transfer_s,
            "host_post": post,
        }

    def to_dict(self) -> Dict:
        out = {
            "op": self.op,
            "backend": self.backend,
            "kernel": self.kernel,
            "k": self.k,
            "geom": self.geom,
            "wall_s": self.wall_s,
            "late": self.late,
        }
        out.update(self.phases())
        return out


#: the dispatch currently being profiled on this thread (dispatches
#: never nest: the engines issue one blocking scorer call at a time)
_ACTIVE = threading.local()

_agg_lock = lockcheck.make_lock("obs.phases.AGG")
#: (kernel, op, k, geom) -> {phase: seconds, "count": n, "wall_s": s}
_agg: Dict[Tuple[str, str, int, str], Dict[str, float]] = {}
_recent: List[DispatchRecord] = []


def begin(op: str, backend: str) -> Optional[DispatchRecord]:
    """Open a phase record for one dispatch; returns ``None`` (fast)
    when profiling is disabled or another record is already active on
    this thread (re-entrant proxy layers profile the OUTERMOST call)."""
    if not profiling_enabled():
        return None
    if getattr(_ACTIVE, "record", None) is not None:
        return None
    rec = DispatchRecord(op, backend)
    _ACTIVE.record = rec
    return rec


def end(rec: Optional[DispatchRecord]) -> None:
    """Close a record opened by :func:`begin` and publish it."""
    if rec is None:
        return
    rec.wall_s = time.perf_counter() - rec.t0
    if rec.events:
        rec.resolve_events()
    rec.closed = True
    if getattr(_ACTIVE, "record", None) is rec:
        _ACTIVE.record = None
    phases = rec.phases()
    key = (rec.kernel, rec.op, rec.k, rec.geom)
    with _agg_lock:
        slot = _agg.get(key)
        if slot is None:
            slot = {p: 0.0 for p in PHASES}
            slot["count"] = 0
            slot["wall_s"] = 0.0
            _agg[key] = slot
        for p in PHASES:
            slot[p] += phases[p]
        slot["count"] += 1
        slot["wall_s"] += rec.wall_s
        _recent.append(rec)
        del _recent[:-_RECENT_MAX]
    _publish_histograms(rec, phases)


def current() -> Optional[DispatchRecord]:
    """The active record on this thread (the dispatch seam's hook)."""
    return getattr(_ACTIVE, "record", None)


class _PhaseScope:
    """Context manager attributing its elapsed time to one phase of
    ``rec``; reusable closure-free object so the enabled path is two
    ``perf_counter`` calls and one float add."""

    __slots__ = ("_rec", "_add", "_t0")

    def __init__(self, rec: DispatchRecord, add) -> None:
        self._rec = rec
        self._add = add

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        now = time.perf_counter()
        self._add(now - self._t0, self._t0)
        return False


class _CudaPhaseScope:
    """Context manager recording a ``torch.cuda.Event`` pair around its
    body on the current stream of ``device``; the pair's time joins the
    record's device phase when the record closes."""

    __slots__ = ("_rec", "_device", "_start", "_t0")

    def __init__(self, rec: DispatchRecord, device) -> None:
        self._rec = rec
        self._device = device

    def __enter__(self):
        import torch

        self._t0 = time.perf_counter()
        self._start = torch.cuda.Event(enable_timing=True)
        self._start.record(torch.cuda.current_stream(self._device))
        return self

    def __exit__(self, *exc):
        import torch

        stop = torch.cuda.Event(enable_timing=True)
        stop.record(torch.cuda.current_stream(self._device))
        self._rec.add_device_events(self._start, stop, self._t0)
        return False


class _NullScope:
    """Shared no-op scope: the disabled path allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SCOPE = _NullScope()


def device_scope(rec: Optional[DispatchRecord], device=None):
    """Scope whose time is the dispatch's device-compute phase (wrap the
    launches).  On a CUDA ``device``: a CUDA event pair around the body,
    read at close; elsewhere the body's wall (CPU launches are
    synchronous)."""
    if rec is None:
        return NULL_SCOPE
    if device is not None and getattr(device, "type", device) == "cuda":
        return _CudaPhaseScope(rec, device)
    return _PhaseScope(rec, rec.add_device)


def transfer_scope(rec: Optional[DispatchRecord]):
    """Scope whose elapsed time is device-to-host transfer (wrap the
    fetch of a dispatch's results)."""
    if rec is None:
        return NULL_SCOPE
    return _PhaseScope(rec, rec.add_transfer)


def _publish_phase(rec: DispatchRecord, phase: str,
                   seconds: float) -> None:
    """Fold a late (post-close) phase contribution into the aggregate
    and, when metrics are on, the labeled histogram."""
    key = (rec.kernel, rec.op, rec.k, rec.geom)
    with _agg_lock:
        slot = _agg.get(key)
        if slot is not None:
            slot[phase] += seconds
    try:
        from waffle_con_tpu_torch.obs import metrics as obs_metrics

        if obs_metrics.metrics_enabled():
            obs_metrics.registry().histogram(
                "waffle_dispatch_phase_seconds",
                phase=phase, kernel=rec.kernel, op=rec.op,
                k=str(rec.k), geom=rec.geom,
            ).observe(seconds)
    except Exception:  # noqa: BLE001 - pure observability
        pass


def _publish_histograms(rec: DispatchRecord,
                        phases: Dict[str, float]) -> None:
    try:
        from waffle_con_tpu_torch.obs import metrics as obs_metrics

        if not obs_metrics.metrics_enabled():
            return
        reg = obs_metrics.registry()
        for phase, seconds in phases.items():
            reg.histogram(
                "waffle_dispatch_phase_seconds",
                phase=phase, kernel=rec.kernel, op=rec.op,
                k=str(rec.k), geom=rec.geom,
            ).observe(seconds)
    except Exception:  # noqa: BLE001 - pure observability
        pass


# -- reads ------------------------------------------------------------


def totals() -> Dict[str, float]:
    """Cumulative per-phase seconds across every closed record (the
    quantity ``SearchReport`` diffs around one search)."""
    out = {p: 0.0 for p in PHASES}
    with _agg_lock:
        for slot in _agg.values():
            for p in PHASES:
                out[p] += slot[p]
    return out


def snapshot() -> Dict[str, Dict]:
    """JSON-ready per-(kernel, op, k, geom) phase summary: ``{label:
    {phase: s, count, wall_s, mean_ms}}``, labels like
    ``solo/run/k1/B16R256W514``."""
    with _agg_lock:
        items = [(k, dict(v)) for k, v in _agg.items()]
    out: Dict[str, Dict] = {}
    for (kernel, op, k, geom), slot in sorted(items):
        label = f"{kernel}/{op}/k{k}" + (f"/{geom}" if geom else "")
        count = int(slot["count"])
        out[label] = {
            **{p: round(slot[p], 6) for p in PHASES},
            "count": count,
            "wall_s": round(slot["wall_s"], 6),
            "mean_ms": round(
                slot["wall_s"] / count * 1e3, 3
            ) if count else 0.0,
        }
    return out


def recent_records(limit: Optional[int] = None) -> List[DispatchRecord]:
    """The most recently closed records, oldest first (conservation
    test surface)."""
    with _agg_lock:
        snap = list(_recent)
    return snap[-limit:] if limit is not None else snap


def reset() -> None:
    """Drop aggregates and the recent ring (tests, warm-up)."""
    with _agg_lock:
        _agg.clear()
        _recent.clear()
    _ACTIVE.record = None
