"""Search audit plane: deterministic decision recorder + lockstep shadow.

The port of ``waffle_con_tpu``'s ``obs/audit.py``, records and all, so a
log of the port and a log of the JAX package compare with
:func:`diff_logs`.  Byte parity against the python oracle is the port's
crown invariant, but end-of-run equality gives no triage signal when it
breaks.  This module records what the search *decided* — one compact
record per pop boundary — and compares two runs decision by decision:

* **Recorder** (:func:`capture`): each engine pop loop fetches one
  :class:`AuditSink` per search (:func:`search_sink`; ``None`` when no
  capture is installed — the per-pop cost of an unaudited run is one
  ``is not None`` check, decided at search start) and emits a record
  carrying the node identity ``(consensus_len, prefix crc32,
  active-mask digest, priority)``, the decision kind (plain branch /
  device run), the stop code and the committed symbols.  Everything
  digested is a host value the engine already holds: no device read.

* **Decision map** (:func:`expand_units`): pop *order* differs benignly
  across compositions (arena on or off, gang widths, resumed or from
  scratch), so records are compared as an order-independent map from
  node identity to decision.  A run record with S committed symbols
  expands into S single-step units (prefix crc chained incrementally),
  which line up with the oracle's single-step pops.  One-sided keys are
  benign frontier differences; the *same key with a different decision*
  is a divergence.  ``ignored`` / ``arena`` / ``final`` / ``dispatch`` /
  ``group`` records are diagnostics and expand to no compared unit.

* **First-divergence differ** (:func:`diff_logs`): aligns two record
  streams (the port against the JAX package, cuda against python,
  resumed against from scratch, ...) and reports the first conflicting
  unit in the left log's emission order.

* **Lockstep shadow** (:func:`shadow_override` ``("python")``):
  :func:`maybe_shadow` runs the python-oracle twin of a single/dual
  search in-process, in a second thread, feeding both record streams
  through a :class:`_LockstepComparator`; the first conflicting decision
  raises :class:`ParityDivergence` (counted once in
  :func:`stats_snapshot`).  Shadow mode is a **debug tool**: it doubles
  the search.  Under shadow the primary skips the opaque arena fast path
  (``AuditSink.strict_align``) so every decision stays per-pop
  comparable; the oracle has no fast paths to skip.

The port reads no environment variable: capture, shadow and the fault
that tests it (:mod:`waffle_con_tpu_torch.runtime.faults`) are switched
programmatically.
"""

from __future__ import annotations

import base64
import json
import threading
import zlib
from contextlib import contextmanager
from typing import Callable, Dict, Iterable, List, Optional, Tuple

from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import trace as obs_trace

#: engines the lockstep shadow knows how to twin (priority searches are
#: shadowed per inner dual-engine group solve, which flows through the
#: ``"dual"`` label here)
SHADOW_ENGINES = ("single", "dual")

#: bounded ring size of a shadowed search's sinks
RING_DEFAULT = 4096

#: how many tail prefix bytes each record carries for human triage (the
#: full prefix is recoverable from a checkpoint/repro, not the record)
_TAIL_BYTES = 12

_TLS = threading.local()

_STATS_LOCK = threading.Lock()
_STATS = {"records": 0, "shadow_pops": 0, "divergences": 0}


class ParityDivergence(RuntimeError):
    """The lockstep shadow found a decision the primary and the oracle
    disagree on.  ``detail`` carries the first-divergence diff."""

    def __init__(self, detail: Dict) -> None:
        key = detail.get("key")
        super().__init__(
            f"parity divergence at pop {detail.get('pop_a')} "
            f"(shadow pop {detail.get('pop_b')}): key={key} "
            f"primary={detail.get('value_a')} oracle={detail.get('value_b')}"
        )
        self.detail = detail


# -- digests -----------------------------------------------------------


def crc_bytes(data: bytes, prev: int = 0) -> int:
    """Running CRC32 (the incremental digest units chain with)."""
    return zlib.crc32(data, prev) & 0xFFFFFFFF


def active_digest(*active_sets: Iterable) -> int:
    """Order-insensitive digest of one or more active-read collections
    (host-side index lists/sets the engines already maintain)."""
    d = 0
    for act in active_sets:
        text = ",".join(str(int(a)) for a in sorted(act))
        d = crc_bytes(text.encode() + b"|", d)
    return d


def b64(data: bytes) -> str:
    return base64.b64encode(bytes(data)).decode("ascii")


def unb64(text: str) -> bytes:
    return base64.b64decode(text.encode("ascii"))


def tail(consensus: bytes) -> str:
    return b64(bytes(consensus[-_TAIL_BYTES:]))


# -- enablement & sink plumbing ---------------------------------------


def audit_enabled() -> bool:
    """Whether the calling thread records audits (a :func:`capture` or a
    shadow's sink provider is installed)."""
    return getattr(_TLS, "provider", None) is not None


class AuditSink:
    """Per-search decision record sink: bounded ring + optional JSONL
    stream + optional ``on_emit`` tap (the lockstep comparator)."""

    def __init__(
        self,
        engine: str,
        ring: Optional[int] = None,
        path: Optional[str] = None,
        on_emit: Optional[Callable[[Dict], None]] = None,
        strict_align: bool = False,
    ) -> None:
        self.engine = engine
        self.path = path
        self.on_emit = on_emit
        #: engines skip opaque subtree fast paths (arena) when set, so
        #: every decision stays per-pop comparable under lockstep shadow
        self.strict_align = strict_align
        self._ring_cap = ring
        self._seq = 0
        self.records: List[Dict] = []

    def emit(self, record: Dict) -> None:
        record["eng"] = self.engine
        record["seq"] = self._seq
        self._seq += 1
        self.records.append(record)
        cap = self._ring_cap
        if cap is not None and len(self.records) > cap:
            del self.records[: len(self.records) - cap]
        if self.path is not None:
            try:
                with open(self.path, "a") as fh:
                    fh.write(json.dumps(record) + "\n")
            except OSError:  # a broken audit sink must never fail a search
                self.path = None
        with _STATS_LOCK:
            _STATS["records"] += 1
        if obs_metrics.metrics_enabled():
            obs_metrics.registry().counter(
                "waffle_audit_records_total", engine=self.engine
            ).inc()
        if self.on_emit is not None:
            self.on_emit(record)


def search_sink(engine: str) -> Optional[AuditSink]:
    """One sink per search, fetched once by each engine's
    ``_consensus_impl``; ``None`` when auditing is off (the zero-overhead
    decision, made at search start)."""
    provider = getattr(_TLS, "provider", None)
    if provider is None:
        return None
    sink = provider(engine)
    if sink is not None:
        _TLS.current_sink = sink  # the dispatch-seam tap emits here
    return sink


@contextmanager
def capture(strict_align: bool = False):
    """Install a thread-local sink provider capturing every search's
    records in memory; yields the (growing) list of sinks, one per
    search in start order (a priority search's own sink first, then one
    per inner dual solve)."""
    sinks: List[AuditSink] = []

    def provider(engine: str) -> AuditSink:
        sink = AuditSink(engine, ring=None, strict_align=strict_align)
        sinks.append(sink)
        return sink

    prev = getattr(_TLS, "provider", None)
    _TLS.provider = provider
    try:
        yield sinks
    finally:
        _TLS.provider = prev


def stats_snapshot() -> Dict[str, int]:
    with _STATS_LOCK:
        return dict(_STATS)


def reset_stats() -> None:
    with _STATS_LOCK:
        for k in _STATS:
            _STATS[k] = 0


def status() -> Optional[Dict]:
    """Compact audit/shadow status; ``None`` when the plane is fully
    inactive (nothing recorded, no capture or shadow installed)."""
    snap = stats_snapshot()
    enabled = audit_enabled()
    shadow = _shadow_mode()
    if not enabled and not shadow and not any(snap.values()):
        return None
    snap["enabled"] = enabled
    snap["shadow"] = shadow or None
    return snap


# -- unit expansion & the first-divergence differ ----------------------


def _specs_value(specs: List) -> Tuple:
    canon = tuple(
        (str(k), None if a is None else int(a), None if c is None else int(c))
        for k, a, c in specs
    )
    if len(canon) == 1:
        kind, a, c = canon[0]
        if kind == "dual":
            return ("dsym", a, c)
        if kind == "single":
            return ("sym", a)
    return ("specs", canon)


def expand_units(record: Dict) -> List[Tuple[Tuple, Tuple]]:
    """The comparable ``(key, value)`` units a record contributes to the
    decision map.  Keys are pure functions of (engine, node class,
    prefix digests, active digest) — order-independent across dispatch
    compositions; values are the decision at that node.  Diagnostic
    kinds contribute nothing."""
    kind = record.get("kind")
    eng = record.get("eng")
    act = record.get("act")
    if eng == "single":
        dig = record.get("dig")
        ln = record.get("len")
        if kind == "branch":
            syms = unb64(record["syms"])
            if len(syms) == 1:
                return [(("s", ln, dig, act), ("sym", syms[0]))]
            return [(("s", ln, dig, act), ("branch", tuple(sorted(syms))))]
        if kind == "run":
            out = []
            d = dig
            for i, s in enumerate(unb64(record["syms"])):
                out.append(((("s"), ln + i, d, act), ("sym", s)))
                d = crc_bytes(bytes([s]), d)
            return out
        return []
    if eng == "dual":
        cls = record.get("cls")
        l1, l2 = record.get("l1"), record.get("l2")
        d1, d2 = record.get("d1"), record.get("d2")
        if kind == "branch":
            value = _specs_value(record.get("specs", []))
            if cls == "p":
                return [(("p", l1, d1, act), value)]
            if value[0] == "sym":  # a dual node deciding one side only
                value = ("dsym", value[1], None)
            return [(("d", l1, l2, d1, d2, act), value)]
        if kind == "run":
            s1 = unb64(record.get("s1") or "")
            s2 = unb64(record.get("s2") or "")
            if cls == "p":
                out = []
                d = d1
                for i, s in enumerate(s1):
                    out.append((("p", l1 + i, d, act), ("sym", s)))
                    d = crc_bytes(bytes([s]), d)
                return out
            out = []
            for i in range(max(len(s1), len(s2))):
                a = s1[i] if i < len(s1) else None
                c = s2[i] if i < len(s2) else None
                out.append((("d", l1, l2, d1, d2, act), ("dsym", a, c)))
                if a is not None:
                    d1 = crc_bytes(bytes([a]), d1)
                    l1 += 1
                if c is not None:
                    d2 = crc_bytes(bytes([c]), d2)
                    l2 += 1
            return out
        return []
    return []


def _divergence_detail(rec_a, pop_a, rec_b, pop_b, key, va, vb) -> Dict:
    return {
        "pop_a": pop_a,
        "pop_b": pop_b,
        "key": list(key),
        "value_a": list(va),
        "value_b": list(vb),
        "record_a": rec_a,
        "record_b": rec_b,
        "prefix_len": rec_a.get("len", rec_a.get("l1")),
        "prefix_tail": rec_a.get("tail"),
    }


def diff_logs(
    records_a: List[Dict], records_b: List[Dict]
) -> Optional[Dict]:
    """First divergence between two record streams: build the decision
    map of B, scan A in emission order, report the first unit whose key
    exists in B with a different value.  One-sided keys are benign
    frontier differences and never reported.  ``None`` when the logs
    agree on every shared decision."""
    bmap: Dict[Tuple, Tuple] = {}
    for rec in records_b:
        for key, value in expand_units(rec):
            bmap.setdefault(key, (rec.get("pop"), value, rec))
    for rec in records_a:
        for key, value in expand_units(rec):
            hit = bmap.get(key)
            if hit is not None and hit[1] != value:
                return _divergence_detail(
                    rec, rec.get("pop"), hit[2], hit[0], key, value, hit[1]
                )
    return None


def load_log(path: str) -> List[Dict]:
    """Read one audit JSONL stream back into records."""
    records = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


# -- lockstep shadow execution ----------------------------------------


def _shadow_mode() -> str:
    return getattr(_TLS, "shadow_override", None) or ""


@contextmanager
def shadow_override(mode: str):
    """Thread-locally set the shadow mode: ``"python"`` runs every
    single/dual search on a device backend in lockstep with its python
    oracle twin."""
    prev = getattr(_TLS, "shadow_override", None)
    _TLS.shadow_override = mode
    try:
        yield
    finally:
        _TLS.shadow_override = prev


class _LockstepComparator:
    """Streaming decision-map comparison between the primary ("a") and
    the shadow oracle ("b").  Each emitted record's units are checked
    against the other side's accumulated map; the first conflicting unit
    is counted exactly once (``divergences`` in :func:`stats_snapshot`),
    fires one ``parity_divergence`` flight incident under the search's
    trace id, and raises :class:`ParityDivergence` in the feeding thread
    (the other side aborts at its next emit)."""

    def __init__(self, trace_id: Optional[str]) -> None:
        self._lock = threading.Lock()
        self._trace_id = trace_id
        self._maps: Dict[str, Dict[Tuple, Tuple]] = {"a": {}, "b": {}}
        self.divergence: Optional[Dict] = None
        self.abort = False

    def feed(self, side: str, record: Dict) -> None:
        other = "b" if side == "a" else "a"
        units = expand_units(record)
        if side == "b":
            with _STATS_LOCK:
                _STATS["shadow_pops"] += 1
        with self._lock:
            if self.divergence is not None or self.abort:
                raise ParityDivergence(self.divergence or {"aborted": True})
            mine, theirs = self._maps[side], self._maps[other]
            for key, value in units:
                hit = theirs.get(key)
                if hit is not None and hit[1] != value:
                    if side == "a":
                        detail = _divergence_detail(
                            record, record.get("pop"), hit[2], hit[0],
                            key, value, hit[1],
                        )
                    else:
                        detail = _divergence_detail(
                            hit[2], hit[0], record, record.get("pop"),
                            key, hit[1], value,
                        )
                    self._signal(detail)
                    raise ParityDivergence(detail)
                mine[key] = (record.get("pop"), value, record)

    def final_mismatch(self, detail: Dict) -> None:
        with self._lock:
            if self.divergence is None:
                self._signal(detail)
        raise ParityDivergence(detail)

    def _signal(self, detail: Dict) -> None:
        # called with self._lock held; trigger once per comparator
        self.divergence = detail
        with _STATS_LOCK:
            _STATS["divergences"] += 1
        obs_flight.trigger(
            "parity_divergence", trace_id=self._trace_id, **detail
        )


class _ShadowRun:
    """One lockstep execution: the primary runs ``impl()`` in the caller
    thread, the python-oracle twin runs in a worker thread, both feeding
    the comparator."""

    def __init__(self, engine, engine_label: str) -> None:
        self.engine = engine
        self.label = engine_label
        self.comparator = _LockstepComparator(obs_trace.current_trace_id())
        self.shadow_engine = _clone_to_python(engine)
        self._shadow_results = None
        self._shadow_exc: Optional[BaseException] = None

    def _side_provider(self, side: str):
        def provider(engine_label: str) -> AuditSink:
            return AuditSink(
                engine_label,
                ring=RING_DEFAULT,
                on_emit=lambda rec: self.comparator.feed(side, rec),
                strict_align=True,
            )
        return provider

    def _shadow_body(self) -> None:
        _TLS.in_shadow = True
        _TLS.provider = self._side_provider("b")
        try:
            self._shadow_results = self.shadow_engine.consensus()
        except BaseException as exc:  # surfaced after join
            self._shadow_exc = exc
        finally:
            _TLS.provider = None
            _TLS.in_shadow = False

    def run(self, impl):
        thread = threading.Thread(
            target=self._shadow_body, name="waffle-shadow", daemon=True
        )
        prev = getattr(_TLS, "provider", None)
        _TLS.provider = self._side_provider("a")
        thread.start()
        try:
            results = impl()
        except BaseException:
            self.comparator.abort = True
            thread.join()
            raise
        finally:
            _TLS.provider = prev
        thread.join()
        if self.comparator.divergence is not None:
            raise ParityDivergence(self.comparator.divergence)
        if self._shadow_exc is not None:
            raise RuntimeError(
                "lockstep shadow oracle failed"
            ) from self._shadow_exc
        sig_a = [repr(r) for r in _as_list(results)]
        sig_b = [repr(r) for r in _as_list(self._shadow_results)]
        if sig_a != sig_b:
            self.comparator.final_mismatch({
                "pop_a": None, "pop_b": None, "key": ["final_results"],
                "value_a": sig_a[:4], "value_b": sig_b[:4],
                "record_a": {}, "record_b": {},
            })
        return results


def _as_list(results) -> List:
    if results is None:
        return []
    if isinstance(results, (list, tuple)):
        return list(results)
    return [results]


def _clone_to_python(engine):
    """A python-backend twin of ``engine`` with the same reads, offsets,
    and (deep-copied) pending restore state — built through the
    checkpoint config codec so every search-relevant knob survives."""
    from waffle_con_tpu_torch.models import checkpoint as ckpt_mod

    cfg_dict = json.loads(json.dumps(ckpt_mod.encode_config_dict(engine.config)))
    cfg_dict["backend"] = "python"
    cfg = ckpt_mod.decode_config_dict(cfg_dict)
    shadow = type(engine)(cfg)
    for seq, off in zip(engine.sequences, engine.offsets):
        shadow.add_sequence_offset(seq, off)
    restore = getattr(engine, "_restore_state", None)
    if restore is not None:
        # the primary's impl consumes _restore_state; copy it first
        shadow._restore_state = json.loads(json.dumps(restore))
    return shadow


def maybe_shadow(engine, engine_label: str) -> Optional[_ShadowRun]:
    """A :class:`_ShadowRun` when lockstep shadow execution applies to
    this search, else ``None``.  Engages only for single/dual searches
    on a non-python primary backend, never recursively (the shadow
    thread's own search must not spawn a third engine)."""
    if getattr(_TLS, "in_shadow", False):
        return None
    if engine_label not in SHADOW_ENGINES:
        return None
    if _shadow_mode() != "python":
        return None
    backend = getattr(getattr(engine, "config", None), "backend", "python")
    if backend == "python":
        return None
    return _ShadowRun(engine, engine_label)


# -- scorer tap (construct_backend hook, TimedScorer-style) ------------

#: scorer run ops the tap records (diagnostic records; no compared units)
_TAPPED_OPS = ("run_extend", "run_extend_dual", "run_arena")


class AuditScorerTap:
    """Transparent scorer proxy emitting one diagnostic ``dispatch``
    record per run-family call into the current search's sink.  Like
    :class:`~waffle_con_tpu_torch.obs.instrument.TimedScorer` it is
    invisible to the engines' capability probes (the planners' answers,
    the ``ARENA_*`` sizes and ``counters`` fall through) and only exists
    when auditing is on.  It reads nothing from a call's result beyond
    the step count the engines already hold as a host integer."""

    def __init__(self, base, backend: str) -> None:
        self._base = base
        self._audit_backend = backend

    @property
    def counters(self):
        return self._base.counters

    @counters.setter
    def counters(self, value):
        self._base.counters = value

    def _wrap(self, name: str, fn):
        backend = self._audit_backend

        def tapped(*args, **kwargs):
            result = fn(*args, **kwargs)
            sink = getattr(_TLS, "current_sink", None)
            if sink is not None:
                steps = None
                if name != "run_arena" and isinstance(result, tuple) and result:
                    try:
                        steps = int(result[0])
                    except (TypeError, ValueError):
                        steps = None
                sink.emit({
                    "kind": "dispatch", "op": name, "backend": backend,
                    "steps": steps,
                })
            return result

        tapped.__name__ = name
        return tapped

    def __getattr__(self, name: str):
        base = self.__dict__["_base"]
        attr = getattr(base, name)
        if name not in _TAPPED_OPS or not callable(attr):
            return attr
        wrapped = self._wrap(name, attr)
        self.__dict__[name] = wrapped
        return wrapped


def maybe_tap(scorer, backend: str):
    """Wrap ``scorer`` in an :class:`AuditScorerTap` when auditing is
    enabled; return it unchanged otherwise (the zero-overhead decision,
    made once at backend construction)."""
    if audit_enabled():
        return AuditScorerTap(scorer, backend)
    return scorer
