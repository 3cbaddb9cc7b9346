"""Serializable search checkpoints: snapshot / preempt / resume for the
engines.

The port of ``waffle_con_tpu``'s ``models/checkpoint.py``, wire form and
all.  A :class:`SearchCheckpoint` captures a consensus search at a *pop
boundary* — the top of the engine's pop loop, where no speculative state
is in flight — as plain JSON types: the priority queue's entries
(consensus bytes, active sets, offsets, priorities, insertion seqs), the
:class:`~waffle_con_tpu_torch.utils.pqueue.PQueueTracker` histograms, the
loop counters, and the accepted results so far.

**What is deliberately not serialized**: scorer handles, the branch
store's device tensors, prefetch caches, frontier-gang deposits and the
arena's scratch slots.  A snapshot never reads a device buffer.  Active
wavefront state is a deterministic function of ``(read, consensus,
offset)`` (the engines' node-identity invariant), so resume rebuilds
every branch with one ``root``, the consensus replayed column by column
through ``push_many``, and one ``activate`` per active read, through the
ordinary scorer seam — on a CUDA device the activations are launches of
the column-replay kernel, and the resumed search runs on the run, dual
run and arena kernels as any other.  Prefetch caches and gang deposits
are consume-once speculation whose absence is byte-safe by construction:
dropping them at snapshot can change *when* work happens, never what the
search returns.

Integrity: the wire form carries a CRC32 over the canonical body JSON
plus a version number; truncated, bit-flipped, or version-skewed
checkpoints raise the typed :class:`CheckpointRejected`.  Each restored
node's stored priority is re-derived from its rebuilt stats — a
checkpoint that does not match its own reads/config is rejected at
restore time rather than silently corrupting the search.

The :class:`CheckpointController` is the engines' polling seam: a caller
installs one per search (thread-local, :func:`installed`) and the engines
call :meth:`CheckpointController.poll` at the top of every pop-loop
iteration.  The controller decides when to snapshot (periodic interval,
explicit request, or pinned test polls) and what to do with it (deliver
it to a callback, or preempt the search with :class:`SearchPreempted`).

Example::

    from waffle_con_tpu_torch.models import checkpoint as ckpt

    ctrl = ckpt.CheckpointController(snapshot_at_pops={500}, preempt=True)
    try:
        with ckpt.installed(ctrl):
            engine.consensus()
    except ckpt.SearchPreempted as stop:
        text = stop.checkpoint.to_json()
    resumed = ckpt.resume_engine(ckpt.SearchCheckpoint.from_json(text))
    results = resumed.consensus()
"""

from __future__ import annotations

import base64
import dataclasses
import json
import logging
import threading
import time
import zlib
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger(__name__)

#: Checkpoint format version; a mismatch is a typed rejection, never a
#: best-effort parse.
CKPT_VERSION = 1

#: Engine kinds a checkpoint can describe.
CKPT_KINDS = ("single", "dual", "priority")


class CheckpointError(RuntimeError):
    """Base class for checkpoint failures."""


class CheckpointRejected(CheckpointError):
    """A checkpoint that must not be restored: corrupt payload, version
    skew, or state inconsistent with its own reads/config.  Callers
    degrade to restart-from-scratch."""


class SearchPreempted(RuntimeError):
    """A search stopped on purpose at a pop boundary, carrying its
    checkpoint (a drain or a migration resumes it elsewhere)."""

    def __init__(self, checkpoint: "SearchCheckpoint") -> None:
        super().__init__("search preempted at a checkpoint boundary")
        self.checkpoint = checkpoint


# -- bytes-in-JSON helpers ---------------------------------------------

def b64(data: bytes) -> str:
    return base64.b64encode(bytes(data)).decode("ascii")


def unb64(text: str) -> bytes:
    try:
        return base64.b64decode(text.encode("ascii"), validate=True)
    except Exception as exc:
        raise CheckpointRejected(f"bad base64 field: {exc}") from None


def _canonical(body: Dict) -> bytes:
    """Canonical JSON bytes of the body (sorted keys) — what the CRC
    covers, independent of dict insertion order."""
    return json.dumps(
        body, sort_keys=True, separators=(",", ":"), allow_nan=False
    ).encode("utf-8")


class SearchCheckpoint:
    """One search snapshot: engine kind + JSON-typed body.

    The body always holds ``config`` (wire config codec), the engine's
    reads (``reads`` b64 list, or ``chains``/``seed_groups`` for the
    priority engine), ``offsets``, and an engine-specific ``state``
    dict.  Use :meth:`to_wire`/:meth:`from_wire` for the CRC'd plain-
    dict form, :meth:`to_json` for a string.
    """

    __slots__ = ("version", "kind", "body")

    def __init__(self, kind: str, body: Dict,
                 version: int = CKPT_VERSION) -> None:
        self.version = version
        self.kind = kind
        self.body = body

    def to_wire(self) -> Dict:
        """CRC'd plain-JSON-types form (never pickle)."""
        return {
            "version": self.version,
            "kind": self.kind,
            "body": self.body,
            "crc": zlib.crc32(_canonical(self.body)),
        }

    @classmethod
    def from_wire(cls, obj: Any) -> "SearchCheckpoint":
        """Validate and rebuild; raises :class:`CheckpointRejected` on
        any malformed, skewed, or corrupted payload."""
        if not isinstance(obj, dict):
            raise CheckpointRejected("checkpoint payload must be an object")
        version = obj.get("version")
        if version != CKPT_VERSION:
            raise CheckpointRejected(
                f"checkpoint version {version!r} (speaking {CKPT_VERSION})"
            )
        kind = obj.get("kind")
        if kind not in CKPT_KINDS:
            raise CheckpointRejected(f"unknown checkpoint kind {kind!r}")
        body = obj.get("body")
        if not isinstance(body, dict):
            raise CheckpointRejected("checkpoint body must be an object")
        try:
            crc = int(obj.get("crc"))
        except (TypeError, ValueError):
            raise CheckpointRejected("checkpoint crc missing") from None
        if zlib.crc32(_canonical(body)) != crc:
            raise CheckpointRejected("checkpoint body CRC mismatch")
        return cls(kind, body, version=version)

    def to_json(self) -> str:
        return json.dumps(self.to_wire(), separators=(",", ":"),
                          allow_nan=False)

    @classmethod
    def from_json(cls, text: str) -> "SearchCheckpoint":
        try:
            obj = json.loads(text)
        except (TypeError, ValueError) as exc:
            raise CheckpointRejected(
                f"undecodable checkpoint JSON: {exc}"
            ) from None
        return cls.from_wire(obj)

    def byte_size(self) -> int:
        """Serialized size in bytes (the wire JSON form)."""
        return len(self.to_json().encode("utf-8"))


# -- config codec -------------------------------------------------------


def encode_config_dict(config) -> Optional[Dict]:
    """A :class:`~waffle_con_tpu_torch.config.CdwfaConfig` as plain JSON
    types (enum -> value, tuple -> list); ``None`` passes through."""
    from waffle_con_tpu_torch.config import ConsensusCost

    if config is None:
        return None
    out: Dict[str, Any] = {}
    for field in dataclasses.fields(config):
        value = getattr(config, field.name)
        if isinstance(value, ConsensusCost):
            value = value.value
        elif isinstance(value, tuple):
            value = list(value)
        out[field.name] = value
    return out


def decode_config_dict(obj: Optional[Dict]):
    """Rebuild a :class:`~waffle_con_tpu_torch.config.CdwfaConfig`,
    dropping unknown fields (a checkpoint written with an extra knob still
    resumes); a malformed payload is a :class:`CheckpointRejected`."""
    from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost

    if obj is None:
        return None
    if not isinstance(obj, dict):
        raise CheckpointRejected("config payload must be an object")
    known = {f.name for f in dataclasses.fields(CdwfaConfig)}
    kwargs = {k: v for k, v in obj.items() if k in known}
    try:
        if "consensus_cost" in kwargs:
            kwargs["consensus_cost"] = ConsensusCost(kwargs["consensus_cost"])
        return CdwfaConfig(**kwargs)
    except (TypeError, ValueError) as exc:
        raise CheckpointRejected(f"bad config payload: {exc}") from None


def resume_body(checkpoint, kind: str) -> Dict:
    """Validate a checkpoint (or its wire-dict form) against the engine
    ``kind`` doing the resuming and hand back its body."""
    if not isinstance(checkpoint, SearchCheckpoint):
        checkpoint = SearchCheckpoint.from_wire(checkpoint)
    if checkpoint.kind != kind:
        raise CheckpointRejected(
            f"{kind} engine cannot resume a {checkpoint.kind!r} checkpoint"
        )
    return checkpoint.body


def resume_engine(checkpoint: SearchCheckpoint, extra_reads=()):
    """Rebuild the right engine primed to continue ``checkpoint``; call
    its ``consensus()`` to run the resumed search."""
    if checkpoint.kind == "single":
        from waffle_con_tpu_torch.models.consensus import ConsensusDWFA

        return ConsensusDWFA.resume(checkpoint, extra_reads=extra_reads)
    if checkpoint.kind == "dual":
        from waffle_con_tpu_torch.models.dual_consensus import DualConsensusDWFA

        return DualConsensusDWFA.resume(checkpoint, extra_reads=extra_reads)
    if checkpoint.kind == "priority":
        from waffle_con_tpu_torch.models.priority_consensus import (
            PriorityConsensusDWFA,
        )

        return PriorityConsensusDWFA.resume(
            checkpoint, extra_reads=extra_reads
        )
    raise CheckpointRejected(f"unknown checkpoint kind {checkpoint.kind!r}")


# -- controller ---------------------------------------------------------


class CheckpointController:
    """Per-search snapshot policy, polled by the engines at the top of
    every pop-loop iteration (the single and dual engines' ``pops``
    count; the arena takes several pops in one iteration, so polls are
    iterations, not pops).

    All mutation happens either on the search thread (inside
    :meth:`poll`) or is a single boolean flag flip from another thread
    (:meth:`request_snapshot`), so no lock is needed.

    ``interval_s``      periodic snapshot cadence (0/None = off).
    ``max_bytes``       drop (do not keep/deliver) snapshots larger than
                        this many serialized bytes (0/None = unbounded).
    ``deadline``        ``time.monotonic()`` deadline: when lapsed, one
                        final snapshot is taken and
                        :class:`~waffle_con_tpu_torch.runtime.watchdog.DeadlineExceeded`
                        is raised at the pop boundary, so a stopped
                        search carries a checkpoint of where it stopped.
    ``snapshot_at_pops``  pinned poll counts for deterministic tests,
                        matched against the controller's cumulative
                        poll counter (keeps counting across the
                        priority engine's successive group solves); with
                        ``preempt=True`` the pinned snapshot also
                        raises :class:`SearchPreempted`.
    ``on_snapshot``     callback receiving each kept checkpoint.
    """

    def __init__(
        self,
        *,
        interval_s: Optional[float] = None,
        max_bytes: Optional[int] = None,
        deadline: Optional[float] = None,
        snapshot_at_pops=None,
        preempt: bool = False,
        on_snapshot: Optional[Callable[[SearchCheckpoint], None]] = None,
        label: str = "",
    ) -> None:
        self.interval_s = interval_s
        self.max_bytes = max_bytes
        self.deadline = deadline
        self.snapshot_at_pops = (
            frozenset(snapshot_at_pops) if snapshot_at_pops else None
        )
        self.preempt = preempt
        self.on_snapshot = on_snapshot
        self.label = label
        self.last_checkpoint: Optional[SearchCheckpoint] = None
        self.snapshots = 0
        self.bytes_total = 0
        self.oversize_dropped = 0
        self._last_ts = time.monotonic()
        self._polls = 0
        self._requested = False
        self._preempt_requested = False
        self._wrappers: List[Callable[[Dict], Dict]] = []

    @property
    def polls(self) -> int:
        """Polls so far: the pop-loop iterations of every search run
        under this controller."""
        return self._polls

    # -- cross-thread requests (flag flips only) -----------------------

    def request_snapshot(self, preempt: bool = False) -> None:
        """Ask the search to snapshot at its next pop boundary; with
        ``preempt`` it also stops there with :class:`SearchPreempted`."""
        if preempt:
            self._preempt_requested = True
        self._requested = True

    # -- composite engines (priority wraps its inner dual) -------------

    def push_wrapper(self, fn: Callable[[Dict], Dict]) -> None:
        """Install a body transform applied to every snapshot built
        while it is on the stack (outermost engine last)."""
        self._wrappers.append(fn)

    def pop_wrapper(self) -> None:
        self._wrappers.pop()

    # -- the engine-side seam ------------------------------------------

    def poll(self, pops: int, builder: Callable[[], Dict]) -> None:
        """Called by the engines at the top of every pop iteration with
        the completed-pop count and a zero-argument body builder.
        Builds a snapshot when due; may raise ``DeadlineExceeded`` (with
        the final checkpoint kept) or :class:`SearchPreempted`."""
        cum_polls = self._polls
        self._polls += 1
        preempt = self._preempt_requested
        want = self._requested or preempt
        deadline_hit = (
            self.deadline is not None
            and time.monotonic() >= self.deadline
        )
        want = want or deadline_hit
        if not want and self.snapshot_at_pops is not None:
            if cum_polls in self.snapshot_at_pops:
                want = True
                preempt = preempt or self.preempt
        if not want and self.interval_s:
            want = time.monotonic() - self._last_ts >= self.interval_s
        if not want:
            return
        self._requested = False
        self._preempt_requested = False
        checkpoint = self._build(builder)
        if deadline_hit:
            from waffle_con_tpu_torch.runtime.watchdog import enforce_deadline

            enforce_deadline(self.deadline, label=self.label)
        if preempt and checkpoint is not None:
            raise SearchPreempted(checkpoint)

    def _build(self, builder: Callable[[], Dict]):
        body = builder()
        for wrap in self._wrappers:
            body = wrap(body)
        checkpoint = SearchCheckpoint(body["kind"], body)
        size = checkpoint.byte_size()
        if self.max_bytes and size > self.max_bytes:
            self.oversize_dropped += 1
            logger.warning(
                "checkpoint dropped: %d bytes over the %d cap%s",
                size, self.max_bytes,
                f" ({self.label})" if self.label else "",
            )
            return None
        self._last_ts = time.monotonic()
        self.last_checkpoint = checkpoint
        self.snapshots += 1
        self.bytes_total += size
        if self.on_snapshot is not None:
            try:
                self.on_snapshot(checkpoint)
            except Exception:  # noqa: BLE001 - delivery must never kill
                logger.exception("checkpoint delivery callback failed")
        return checkpoint


#: the calling thread's controller (engines read it once per search)
_TLS = threading.local()


def install_controller(
    controller: Optional[CheckpointController],
) -> Optional[CheckpointController]:
    """Install the calling thread's controller; returns the previous
    one so callers can restore it."""
    previous = getattr(_TLS, "controller", None)
    _TLS.controller = controller
    return previous


def current_controller() -> Optional[CheckpointController]:
    return getattr(_TLS, "controller", None)


@contextmanager
def installed(controller: Optional[CheckpointController]):
    previous = install_controller(controller)
    try:
        yield controller
    finally:
        install_controller(previous)
