"""Length-prefixed frame codec for the out-of-process serving wire.

The port of ``waffle_con_tpu``'s ``serve/procs/wire.py``.  Every frame is
a fixed 10-byte header followed by the payload::

    !BBII  =  version(1)  frame_type(1)  payload_len(4)  crc32(4)

and every payload is JSON (bytes carried as base64) — **never pickle**:
a worker socket is a process boundary and the decoder must not execute
anything the peer sent.  The CRC32 covers the payload only; a mismatch
is a typed :class:`BadChecksum`, a future version byte is a typed
:class:`UnsupportedVersion`, an oversized declared length is a typed
:class:`FrameTooLarge` — decoding never hangs on a torn frame (partial
input just stays buffered in the :class:`FrameDecoder`) and never
raises anything untyped on garbage input.

The largest payload is an argument (``max_payload=``, default
:data:`MAX_PAYLOAD`, 32 MiB, never below :data:`MIN_MAX_PAYLOAD`): the
port reads no environment variable.

The config/request/result codecs below are explicit field-by-field
translations (no ``__dict__`` reflection on the decode side): unknown
fields from a newer peer are dropped, enums travel as their ``.value``,
and decoded objects are rebuilt through their real constructors so the
``__eq__``-based byte-parity checks apply unchanged.  The config codec
is the search checkpoints' (:mod:`waffle_con_tpu_torch.models.checkpoint`),
so a config has one wire form in the port.
"""

from __future__ import annotations

import base64
import enum
import json
import struct
import zlib
from typing import Any, Dict, List, Optional, Tuple

from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod

#: Protocol version stamped on (and required of) every frame.
FRAME_VERSION = 1

#: version(1) type(1) payload_len(4) crc32(4), network byte order.
HEADER = struct.Struct("!BBII")

#: Default upper bound on one frame's payload (32 MiB).
MAX_PAYLOAD = 32 * 1024 * 1024
#: Floor of any ``max_payload``: a header and a sane job always fit.
MIN_MAX_PAYLOAD = 4096


class FrameType(enum.IntEnum):
    """Typed frames of the door<->worker protocol."""

    HELLO = 1        #: worker -> door: {worker, pid, slots}
    SUBMIT = 2       #: door -> worker: {job, request[, checkpoint]}
    STARTED = 3      #: worker -> door: {job}
    RESULT = 4       #: worker -> door: {job, kind, result}
    ERROR = 5        #: worker -> door: {job, kind, type, message
                     #:                  [, checkpoint]}
    HEALTH = 6       #: worker -> door: forwarded flight trigger
    PING = 7         #: door -> worker: liveness probe
    PONG = 8         #: worker -> door: {outstanding, occupancy}
    DRAIN = 9        #: door -> worker: stop accepting, finish inflight;
                     #: busy jobs snapshot a checkpoint first
    SHUTDOWN = 10    #: door -> worker: close service and exit
    CHECKPOINT = 11  #: worker -> door: {job, data, bytes} — ``data`` is
                     #: an opaque search-checkpoint wire dict; the door
                     #: stores it verbatim and never decodes it
    STATS = 12       #: worker -> door: periodic {worker, unix_time,
                     #: metrics, slo, incidents}
    INCIDENT = 13    #: worker -> door: {worker, incident} — the full
                     #: flight-recorder incident JSON


class WireError(RuntimeError):
    """Base class for frame-codec errors (never a hang, never pickle)."""


class FrameTooLarge(WireError):
    """Declared payload length exceeds the ``max_payload`` bound."""


class BadChecksum(WireError):
    """Payload CRC32 does not match the header."""


class UnsupportedVersion(WireError):
    """Frame from a peer speaking a different protocol version."""


class UnknownFrameType(WireError):
    """Well-formed frame with a type byte this side does not know."""


def _limit(max_payload: int) -> int:
    return max(MIN_MAX_PAYLOAD, int(max_payload))


def encode_frame(ftype: int, obj: Any,
                 max_payload: int = MAX_PAYLOAD) -> bytes:
    """One wire frame: header + JSON payload for ``obj``."""
    payload = json.dumps(obj, separators=(",", ":"),
                         allow_nan=False).encode("utf-8")
    limit = _limit(max_payload)
    if len(payload) > limit:
        raise FrameTooLarge(
            f"frame payload {len(payload)} bytes exceeds max_payload="
            f"{limit}"
        )
    return HEADER.pack(
        FRAME_VERSION, int(ftype), len(payload), zlib.crc32(payload)
    ) + payload


class FrameDecoder:
    """Incremental frame parser over a byte stream.

    :meth:`feed` buffers arbitrary chunks (a torn frame simply waits
    for more bytes — there is no blocking read anywhere in the codec)
    and returns every frame completed so far as ``(FrameType, obj)``
    pairs.  Malformed input raises the typed :class:`WireError`
    subclasses; after an error the stream is unrecoverable by design
    (framing is lost), so callers drop the connection.
    """

    def __init__(self, max_payload: int = MAX_PAYLOAD) -> None:
        self.max_payload = _limit(max_payload)
        self._buf = bytearray()

    def pending(self) -> int:
        """Bytes buffered but not yet parsed into a full frame."""
        return len(self._buf)

    def feed(self, data: bytes) -> List[Tuple[FrameType, Any]]:
        self._buf += data
        frames: List[Tuple[FrameType, Any]] = []
        while True:
            if len(self._buf) < HEADER.size:
                return frames
            version, ftype, length, crc = HEADER.unpack_from(self._buf)
            if version != FRAME_VERSION:
                raise UnsupportedVersion(
                    f"frame version {version} (speaking {FRAME_VERSION})"
                )
            if length > self.max_payload:
                raise FrameTooLarge(
                    f"declared payload {length} bytes exceeds "
                    f"max_payload={self.max_payload}"
                )
            if len(self._buf) < HEADER.size + length:
                return frames
            payload = bytes(self._buf[HEADER.size:HEADER.size + length])
            del self._buf[:HEADER.size + length]
            if zlib.crc32(payload) != crc:
                raise BadChecksum(
                    f"payload CRC mismatch on frame type {ftype}"
                )
            try:
                kind = FrameType(ftype)
            except ValueError:
                raise UnknownFrameType(f"unknown frame type {ftype}")
            try:
                obj = json.loads(payload.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                raise WireError(f"undecodable payload: {exc}") from None
            frames.append((kind, obj))


# -- bytes-in-JSON helpers ---------------------------------------------

def _b64(data: bytes) -> str:
    return base64.b64encode(bytes(data)).decode("ascii")


def _unb64(text: str) -> bytes:
    try:
        return base64.b64decode(text.encode("ascii"), validate=True)
    except Exception as exc:
        raise WireError(f"bad base64 field: {exc}") from None


# -- trace-context codec -----------------------------------------------

def decode_trace(obj: Optional[Dict]) -> Optional[Dict]:
    """Validate the optional SUBMIT trace context.

    The door mints each job's
    :class:`~waffle_con_tpu_torch.obs.trace.TraceContext` and ships
    ``{trace_id, chrome_pid, label, parent_span_id, span_base, flow_id}``
    so the worker's spans join the same Chrome trace tree.  ``None``
    passes through (tracing off on the door); anything malformed is a
    typed :class:`WireError` — the worker treats that as "no context",
    never a failed job.
    """
    if obj is None:
        return None
    if not isinstance(obj, dict):
        raise WireError("trace context must be an object")
    try:
        out = {
            "trace_id": str(obj["trace_id"]),
            "chrome_pid": int(obj["chrome_pid"]),
            "label": str(obj.get("label") or ""),
            "parent_span_id": (
                int(obj["parent_span_id"])
                if obj.get("parent_span_id") is not None else None
            ),
            "span_base": int(obj.get("span_base") or 0),
            "flow_id": (int(obj["flow_id"])
                        if obj.get("flow_id") is not None else None),
        }
    except (KeyError, TypeError, ValueError) as exc:
        raise WireError(f"bad trace context: {exc}") from None
    if out["chrome_pid"] < 0 or out["span_base"] < 0:
        raise WireError("trace context ids must be non-negative")
    return out


# -- config codec ------------------------------------------------------

def encode_config(config: Optional[CdwfaConfig]) -> Optional[Dict]:
    """A :class:`CdwfaConfig` as plain JSON types (enum -> value,
    tuple -> list); ``None`` passes through.  The checkpoints' codec."""
    return ckpt_mod.encode_config_dict(config)


def decode_config(obj: Optional[Dict]) -> Optional[CdwfaConfig]:
    """Rebuild a :class:`CdwfaConfig`, dropping unknown fields so a
    newer peer cannot crash an older worker with an extra knob."""
    try:
        return ckpt_mod.decode_config_dict(obj)
    except ckpt_mod.CheckpointRejected as exc:
        raise WireError(str(exc)) from None


# -- request codec -----------------------------------------------------

def encode_request(request, deadline_left_s: Optional[float] = None) -> Dict:
    """A :class:`~waffle_con_tpu_torch.serve.job.JobRequest` as JSON.

    ``deadline_left_s`` replaces the request's original budget with the
    *remaining* budget as computed by the door — the worker's clock
    starts at its own submit, so the wall-clock deadline keeps meaning
    across the process boundary.
    """
    if request.kind == "priority":
        reads: Any = [[_b64(s) for s in chain] for chain in request.reads]
    else:
        reads = [_b64(r) for r in request.reads]
    return {
        "kind": request.kind,
        "reads": reads,
        "config": encode_config(request.config),
        "offsets": (list(request.offsets)
                    if request.offsets is not None else None),
        "priority": request.priority,
        "deadline_s": (deadline_left_s if deadline_left_s is not None
                       else request.deadline_s),
        "tag": request.tag,
    }


def decode_request(obj: Dict):
    """Rebuild a :class:`~waffle_con_tpu_torch.serve.job.JobRequest` (its
    own ``__post_init__`` validation applies on this side too)."""
    from waffle_con_tpu_torch.serve.job import JobRequest

    if not isinstance(obj, dict):
        raise WireError("request payload must be an object")
    try:
        kind = obj["kind"]
        if kind == "priority":
            reads: Any = tuple(
                tuple(_unb64(s) for s in chain) for chain in obj["reads"]
            )
        else:
            reads = tuple(_unb64(r) for r in obj["reads"])
        offsets = obj.get("offsets")
        return JobRequest(
            kind=kind,
            reads=reads,
            config=decode_config(obj.get("config")),
            offsets=tuple(offsets) if offsets is not None else None,
            priority=int(obj.get("priority", 0)),
            deadline_s=obj.get("deadline_s"),
            tag=obj.get("tag"),
        )
    except WireError:
        raise
    except (KeyError, TypeError, ValueError) as exc:
        raise WireError(f"bad request payload: {exc}") from None


# -- result codec ------------------------------------------------------
#
# The model classes pull the engine modules, so import them lazily:
# a door decodes results without ever importing an engine.

def _encode_consensus(c) -> Dict:
    return {
        "sequence": _b64(c.sequence),
        "cost": c.consensus_cost.value,
        "scores": list(c.scores),
    }


def _decode_consensus(obj: Dict):
    from waffle_con_tpu_torch.models.consensus import Consensus

    return Consensus(
        sequence=_unb64(obj["sequence"]),
        consensus_cost=ConsensusCost(obj["cost"]),
        scores=list(obj["scores"]),
    )


def encode_result(kind: str, result: Any) -> Any:
    """The engine result for one finished job as JSON (tagged by the
    request's ``kind``; every variant roundtrips through ``__eq__``)."""
    if kind == "single":
        return [_encode_consensus(c) for c in result]
    if kind == "dual":
        return [
            {
                "consensus1": _encode_consensus(d.consensus1),
                "consensus2": (_encode_consensus(d.consensus2)
                               if d.consensus2 is not None else None),
                "is_consensus1": list(d.is_consensus1),
                "scores1": list(d.scores1),
                "scores2": list(d.scores2),
            }
            for d in result
        ]
    if kind == "priority":
        return {
            "consensuses": [
                [_encode_consensus(c) for c in tier]
                for tier in result.consensuses
            ],
            "sequence_indices": list(result.sequence_indices),
        }
    raise WireError(f"unknown result kind {kind!r}")


def decode_result(kind: str, obj: Any) -> Any:
    """Inverse of :func:`encode_result`."""
    try:
        if kind == "single":
            return [_decode_consensus(c) for c in obj]
        if kind == "dual":
            from waffle_con_tpu_torch.models.dual_consensus import (
                DualConsensus,
            )

            return [
                DualConsensus(
                    consensus1=_decode_consensus(d["consensus1"]),
                    consensus2=(_decode_consensus(d["consensus2"])
                                if d["consensus2"] is not None else None),
                    is_consensus1=list(d["is_consensus1"]),
                    scores1=list(d["scores1"]),
                    scores2=list(d["scores2"]),
                )
                for d in obj
            ]
        if kind == "priority":
            from waffle_con_tpu_torch.models.priority_consensus import (
                PriorityConsensus,
            )

            return PriorityConsensus(
                consensuses=[
                    [_decode_consensus(c) for c in tier]
                    for tier in obj["consensuses"]
                ],
                sequence_indices=list(obj["sequence_indices"]),
            )
    except WireError:
        raise
    except (KeyError, TypeError, ValueError) as exc:
        raise WireError(f"bad result payload: {exc}") from None
    raise WireError(f"unknown result kind {kind!r}")
