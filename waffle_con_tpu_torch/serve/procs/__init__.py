"""Out-of-process serving: the wire codec.

The port of ``waffle_con_tpu``'s ``serve/procs`` package, so far its
:mod:`~waffle_con_tpu_torch.serve.procs.wire` module: the frame codec
(version byte + checksum on every frame, JSON payloads, no pickle on the
wire path, typed decode errors) and the config, request and result
codecs, which the consensus cache also stores its results in.  The
worker process and the front door are not ported yet.
"""

from waffle_con_tpu_torch.serve.procs.wire import (
    BadChecksum,
    FrameDecoder,
    FrameTooLarge,
    FrameType,
    UnknownFrameType,
    UnsupportedVersion,
    WireError,
    encode_frame,
)

__all__ = [
    "BadChecksum",
    "FrameDecoder",
    "FrameTooLarge",
    "FrameType",
    "UnknownFrameType",
    "UnsupportedVersion",
    "WireError",
    "encode_frame",
]
