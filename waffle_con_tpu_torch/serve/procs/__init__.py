"""Out-of-process serving: a front door and N worker processes speaking a
thin length-prefixed socket protocol.

The port of ``waffle_con_tpu``'s ``serve/procs`` package.
:class:`~waffle_con_tpu_torch.serve.replicas.ReplicatedService` routes
over in-process replicas, which share one GIL; this package puts the same
seam between processes, each with its own GIL and CUDA context, and a
crash boundary between them:

* :mod:`~waffle_con_tpu_torch.serve.procs.wire` — the frame codec
  (version byte and checksum on every frame, JSON payloads, no pickle on
  the wire, typed decode errors) and the config, request and result
  codecs, which the consensus cache also stores its results in.
* :mod:`~waffle_con_tpu_torch.serve.procs.worker` — the worker process
  (``python -m waffle_con_tpu_torch.serve.procs.worker``): one
  :class:`~waffle_con_tpu_torch.serve.service.ConsensusService` with its
  own dispatcher, serving pool and worker pool, forwarding its flight
  triggers and incidents over the socket.
* :mod:`~waffle_con_tpu_torch.serve.procs.door` — the front door
  (:class:`ProcFrontDoor`, :class:`ProcConfig`): admission, aging and
  placement; routes to the least-loaded healthy worker; demotes and sheds
  workers from their forwarded triggers; migrates or requeues a lost
  worker's jobs.

The crash boundary: a drained or crashed worker's jobs not yet started
are requeued as they are; started jobs **migrate**: workers stream every
search checkpoint (``ServeConfig.checkpoint_interval_s``, a deadline's
lapse, a drain) back as ``CHECKPOINT`` frames, and the door re-dispatches
a lost worker's started jobs with their latest checkpoints, so each search
resumes at its last pop boundary on a healthy worker, byte-identical to
the uninterrupted run.  A started job with no checkpoint yet (or
``ProcConfig.checkpoint_migrate`` off) restarts from scratch under
``ProcConfig.restart_lost``, else fails with the typed
:class:`~waffle_con_tpu_torch.runtime.liveness.WorkerLost`.  A corrupt
checkpoint never fails or hangs the job: the worker's service refuses it
with a ``checkpoint_rejected`` incident and searches from scratch.
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
    "ProcConfig",
    "ProcFrontDoor",
    "UnknownFrameType",
    "UnsupportedVersion",
    "WireError",
    "encode_frame",
]


def __getattr__(name):
    # the door is imported on first use: the service's consensus cache
    # imports the wire codec of this package, and the door the service
    if name in ("ProcConfig", "ProcFrontDoor"):
        from waffle_con_tpu_torch.serve.procs import door

        return getattr(door, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
