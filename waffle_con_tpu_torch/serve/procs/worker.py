"""Worker-process entry point: one ConsensusService behind a socket.

The port of ``waffle_con_tpu``'s ``serve/procs/worker.py``.  The front
door (:mod:`waffle_con_tpu_torch.serve.procs.door`) launches it as::

    python -m waffle_con_tpu_torch.serve.procs.worker \\
        --socket PATH --worker NAME --spec JSON

Each worker owns a whole in-process serving stack (batching dispatcher,
serving pool, worker pool, its own CUDA context) exactly as a
single-process :class:`~waffle_con_tpu_torch.serve.service.
ConsensusService` runs it, so results are byte-identical by construction;
the only code of its own is the socket plumbing.  The ``--spec`` JSON
carries its service's ``ServeConfig`` field by field
(:meth:`~waffle_con_tpu_torch.serve.procs.door.ProcFrontDoor.worker_spec`)
and the process knobs: the worker reads no environment variable.  A job whose
config asks for ``"cuda"`` on a host without a card fails with a typed
``ERROR``, as it would in process: nothing here falls back to the CPU.

Protocol (:mod:`waffle_con_tpu_torch.serve.procs.wire`):

* connect, send ``HELLO {worker, pid, slots}``;
* every ``SUBMIT`` is decoded (typed codec, never pickle), submitted
  locally, and watched by a thread of its own that reports ``STARTED``
  when the job runs, then exactly one of ``RESULT`` / ``ERROR`` (kind
  ``cancelled`` / ``expired`` / ``failed``); a result that cannot be
  encoded settles as an ``ERROR``, never as silence.  A SUBMIT with a
  ``checkpoint`` resumes that search (a migration off a lost worker);
* every checkpoint the local service snapshots (the
  ``checkpoint_interval_s`` cadence, a deadline's lapse, a drain) goes
  back as a ``CHECKPOINT`` frame, so the door always holds the latest
  resume point; an ``expired`` ERROR carries the final one inline;
* every local flight trigger goes to the door as a ``HEALTH`` frame, and
  (``forward_incidents``) every incident as an ``INCIDENT`` frame, which
  the door re-ingests with the worker's name and fleet-wide dedupe;
* a SUBMIT with a ``trace`` context is **adopted**: the job's spans record
  under the door's trace id and Chrome pid, and travel back on ``RESULT``
  / ``ERROR`` / ``CHECKPOINT`` frames (at most ``trace_span_cap`` a frame);
* while metrics are on, a ``STATS`` frame every ``stats_interval_s`` ships
  the registry snapshot and the rolling SLO windows;
* ``PING`` answers ``PONG {outstanding, slots}``; ``DRAIN`` refuses
  further submits and asks every running search to checkpoint at its next
  pop boundary; ``SHUTDOWN``, or the socket's end (the door died), closes
  the service and exits.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import threading
import time
from typing import Any, Dict, Optional

from waffle_con_tpu_torch.serve.procs import wire

RECV_CHUNK = 1 << 16


def _json_safe(detail: Dict) -> Dict:
    """Flight trigger details may hold any object; the wire carries
    strings."""
    out = {}
    for key, value in detail.items():
        out[str(key)] = (value if isinstance(value, (int, float, bool,
                                                     str, type(None)))
                         else str(value))
    return out


class _Worker:
    """Socket-side state of one worker process."""

    def __init__(self, sock: socket.socket, name: str, spec: Dict) -> None:
        from waffle_con_tpu_torch.analysis import lockcheck
        from waffle_con_tpu_torch.serve.service import (
            ConsensusService,
            ServeConfig,
        )

        config = ServeConfig(**spec["serve"])
        self._sock = sock
        self._name = name
        self._max_payload = int(spec["max_payload"])
        self._stats_interval_s = float(spec["stats_interval_s"])
        self._span_cap = int(spec["trace_span_cap"])
        self._forward_incidents = bool(spec["forward_incidents"])
        self._decoder = wire.FrameDecoder(max_payload=self._max_payload)
        self._send_lock = lockcheck.make_lock("procs.worker.send")
        self._make_thread = lockcheck.make_thread
        self._draining = False
        self._stopped = threading.Event()
        self._slots = config.workers
        # tracing and metrics are switched on in code at the door: the
        # spec tells the worker to arm its own, so spans and STATS frames
        # flow back
        if spec.get("metrics"):
            from waffle_con_tpu_torch.obs import metrics as obs_metrics

            obs_metrics.enable_metrics(True)
        if spec.get("trace"):
            from waffle_con_tpu_torch.obs import trace as obs_trace

            obs_trace.get_tracer().enable(True)
        self._service = ConsensusService(config)

    # -- sends (serialized: frames never interleave) -------------------

    def send(self, ftype: wire.FrameType, obj: Any) -> None:
        frame = wire.encode_frame(ftype, obj, max_payload=self._max_payload)
        try:
            with self._send_lock:
                self._sock.sendall(frame)
        except OSError:
            pass  # the door is gone: the reader sees the end and exits

    # -- flight forwarding ---------------------------------------------

    def on_trigger(self, reason: str, trace_id: Optional[str],
                   detail: Dict) -> None:
        self.send(wire.FrameType.HEALTH, {
            "worker": self._name,
            "reason": reason,
            "trace": trace_id,
            "detail": _json_safe(detail),
        })

    def on_incident(self, incident: Dict) -> None:
        """Forward one incident to the door (an oversized one goes as its
        identity fields, never as silence)."""
        if not self._forward_incidents:
            return
        try:
            # a JSON round trip with repr for the values the strict codec
            # refuses
            safe = json.loads(json.dumps(incident, default=repr))
        except (TypeError, ValueError):
            return
        try:
            self.send(wire.FrameType.INCIDENT,
                      {"worker": self._name, "incident": safe})
        except (wire.WireError, ValueError):
            slim = {
                k: safe.get(k)
                for k in ("schema", "seq", "reason", "trace_id",
                          "unix_time", "detail")
            }
            slim["truncated"] = True
            try:
                self.send(wire.FrameType.INCIDENT,
                          {"worker": self._name, "incident": slim})
            except (wire.WireError, ValueError):
                pass

    # -- federated metrics ---------------------------------------------

    def _stats_loop(self) -> None:
        """Ship the registry snapshot and the SLO windows every
        ``stats_interval_s`` (the first frame at once, so a short-lived
        fleet still federates)."""
        from waffle_con_tpu_torch.obs import flight as obs_flight
        from waffle_con_tpu_torch.obs import metrics as obs_metrics
        from waffle_con_tpu_torch.obs import slo as obs_slo

        while True:
            try:
                self.send(wire.FrameType.STATS, {
                    "worker": self._name,
                    "unix_time": time.time(),
                    "metrics": obs_metrics.registry().snapshot(),
                    "slo": obs_slo.snapshot(),
                    "incidents": len(obs_flight.incidents()),
                })
            except Exception:  # noqa: BLE001 - one bad snapshot never
                pass           # stops the cadence
            if self._stopped.wait(self._stats_interval_s):
                return

    # -- span buffers --------------------------------------------------

    def _span_payload(self, ctx) -> Optional[Dict]:
        """Drain this job's span events (by its adopted Chrome pid) for a
        frame; ``None`` when tracing is off or nothing is buffered (the
        frame then has no ``spans`` key)."""
        if ctx is None:
            return None
        from waffle_con_tpu_torch.obs import trace as obs_trace

        tracer = obs_trace.get_tracer()
        if not tracer.enabled:
            return None
        events = tracer.drain_events(ctx.chrome_pid, limit=self._span_cap)
        if not events:
            return None
        return {"events": events, "origin_us": tracer.unix_origin_us()}

    # -- frame handlers ------------------------------------------------

    def _watch(self, job_id: int, handle, ctx=None,
               flow_id: Optional[int] = None) -> None:
        """Report one job's life cycle to the door, in order."""
        from waffle_con_tpu_torch.serve.job import JobStatus

        handle.wait_running()
        if handle.started_at is not None:
            self.send(wire.FrameType.STARTED, {"job": job_id})
        handle.wait()
        status = handle.status
        if ctx is not None and flow_id is not None:
            # the return hop's flow arrow: started here, finished by the
            # door when it takes the RESULT / ERROR
            from waffle_con_tpu_torch.obs import trace as obs_trace

            obs_trace.get_tracer().flow("s", flow_id + 1, "result",
                                        ctx=ctx)
        spans = self._span_payload(ctx)
        if status is JobStatus.DONE:
            try:
                frame = {
                    "job": job_id,
                    "kind": handle.request.kind,
                    "result": wire.encode_result(
                        handle.request.kind, handle.result(timeout=0)
                    ),
                }
                if spans is not None:
                    frame["spans"] = spans
                self.send(wire.FrameType.RESULT, frame)
            except Exception as exc:  # noqa: BLE001 - an unencodable
                # result (an oversized frame, a NaN score) still settles
                # the door-side handle: it is reported as a failure
                self.send(wire.FrameType.ERROR, {
                    "job": job_id,
                    "kind": "failed",
                    "type": type(exc).__name__,
                    "message": f"result not wire-encodable: {exc}",
                })
            return
        try:
            handle.result(timeout=0)
            exc: BaseException = RuntimeError("job failed without exception")
        except BaseException as caught:  # noqa: BLE001 - reported, not handled
            exc = caught
        kind = {JobStatus.CANCELLED: "cancelled",
                JobStatus.EXPIRED: "expired"}.get(status, "failed")
        frame = {
            "job": job_id,
            "kind": kind,
            "type": type(exc).__name__,
            "message": str(exc),
        }
        if kind == "expired" and handle.checkpoint is not None:
            # deadline persistence: the EXPIRED verdict carries the final
            # checkpoint, so the client resubmits with a fresh budget
            frame["checkpoint"] = handle.checkpoint
        if spans is not None:
            frame["spans"] = spans
        self.send(wire.FrameType.ERROR, frame)

    def _send_checkpoint(self, job_id: int, data, ctx) -> None:
        frame = {
            "job": job_id,
            "data": data,
            "bytes": len(json.dumps(data, separators=(",", ":"))),
        }
        # a long job streams its finished spans with its snapshots; the
        # final RESULT / ERROR drains the rest
        spans = self._span_payload(ctx)
        if spans is not None:
            frame["spans"] = spans
        self.send(wire.FrameType.CHECKPOINT, frame)

    def _on_submit(self, obj: Dict) -> None:
        job_id = int(obj["job"])
        if self._draining:
            self.send(wire.FrameType.ERROR, {
                "job": job_id, "kind": "failed",
                "type": "ServiceClosed",
                "message": f"worker {self._name} is draining",
            })
            return
        try:
            trace_obj = wire.decode_trace(obj.get("trace"))
        except wire.WireError:
            trace_obj = None  # a malformed context never fails a job
        ctx = None
        try:
            request = wire.decode_request(obj["request"])
            if trace_obj is not None:
                from waffle_con_tpu_torch.obs import trace as obs_trace

                # the door's trace identity is adopted before the handle
                # is queued: the job's spans carry the door's trace id and
                # Chrome pid and nest under its per-job root span
                ctx = obs_trace.context_from_wire(trace_obj)
            handle = self._service.submit(
                request, checkpoint=obj.get("checkpoint"), trace=ctx
            )
        except Exception as exc:  # noqa: BLE001 - reported, not handled
            self.send(wire.FrameType.ERROR, {
                "job": job_id, "kind": "failed",
                "type": type(exc).__name__, "message": str(exc),
            })
            return
        flow_id = trace_obj.get("flow_id") if trace_obj else None
        if ctx is not None and flow_id is not None:
            from waffle_con_tpu_torch.obs import trace as obs_trace

            # the door's submit-hop arrow ends on this side; the event
            # travels back with the span buffer
            obs_trace.get_tracer().flow("f", flow_id, "submit", ctx=ctx)
        handle.on_checkpoint = lambda data: self._send_checkpoint(
            job_id, data, ctx
        )
        watcher = self._make_thread(
            target=self._watch, args=(job_id, handle, ctx, flow_id),
            name=f"procs.worker.watch-{job_id}", daemon=True,
        )
        watcher.start()

    def _on_ping(self) -> None:
        self.send(wire.FrameType.PONG, {
            "worker": self._name,
            "outstanding": self._service.outstanding(),
            "slots": self._slots,
        })

    # -- main loop -----------------------------------------------------

    def serve(self) -> None:
        from waffle_con_tpu_torch.obs import flight as obs_flight
        from waffle_con_tpu_torch.obs import metrics as obs_metrics

        self.send(wire.FrameType.HELLO, {
            "worker": self._name, "pid": os.getpid(), "slots": self._slots,
        })
        obs_flight.add_trigger_listener(self.on_trigger)
        obs_flight.add_incident_listener(self.on_incident)
        if obs_metrics.metrics_enabled():
            # with metrics off no thread starts and no STATS frame is sent
            self._make_thread(
                target=self._stats_loop,
                name="procs.worker.stats", daemon=True,
            ).start()
        try:
            while True:
                try:
                    data = self._sock.recv(RECV_CHUNK)
                except OSError:
                    return
                if not data:
                    return  # the door closed or died: exit with it
                for ftype, obj in self._decoder.feed(data):
                    if ftype is wire.FrameType.SUBMIT:
                        self._on_submit(obj)
                    elif ftype is wire.FrameType.PING:
                        self._on_ping()
                    elif ftype is wire.FrameType.DRAIN:
                        self._draining = True
                        # every running search snapshots at its next pop
                        # boundary: if the drain runs out of time, the
                        # door already holds its latest resume point
                        self._service.request_checkpoints()
                    elif ftype is wire.FrameType.SHUTDOWN:
                        return
                    # any other frame from the door is ignored, not fatal
        finally:
            self._stopped.set()
            obs_flight.remove_trigger_listener(self.on_trigger)
            obs_flight.remove_incident_listener(self.on_incident)
            self._service.close(cancel_pending=True, timeout=10.0)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="waffle_con_tpu_torch out-of-process serving worker"
    )
    parser.add_argument("--socket", required=True,
                        help="the front door's AF_UNIX socket path")
    parser.add_argument("--worker", required=True,
                        help="this worker's name (stats and trace label)")
    parser.add_argument("--spec", required=True,
                        help="JSON: the service's config and the process "
                             "knobs (ProcFrontDoor.worker_spec)")
    args = parser.parse_args(argv)

    spec = json.loads(args.spec)
    sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    sock.connect(args.socket)
    try:
        _Worker(sock, args.worker, spec).serve()
    finally:
        try:
            sock.close()
        except OSError:
            pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
