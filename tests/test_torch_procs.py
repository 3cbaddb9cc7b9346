"""The port's out-of-process serving (``waffle_con_tpu_torch/serve/procs``:
the front door, the worker process) and worker liveness
(``runtime/liveness.py``), held to the JAX package's.

* ``tests/test_procs.py``'s door cases from its fake fleet on: threads that
  connect to the door's socket and speak the real frames, fabricating
  results (routing, health demotion, shed and readmit, an unknown health
  reason, a crash with one incident, ``restart_lost`` off, a liveness
  lapse, admission, an oversized submit, a failed send, an unencodable
  result, a handshake timeout) and the heartbeat ledger.  The JAX
  package's ``WAFFLE_PROC_*`` and ``WAFFLE_PROC_FRAME_MAX`` knobs are
  ``ProcConfig`` fields here.
* A fake worker that streams a ``CHECKPOINT`` frame and dies: the door
  re-dispatches the started job with that checkpoint to the real worker
  (``serve.procs.worker``'s ``_Worker``, run in a thread), which resumes it
  to the uninterrupted search's result.
* The ``--spec`` round trip: the template's fields reach the worker's
  ``ServeConfig``, the door-only fields the door alone.
* A job asking for ``"cuda"`` on this host without a card fails with a typed
  error through a real worker: nothing falls back to the CPU.
* One real worker process (``python -m waffle_con_tpu_torch.serve.procs.
  worker``): its results equal the JAX package's solo ``"python"`` results
  and the port's in-process results, byte for byte.  The SIGKILL drill is
  marked ``slow``, as the JAX package's is (each real worker imports torch,
  seconds a process); the card runs it in ``chip_smoke.py``'s
  ``procs_main``.
* The worker and the door import without JAX and load nothing of the JAX
  package.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time

import pytest
import torch

from waffle_con_tpu.config import CdwfaConfig as JConfig
from waffle_con_tpu.runtime.liveness import Heartbeats as JHeartbeats
from waffle_con_tpu.serve import JobRequest as JJobRequest
from waffle_con_tpu.serve import service as jservice
from waffle_con_tpu.serve.procs import wire as jwire
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.config import ConsensusCost
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.models.consensus import Consensus
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.runtime import events as runtime_events
from waffle_con_tpu_torch.runtime.liveness import Heartbeats, WorkerLost
from waffle_con_tpu_torch.serve import (
    JobRequest,
    JobStatus,
    ProcConfig,
    ProcFrontDoor,
    ServeConfig,
    ServiceOverloaded,
)
from waffle_con_tpu_torch.serve.job import JobHandle
from waffle_con_tpu_torch.serve.procs import wire
from waffle_con_tpu_torch.serve.procs import worker as worker_mod
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils.example_gen import generate_test

pytestmark = pytest.mark.serve

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# fake in-thread workers: the real protocol, scripted behaviour
# ---------------------------------------------------------------------

def _fake_result(request):
    return [Consensus(b"FAKE", ConsensusCost.L1_DISTANCE,
                      [0] * len(request.reads))]


class FakeWorker:
    """A worker that is a thread: connects to the door's socket, HELLOs,
    and answers SUBMITs with made-up results.

    ``behavior``:
      * ``"ok"`` — STARTED then RESULT for every job;
      * ``"crash-after-start"`` — STARTED for the first job, then the
        socket closes (a SIGKILL mid-job);
      * ``"checkpoint-then-crash"`` — STARTED, a CHECKPOINT frame of
        ``checkpoint``, then the socket closes;
      * ``"silent"`` — HELLO, then never answers (the liveness lapse);
      * ``"hold"`` — takes jobs, never finishes them;
      * ``"demote_hold"`` — first job: a backend_demoted HEALTH frame,
        STARTED, then the result only once ``release`` is set.
    """

    def __init__(self, socket_path, name, spec, behavior="ok",
                 triggers=None, checkpoint=None):
        self.name = name
        self.spec = spec
        self.behavior = behavior
        self.triggers = list(triggers or [])
        self.checkpoint = checkpoint
        self.jobs_seen = []
        self.submits = []
        self.release = threading.Event()
        self.pid = os.getpid()
        self._exited = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(socket_path,), daemon=True
        )
        self._thread.start()

    # the Popen-like surface the door's watchdog expects
    def poll(self):
        return None if not self._exited.is_set() else 0

    def wait(self, timeout=None):
        self._exited.wait(timeout)
        return 0

    def terminate(self):
        self._exited.set()

    kill = terminate

    def _send(self, sock, ftype, obj):
        sock.sendall(wire.encode_frame(ftype, obj))

    def _reply(self, sock, job_id, request):
        self._send(sock, wire.FrameType.STARTED, {"job": job_id})
        self._send(sock, wire.FrameType.RESULT, {
            "job": job_id, "kind": "single",
            "result": wire.encode_result("single", _fake_result(request)),
        })

    def _demote_and_hold(self, sock, job_id, request):
        self._send(sock, wire.FrameType.HEALTH, {
            "worker": self.name, "reason": "backend_demoted",
            "trace": f"{self.name}/job-{job_id}", "detail": {},
        })
        self._send(sock, wire.FrameType.STARTED, {"job": job_id})

        def later():
            self.release.wait(10)
            try:
                self._send(sock, wire.FrameType.RESULT, {
                    "job": job_id, "kind": "single",
                    "result": wire.encode_result(
                        "single", _fake_result(request)),
                })
            except OSError:
                pass

        threading.Thread(target=later, daemon=True).start()

    def _run(self, socket_path):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(socket_path)
        decoder = wire.FrameDecoder()
        self._send(sock, wire.FrameType.HELLO, {
            "worker": self.name, "pid": self.pid, "slots": 2,
        })
        for trig in self.triggers:
            self._send(sock, wire.FrameType.HEALTH, trig)
        try:
            while True:
                data = sock.recv(65536)
                if not data:
                    return
                if self.behavior == "silent":
                    continue
                for ftype, obj in decoder.feed(data):
                    if ftype is wire.FrameType.PING:
                        self._send(sock, wire.FrameType.PONG,
                                   {"outstanding": 0, "slots": 2})
                    elif ftype is wire.FrameType.SUBMIT:
                        job_id = obj["job"]
                        request = wire.decode_request(obj["request"])
                        self.jobs_seen.append(job_id)
                        self.submits.append(obj)
                        if self.behavior == "hold":
                            continue
                        if self.behavior == "crash-after-start":
                            self._send(sock, wire.FrameType.STARTED,
                                       {"job": job_id})
                            return  # the socket closes mid-job
                        if self.behavior == "checkpoint-then-crash":
                            self._send(sock, wire.FrameType.STARTED,
                                       {"job": job_id})
                            self._send(sock, wire.FrameType.CHECKPOINT, {
                                "job": job_id, "data": self.checkpoint,
                                "bytes": len(json.dumps(self.checkpoint)),
                            })
                            return
                        if (self.behavior == "demote_hold"
                                and len(self.jobs_seen) == 1):
                            self._demote_and_hold(sock, job_id, request)
                            continue
                        self._reply(sock, job_id, request)
                    elif ftype is wire.FrameType.SHUTDOWN:
                        return
        except OSError:
            pass
        finally:
            self._exited.set()
            try:
                sock.close()
            except OSError:
                pass


class ThreadWorker:
    """The real worker (``serve.procs.worker.main``) in a thread of the
    test process, behind the Popen-like surface."""

    def __init__(self, socket_path, name, spec):
        self.name = name
        self.spec = spec
        self.pid = os.getpid()
        self._exited = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(socket_path,), daemon=True
        )
        self._thread.start()

    def _run(self, socket_path):
        try:
            worker_mod.main(["--socket", socket_path, "--worker", self.name,
                             "--spec", self.spec])
        finally:
            self._exited.set()

    def poll(self):
        return 0 if self._exited.is_set() else None

    def wait(self, timeout=None):
        if not self._exited.wait(timeout):
            raise subprocess.TimeoutExpired("thread worker", timeout)
        return 0

    def terminate(self):
        pass

    kill = terminate


class FakeFleet:
    """The launcher seam: hands the door workers by scripted name
    (``"real"`` runs :class:`ThreadWorker`)."""

    def __init__(self, behaviors=None, triggers=None, checkpoint=None):
        self.behaviors = behaviors or {}
        self.triggers = triggers or {}
        self.checkpoint = checkpoint
        self.workers = {}

    def __call__(self, socket_path, name, spec):
        behavior = self.behaviors.get(name, "ok")
        if behavior == "real":
            worker = ThreadWorker(socket_path, name, spec)
        else:
            worker = FakeWorker(
                socket_path, name, spec, behavior=behavior,
                triggers=self.triggers.get(name),
                checkpoint=self.checkpoint,
            )
        self.workers[name] = worker
        return worker


def _cfg(backend="torch", **kw):
    b = CdwfaConfigBuilder().backend(backend)
    if backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _request(n_reads=2):
    return JobRequest(kind="single", reads=(b"ACGT",) * n_reads,
                      config=_cfg())


def _door(fleet, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("name", "fake")
    kw.setdefault("spawn_timeout_s", 10.0)
    return ProcFrontDoor(ProcConfig(launcher=fleet, **kw))


def _wait_for(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.01)
    return pred()


def test_fake_fleet_routes_and_decodes():
    fleet = FakeFleet()
    with _door(fleet) as door:
        handles = [door.submit(_request()) for _ in range(6)]
        results = [h.result(timeout=10) for h in handles]
    assert all(r[0].sequence == b"FAKE" for r in results)
    stats = door.worker_stats()
    assert sum(w["routed"] for w in stats) == 6
    assert all(w["routed"] > 0 for w in stats)  # both took jobs
    assert all(w["start_s"] is not None and w["start_s"] >= 0
               for w in stats)


def test_health_demotion_drains_then_readmits():
    # the routing tie-break is the worker's index: the first job is w0's
    fleet = FakeFleet(behaviors={"fake:w0": "demote_hold"})
    with _door(fleet) as door:
        first = door.submit(_request())
        demoted = _wait_for(lambda: next(
            (w for w in door.worker_stats() if w["state"] == "draining"),
            None))
        assert demoted, door.worker_stats()
        healthy = next(w["worker"] for w in door.worker_stats()
                       if w["worker"] != demoted["worker"])
        # while it drains beside a healthy peer, nothing new routes to it
        for _ in range(4):
            door.submit(_request()).result(timeout=10)
        stats = {w["worker"]: w for w in door.worker_stats()}
        assert stats[healthy]["routed"] == 4
        assert stats[demoted["worker"]]["routed"] == 1
        assert stats[demoted["worker"]]["demotions"] == 1
        # the held job finishes: drained, the next routing re-admits it
        fleet.workers[demoted["worker"]].release.set()
        assert first.result(timeout=10)[0].sequence == b"FAKE"
        door.submit(_request()).result(timeout=10)
        stats = {w["worker"]: w for w in door.worker_stats()}
        assert stats[demoted["worker"]]["state"] == "up"
        assert stats[demoted["worker"]]["readmits"] == 1


def test_health_slow_search_sheds_with_cooldown():
    fleet = FakeFleet(triggers={
        "fake:w1": [{"worker": "fake:w1", "reason": "slow_search",
                     "trace": "fake:w1/job-9", "detail": {}}],
    })
    with _door(fleet, shed_cooldown_s=0.2) as door:
        assert _wait_for(lambda: {w["worker"]: w["state"] for w in
                                  door.worker_stats()}["fake:w1"]
                         == "shedding")
        time.sleep(0.25)  # the cooldown ends at the next routing pass
        door.submit(_request()).result(timeout=10)
        rows = {w["worker"]: w for w in door.worker_stats()}
        assert rows["fake:w1"]["state"] == "up"
        assert rows["fake:w1"]["sheds"] == 1


def test_health_unknown_reason_counted_not_silent():
    # a HEALTH reason this door does not act on changes no routing state,
    # but is recorded (an event) and counted (a reason-labelled counter)
    obs_metrics.enable_metrics(True)
    obs_metrics.registry().reset()
    try:
        fleet = FakeFleet(triggers={
            "fake:w0": [{"worker": "fake:w0",
                         "reason": "reason_from_the_future",
                         "trace": "fake:w0/job-1", "detail": {}}],
        })
        with _door(fleet) as door:
            ignored = _wait_for(lambda: [
                e for e in runtime_events.get_events("door_health_ignored")
                if e["reason"] == "reason_from_the_future"])
            assert ignored, "no ignored-HEALTH event recorded"
            assert ignored[-1]["worker"] == "fake:w0"
            door.submit(_request()).result(timeout=10)
            states = {w["worker"]: w["state"]
                      for w in door.worker_stats()}
            assert states["fake:w0"] == "up"
        text = obs_metrics.registry().render_prometheus()
        assert "waffle_door_health_ignored_total" in text
        assert 'reason="reason_from_the_future"' in text
    finally:
        obs_metrics.registry().reset()
        obs_metrics.reset_metrics_enabled()


def test_crashed_worker_requeues_and_single_incident():
    obs_flight.reset()
    fleet = FakeFleet(behaviors={"fake:w0": "crash-after-start"})
    with _door(fleet, worker_slots=1, inflight=1) as door:
        handles = [door.submit(_request()) for _ in range(4)]
        results = [h.result(timeout=10) for h in handles]
        assert all(r[0].sequence == b"FAKE" for r in results)
        stats = {w["worker"]: w for w in door.worker_stats()}
        assert stats["fake:w0"]["state"] == "lost"
        # the started job restarted, any queued one requeued
        assert stats["fake:w0"]["requeues"] >= 1
        assert stats["fake:w1"]["routed"] == 4
    incidents = [i for i in obs_flight.incidents()
                 if i["reason"] == "worker_lost"]
    assert len(incidents) == 1  # one, though reader and watchdog both see it


def test_restart_lost_off_fails_started_jobs_typed():
    fleet = FakeFleet(behaviors={"fake:w0": "crash-after-start",
                                 "fake:w1": "crash-after-start"})
    with _door(fleet, restart_lost=False, worker_slots=1,
               inflight=1) as door:
        handle = door.submit(_request())
        assert handle.wait(10)
        assert handle.status is JobStatus.FAILED
        with pytest.raises(WorkerLost):
            handle.result(timeout=0)


def test_silent_worker_hits_liveness_lapse():
    obs_flight.reset()
    fleet = FakeFleet(behaviors={"fake:w0": "silent"})
    with _door(fleet, worker_slots=1, inflight=1, ping_s=0.05,
               liveness_s=0.3) as door:
        handles = [door.submit(_request()) for _ in range(3)]
        results = [h.result(timeout=10) for h in handles]
        assert all(r[0].sequence == b"FAKE" for r in results)
        states = {w["worker"]: w["state"] for w in door.worker_stats()}
        assert states["fake:w0"] == "lost"


def test_admission_rejects_when_full():
    fleet = FakeFleet(behaviors={"fake:w0": "hold"})
    door = _door(fleet, workers=1, queue_limit=2, worker_slots=1,
                 inflight=1)
    try:
        # the held worker fills the routing window; the bounded queue
        # behind it fills and the door rejects, never blocks
        with pytest.raises(ServiceOverloaded):
            for _ in range(12):
                door.submit(_request())
    finally:
        door.close(cancel_pending=True, timeout=2.0)


def test_oversized_submit_fails_job_not_router():
    # a SUBMIT frame over max_payload fails that one job; the router
    # thread routes on
    fleet = FakeFleet()
    with _door(fleet, max_payload=4096) as door:
        big = JobRequest(kind="single", reads=(b"A" * 8192, b"A" * 8192),
                         config=_cfg())
        handle = door.submit(big)
        assert handle.wait(10)
        assert handle.status is JobStatus.FAILED
        with pytest.raises(wire.FrameTooLarge):
            handle.result(timeout=0)
        assert all(w["outstanding"] == 0 for w in door.worker_stats())
        follow_up = door.submit(_request())
        assert follow_up.result(timeout=10)[0].sequence == b"FAKE"


def test_dispatch_send_failure_respects_worker_lost_ownership():
    # the failed send requeues only a job still assigned: when a
    # concurrent _worker_lost already took and requeued it, a second
    # append would run the job twice
    door = ProcFrontDoor(
        ProcConfig(workers=1, launcher=lambda *a: None), autostart=False
    )
    try:
        worker = door._workers[0]
        a, b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
        a.close()
        b.close()
        worker.sock = a  # every sendall raises OSError
        handle = JobHandle(0, _request(), service="fake")
        worker.assigned[0] = handle
        assert door._dispatch(worker, handle) is False
        assert list(door._retry) == [handle]  # still ours: requeued
        assert 0 not in worker.assigned
        door._retry.clear()
        assert door._dispatch(worker, handle) is False
        assert not door._retry  # taken by _worker_lost: not ours
    finally:
        door.close(timeout=0.1)


def test_worker_unencodable_result_settles_as_error():
    # a DONE job whose result cannot be framed (a NaN score) still sends
    # ERROR, never silence
    from waffle_con_tpu_torch.analysis import lockcheck

    side_a, side_b = socket.socketpair(socket.AF_UNIX, socket.SOCK_STREAM)
    try:
        worker = worker_mod._Worker.__new__(worker_mod._Worker)
        worker._sock = side_a
        worker._name = "t"
        worker._max_payload = wire.MAX_PAYLOAD
        worker._send_lock = lockcheck.make_lock("test.procs.worker.send")

        class DoneHandle:
            status = JobStatus.DONE
            started_at = 1.0
            request = _request()

            def wait_running(self, timeout=None):
                return True

            def wait(self, timeout=None):
                return True

            def result(self, timeout=None):
                return [Consensus(b"ACGT", ConsensusCost.L1_DISTANCE,
                                  [float("nan")])]

        worker._watch(7, DoneHandle())
        side_b.settimeout(5)
        decoder = wire.FrameDecoder()
        frames = []
        while len(frames) < 2:
            frames.extend(decoder.feed(side_b.recv(65536)))
        assert [f for f, _ in frames] == [wire.FrameType.STARTED,
                                          wire.FrameType.ERROR]
        obj = frames[-1][1]
        assert obj["job"] == 7 and obj["kind"] == "failed"
        assert "wire-encodable" in obj["message"]
    finally:
        side_a.close()
        side_b.close()


def test_handshake_timeout_reaps_spawned_workers():
    # a raising start() leaves none of the processes it launched alive

    class DeadProc:
        def __init__(self):
            self.terminated = False

        def poll(self):
            return None

        def terminate(self):
            self.terminated = True

        def wait(self, timeout=None):
            if not self.terminated:
                raise RuntimeError("still alive")
            return 0

        def kill(self):
            self.terminated = True

    procs = []

    def launcher(socket_path, name, spec):
        procs.append(DeadProc())
        return procs[-1]  # never connects: the handshake times out

    with pytest.raises(RuntimeError, match="handshake timed out"):
        ProcFrontDoor(ProcConfig(workers=2, launcher=launcher,
                                 spawn_timeout_s=0.2))
    assert len(procs) == 2
    assert all(p.terminated for p in procs)


def test_heartbeats_ledger_matches_jax():
    def drive(cls):
        clock = [0.0]
        beats = cls(clock=lambda: clock[0])
        beats.beat("a")
        clock[0] = 1.0
        beats.beat("b")
        clock[0] = 3.0
        out = [beats.age("a"), beats.age("b"), beats.age("z"),
               beats.lapsed(2.5), sorted(beats.lapsed(0.5))]
        beats.forget("a")
        out += [beats.age("a"), beats.lapsed(0.5)]
        return out

    got = drive(Heartbeats)
    assert got == drive(JHeartbeats)
    assert got == [3.0, 2.0, None, ["a"], ["a", "b"], None, ["b"]]


@pytest.mark.parametrize("field,value", [
    ("workers", 0), ("worker_slots", 0), ("queue_limit", 0),
    ("aging_s", 0.0), ("shed_cooldown_s", -1.0), ("inflight", 0),
    ("spawn_timeout_s", 0.0), ("ping_s", 0.0), ("liveness_s", 0.0),
    ("stats_interval_s", 0.04), ("trace_span_cap", 15),
    ("max_payload", wire.MIN_MAX_PAYLOAD - 1), ("serve", {}),
])
def test_config_rejects_out_of_range_fields(field, value):
    with pytest.raises((ValueError, TypeError)):
        ProcConfig(**{field: value})


# ---------------------------------------------------------------------
# the spec, migration and the card, through the real worker in a thread
# ---------------------------------------------------------------------

def test_worker_spec_round_trip(tmp_path):
    template = ServeConfig(
        workers=7, queue_limit=3, batch_window_s=0.01, max_batch=5,
        name="ignored", adaptive_window=False, aging_s=2.0,
        ragged=False, ragged_mixed_w=False, ragged_rows=512,
        ragged_page=16, ragged_e=64, ragged_l=1024, ragged_c=4096,
        ragged_gang=4, checkpoint_interval_s=0.5,
        checkpoint_max_bytes=1 << 20,
        stats_file=str(tmp_path / "stats.json"),
        flight_dir=str(tmp_path / "flight"), cache=True,
        cache_max_results=9, cache_max_checkpoints=5,
        cache_proposals=False,
    )
    previous = obs_flight.incident_dir()
    try:
        for forward in (True, False):
            template = dataclasses.replace(
                template, cache_dir=str(tmp_path / f"cache-{forward}"))
            fleet = FakeFleet()
            with _door(fleet, worker_slots=3, queue_limit=11, aging_s=0.75,
                       serve=template, forward_incidents=forward,
                       stats_interval_s=0.3, trace_span_cap=64,
                       max_payload=1 << 20) as door:
                door.submit(_request()).result(timeout=10)
                door_cache = door._cache
            assert door_cache is not None  # the door's cache
            assert door_cache.stats()["deposits"] == 1
            assert os.path.exists(template.stats_file)  # the door's file
            for name, worker in fleet.workers.items():
                spec = json.loads(worker.spec)
                got = ServeConfig(**spec["serve"])
                assert got.workers == 3 and got.queue_limit == 11
                assert got.name == name and got.aging_s == 0.75
                # every field of the template but the door's and the ones
                # ProcConfig sets reaches the worker as it was
                for field in ("batch_window_s", "max_batch",
                              "adaptive_window", "ragged",
                              "ragged_mixed_w", "ragged_rows",
                              "ragged_page", "ragged_e", "ragged_l",
                              "ragged_c", "ragged_gang",
                              "checkpoint_interval_s",
                              "checkpoint_max_bytes"):
                    assert getattr(got, field) == getattr(template, field)
                # the door's fields stay at the door
                assert got.stats_file is None and got.placement is None
                assert not got.cache and got.cache_dir is None
                assert got.cache_max_results == 256
                assert got.flight_dir == (None if forward
                                          else template.flight_dir)
                assert spec["stats_interval_s"] == 0.3
                assert spec["trace_span_cap"] == 64
                assert spec["max_payload"] == 1 << 20
                assert spec["forward_incidents"] is forward
                assert spec["trace"] is False and spec["metrics"] is False
    finally:
        obs_flight.set_incident_dir(previous)


def _snapshot(request, at):
    """A wire snapshot of ``request``'s serial search at poll ``at`` and
    the search's own result (it runs on to its end)."""
    snaps = []
    ctrl = ckpt_mod.CheckpointController(snapshot_at_pops={at},
                                         on_snapshot=snaps.append)
    with ckpt_mod.installed(ctrl):
        result = _build_engine(request).consensus()
    assert len(snaps) == 1
    return snaps[0].to_wire(), result


def _key(kind, result):
    return json.dumps(wire.encode_result(kind, result))


@pytest.mark.parametrize("kind,backend", [("single", "torch"),
                                          ("dual", "python")])
def test_lost_workers_checkpoint_migrates_and_resumes(kind, backend):
    truth, reads = generate_test(4, 160, 8, 0.03, seed=21)
    if kind == "dual":
        h2 = bytearray(truth)
        h2[80] = (h2[80] + 1) % 4
        reads = list(reads) + [bytes(h2)] * 6
    request = JobRequest(kind=kind, reads=tuple(reads),
                         config=_cfg(backend, min_count=2))
    checkpoint, want = _snapshot(request, at=5)
    runtime_events.clear_events()
    obs_flight.reset()
    fleet = FakeFleet(behaviors={"mig:w0": "checkpoint-then-crash",
                                 "mig:w1": "real"}, checkpoint=checkpoint)
    with _door(fleet, name="mig", worker_slots=1, inflight=1) as door:
        handle = door.submit(request)
        got = handle.result(timeout=60)
        stats = {w["worker"]: w for w in door.worker_stats()}
    assert _key(kind, got) == _key(kind, want)
    assert stats["mig:w0"]["state"] == "lost"
    assert stats["mig:w0"]["migrations"] == 1
    assert stats["mig:w0"]["ckpt_frames"] == 1
    assert stats["mig:w0"]["restarts"] == 0
    assert stats["mig:w1"]["routed"] == 1
    # the real worker resumed the search from the checkpoint it was sent
    resumed = runtime_events.get_events("job_resumed")
    assert [e["service"] for e in resumed] == ["mig:w1"]
    rescued = runtime_events.get_events("worker_jobs_rescued")
    assert rescued[-1]["migrated"] == 1
    assert len([i for i in obs_flight.incidents()
                if i["reason"] == "worker_lost"]) == 1


def test_cuda_job_without_a_card_fails_typed():
    # the default device is "cuda": on this host without a card the real
    # worker's job fails with the engine's error, nothing runs on the CPU
    fleet = FakeFleet(behaviors={"card:w0": "real"})
    config = CdwfaConfigBuilder().backend("torch").min_count(2).build()
    assert config.device == "cuda"
    request = JobRequest(kind="single", reads=(b"ACGTACGTAC",) * 3,
                         config=config)
    with _door(fleet, workers=1, name="card") as door:
        handle = door.submit(request)
        assert handle.wait(30)
    assert handle.status is JobStatus.FAILED
    with pytest.raises(RuntimeError, match="no CUDA device"):
        handle.result(timeout=0)


# ---------------------------------------------------------------------
# real worker processes
# ---------------------------------------------------------------------

def _jax_key(kind, reads, **cfg):
    jcfg = JConfig(backend="python", **cfg)
    res = jservice._build_engine(
        JJobRequest(kind=kind, reads=reads, config=jcfg)).consensus()
    return json.dumps(jwire.encode_result(kind, res))


def test_subprocess_worker_end_to_end_parity(monkeypatch):
    # the child takes one intra-op thread from its inherited environment
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    shapes = [
        ("single", (b"ACGTACGTAC",) * 3),
        ("dual", (b"ACGTACGTAC", b"ACGTACGTAC", b"ACTTACGTAC",
                  b"ACTTACGTAC")),
        ("priority", ((b"ACGT", b"ACGTACGT"), (b"ACGA", b"ACGTACGA"),
                      (b"ACGT", b"ACGTACGT"))),
    ]
    reqs = [JobRequest(kind=kind, reads=reads, config=_cfg(min_count=2))
            for kind, reads in shapes]
    jax_refs = [_jax_key(kind, reads, min_count=2) for kind, reads in shapes]
    port_refs = [_key(r.kind, _build_engine(r).consensus()) for r in reqs]
    assert port_refs == jax_refs
    with ProcFrontDoor(ProcConfig(workers=1, name="e2e")) as door:
        handles = [door.submit(r) for r in reqs for _ in range(2)]
        results = [h.result(timeout=120) for h in handles]
        procs = [w.proc for w in door._workers]
    for i, (req, ref) in enumerate(zip(reqs, jax_refs)):
        assert _key(req.kind, results[2 * i]) == ref
        assert _key(req.kind, results[2 * i + 1]) == ref
    assert [p.returncode for p in procs] == [0]  # exited on SHUTDOWN


@pytest.mark.slow
def test_subprocess_sigkill_drill(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    obs_flight.reset()
    truth, reads = generate_test(4, 160, 8, 0.03, seed=21)
    h2 = bytearray(truth)
    h2[80] = (h2[80] + 1) % 4
    req = JobRequest(kind="dual", reads=tuple(reads) + (bytes(h2),) * 6,
                     config=_cfg(backend="python", min_count=2))
    ref = _key("dual", _build_engine(req).consensus())
    with ProcFrontDoor(ProcConfig(
            workers=2, worker_slots=1, name="drill", ping_s=0.2,
            liveness_s=2.0,
            serve=ServeConfig(checkpoint_interval_s=0.1))) as door:
        handles = [door.submit(req) for _ in range(8)]
        # the victim: a worker that has streamed a checkpoint of a job it
        # is running
        victim = _wait_for(lambda: next(
            (w for w in door.worker_stats()
             if w["ckpt_frames"] and w["started"]), None), timeout=60)
        assert victim, door.worker_stats()
        os.kill(victim["pid"], signal.SIGKILL)
        results = [h.result(timeout=120) for h in handles]
        stats = {w["worker"]: w for w in door.worker_stats()}
    assert all(_key("dual", r) == ref for r in results)
    assert stats[victim["worker"]]["state"] == "lost"
    assert stats[victim["worker"]]["migrations"] >= 1
    assert len([i for i in obs_flight.incidents()
                if i["reason"] == "worker_lost"]) == 1


_PROBE = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None          # any import of jax now fails
    from waffle_con_tpu_torch.serve.procs import door, worker
    from waffle_con_tpu_torch.serve.procs import ProcConfig, ProcFrontDoor
    assert ProcFrontDoor is door.ProcFrontDoor
    assert worker._Worker and ProcConfig().workers == 2
    loaded = sorted(m for m in sys.modules if m == "waffle_con_tpu"
                    or m.startswith("waffle_con_tpu."))
    assert not loaded, loaded
    print("ok")
    """
)


def test_worker_and_door_import_without_jax():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"),
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
