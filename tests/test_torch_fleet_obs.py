"""The fleet observability plane of the port's out-of-process serving:
cross-process tracing, federated metrics and incident aggregation, held to
the JAX package's.

* The cases of ``tests/test_fleet_obs.py``: the ``SUBMIT`` trace context's
  codec and fuzz; ``merge_snapshot`` relabelling and skipping malformed
  series; the door merging fake workers' ``STATS`` frames as
  ``worker=``-labelled series, dumping forwarded ``INCIDENT`` frames once
  with attribution, ignoring malformed ones, and sending no ``trace`` key
  with the plane off; the real worker (in a thread) sending no ``STATS``
  frame with the plane off; and one real worker process whose job yields
  one connected span tree across the two processes.  The JAX package's
  ``WAFFLE_FLIGHT_DIR`` / ``WAFFLE_PROC_STATS_S`` / ``WAFFLE_PROC_FRAME_MAX``
  knobs are ``ServeConfig.flight_dir`` and ``ProcConfig`` fields here.
* Across the packages, on the same inputs: ``context_to_wire`` /
  ``context_from_wire``, ``merge_snapshot``'s exposition and
  ``ingest_remote``'s incident.
"""

import json
import os
import random
import socket
import threading
import time

import pytest
import torch

from waffle_con_tpu.obs import flight as jflight
from waffle_con_tpu.obs import metrics as jmetrics
from waffle_con_tpu.obs import trace as jtrace
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.config import ConsensusCost
from waffle_con_tpu_torch.models.consensus import Consensus
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import slo as obs_slo
from waffle_con_tpu_torch.obs import trace as obs_trace
from waffle_con_tpu_torch.serve import (
    JobRequest,
    ProcConfig,
    ProcFrontDoor,
    ServeConfig,
)
from waffle_con_tpu_torch.serve.procs import wire
from test_torch_procs import ThreadWorker

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the trace context's wire codec
# ---------------------------------------------------------------------

def test_trace_context_wire_roundtrip():
    ctx = obs_trace.TraceContext("storm/job-3", 1_000_003,
                                 label="job-3 [tag]")
    obj = obs_trace.context_to_wire(ctx, parent_span_id=1,
                                    span_base=2_000_000, flow_id=48)
    decoded = wire.decode_trace(obj)
    assert decoded == {
        "trace_id": "storm/job-3",
        "chrome_pid": 1_000_003,
        "label": "job-3 [tag]",
        "parent_span_id": 1,
        "span_base": 2_000_000,
        "flow_id": 48,
    }
    adopted = obs_trace.context_from_wire(decoded)
    assert adopted.trace_id == ctx.trace_id
    assert adopted.chrome_pid == ctx.chrome_pid
    assert adopted.root_parent == 1
    # adopted span ids start above the disjoint base; the first root span
    # parents under the door's per-job root
    span_id, parent = adopted._open_span()
    assert span_id == 2_000_001
    assert parent == 1


@pytest.mark.parametrize("kw", [
    {}, {"parent_span_id": 7, "span_base": 3_000_000, "flow_id": 16},
    {"parent_span_id": None, "span_base": 0, "flow_id": None},
])
def test_trace_context_wire_matches_jax(kw):
    args = ("fleet/job-5", 1_000_005)
    obj = obs_trace.context_to_wire(
        obs_trace.TraceContext(*args, label="job-5"), **kw)
    jobj = jtrace.context_to_wire(
        jtrace.TraceContext(*args, label="job-5"), **kw)
    assert json.dumps(obj) == json.dumps(jobj)
    mine = obs_trace.context_from_wire(jobj)
    theirs = jtrace.context_from_wire(obj)
    assert (mine.trace_id, mine.chrome_pid, mine.label, mine.root_parent) \
        == (theirs.trace_id, theirs.chrome_pid, theirs.label,
            theirs.root_parent)
    assert mine._open_span() == theirs._open_span()


def test_decode_trace_optional_and_malformed():
    assert wire.decode_trace(None) is None
    minimal = wire.decode_trace({"trace_id": "t", "chrome_pid": 5})
    assert minimal["span_base"] == 0
    assert minimal["parent_span_id"] is None
    assert minimal["flow_id"] is None
    for bad in (
        [],                                    # not a dict
        {"chrome_pid": 5},                     # no trace_id
        {"trace_id": "t"},                     # no chrome_pid
        {"trace_id": "t", "chrome_pid": "x"},  # a pid that is no int
        {"trace_id": "t", "chrome_pid": -1},   # a negative pid
        {"trace_id": "t", "chrome_pid": 5, "span_base": -2},
        {"trace_id": "t", "chrome_pid": 5, "parent_span_id": "n"},
    ):
        with pytest.raises(wire.WireError):
            wire.decode_trace(bad)


def test_submit_with_trace_fuzz_never_untyped():
    # mutated SUBMIT frames with the trace fields decode cleanly or raise
    # a typed WireError, and decode_trace of what decodes stays typed
    ctx = obs_trace.TraceContext("fuzz/job-1", 1_000_001)
    base = wire.encode_frame(wire.FrameType.SUBMIT, {
        "job": 1,
        "request": {"kind": "single", "reads": ["QUNHVA=="]},
        "trace": obs_trace.context_to_wire(
            ctx, parent_span_id=1, span_base=1_000_000, flow_id=16
        ),
    }, max_payload=65536)
    rng = random.Random(20260806)
    for _ in range(300):
        blob = bytearray(base)
        for _ in range(rng.randint(1, 4)):
            blob[rng.randrange(len(blob))] = rng.randrange(256)
        try:
            frames = wire.FrameDecoder(max_payload=65536).feed(bytes(blob))
        except wire.WireError:
            continue
        for _ftype, obj in frames:
            if not isinstance(obj, dict):
                continue
            try:
                wire.decode_trace(obj.get("trace"))
            except wire.WireError:
                pass


# ---------------------------------------------------------------------
# federated metrics
# ---------------------------------------------------------------------

@pytest.fixture
def metrics_on():
    obs_metrics.enable_metrics(True)
    obs_metrics.registry().reset()
    try:
        yield obs_metrics.registry()
    finally:
        obs_metrics.registry().reset()
        obs_metrics.reset_metrics_enabled()


def _snap():
    return {
        "waffle_searches_total": {
            "type": "counter",
            "series": {'{backend="python"}': 4.0, "{}": 2.0},
        },
        "waffle_serve_active_jobs": {
            "type": "gauge", "series": {"{}": 3.0},
        },
        "waffle_dispatch_latency_seconds": {
            "type": "histogram",
            "series": {'{op="run"}': {
                "buckets": {"0.01": 2, "0.1": 5}, "overflow": 1,
                "sum": 0.4, "count": 8,
            }},
        },
    }


def test_merge_snapshot_relabels_series(metrics_on):
    reg = metrics_on
    snap = _snap()
    assert reg.merge_snapshot(snap, worker="s:w0") == 4
    text = reg.render_prometheus()
    assert 'waffle_searches_total{backend="python",worker="s:w0"} 4.0' \
        in text
    assert 'waffle_serve_active_jobs{worker="s:w0"} 3.0' in text
    assert 'waffle_dispatch_latency_seconds_count{op="run",worker="s:w0"}' \
        " 8" in text
    # a newer snapshot sets the value (no double counting)
    snap["waffle_searches_total"]["series"]['{backend="python"}'] = 6.0
    reg.merge_snapshot(snap, worker="s:w0")
    assert 'backend="python",worker="s:w0"} 6.0' \
        in reg.render_prometheus()


def test_merge_snapshot_skips_malformed_series(metrics_on):
    reg = metrics_on
    reg.counter("waffle_fleet_clash_total").inc()
    merged = reg.merge_snapshot({
        "not_a_family": "bogus",
        "waffle_fleet_clash_total": {            # a type collision
            "type": "gauge", "series": {"{}": 1.0},
        },
        "waffle_bad_value": {
            "type": "counter", "series": {"{}": "NaNsense?"},
        },
        "waffle_good": {"type": "counter", "series": {"{}": 2.0}},
    }, worker="w")
    assert merged == 1
    assert 'waffle_good{worker="w"} 2.0' in reg.render_prometheus()


def test_merge_snapshot_matches_jax():
    mine, theirs = obs_metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for reg in (mine, theirs):
        reg.counter("waffle_fleet_clash_total").inc()
        assert reg.merge_snapshot(_snap(), worker="s:w0") == 4
        assert reg.merge_snapshot({
            "waffle_fleet_clash_total": {
                "type": "gauge", "series": {"{}": 1.0}},
            "waffle_good": {"type": "counter",
                            "series": {'{op="x"}': 2.0}},
        }, worker="s:w1", zone="a") == 1
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.snapshot() == theirs.snapshot()


# ---------------------------------------------------------------------
# the door with scripted workers
# ---------------------------------------------------------------------

class _ObsWorker:
    """A scripted worker for the fleet paths: HELLO, answers SUBMIT,
    keeps every SUBMIT payload, and sends the STATS / INCIDENT frames a
    test scripts through :meth:`send`."""

    def __init__(self, socket_path, name, spec):
        self.name = name
        self.spec = json.loads(spec)
        self.submits = []
        self.pid = os.getpid()
        self._sock = None
        self._connected = threading.Event()
        self._exited = threading.Event()
        self._thread = threading.Thread(
            target=self._run, args=(socket_path,), daemon=True
        )
        self._thread.start()

    def poll(self):
        return None if not self._exited.is_set() else 0

    def wait(self, timeout=None):
        self._exited.wait(timeout)
        return 0

    def terminate(self):
        self._exited.set()

    kill = terminate

    def send(self, ftype, obj):
        assert self._connected.wait(5)
        self._sock.sendall(wire.encode_frame(ftype, obj))

    def _run(self, socket_path):
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.connect(socket_path)
        self._sock = sock
        decoder = wire.FrameDecoder()
        sock.sendall(wire.encode_frame(wire.FrameType.HELLO, {
            "worker": self.name, "pid": self.pid, "slots": 2,
        }))
        self._connected.set()
        try:
            while True:
                data = sock.recv(65536)
                if not data:
                    return
                for ftype, obj in decoder.feed(data):
                    if ftype is wire.FrameType.PING:
                        sock.sendall(wire.encode_frame(
                            wire.FrameType.PONG, {"outstanding": 0},
                        ))
                    elif ftype is wire.FrameType.SUBMIT:
                        self.submits.append(obj)
                        result = [Consensus(
                            b"FAKE", ConsensusCost.L1_DISTANCE, [0, 0]
                        )]
                        sock.sendall(wire.encode_frame(
                            wire.FrameType.STARTED, {"job": obj["job"]}
                        ))
                        sock.sendall(wire.encode_frame(
                            wire.FrameType.RESULT, {
                                "job": obj["job"], "kind": "single",
                                "result": wire.encode_result(
                                    "single", result
                                ),
                            }
                        ))
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


class _ObsFleet:
    def __init__(self, real=False):
        self.real = real
        self.workers = {}

    def __call__(self, socket_path, name, spec):
        worker = (ThreadWorker if self.real else _ObsWorker)(
            socket_path, name, spec)
        self.workers[name] = worker
        return worker


def _cfg():
    return (CdwfaConfigBuilder().backend("torch").device("cpu")
            .min_count(2).build())


def _request():
    return JobRequest(kind="single", reads=(b"ACGT", b"ACGT"),
                      config=_cfg())


def _door(fleet, **kw):
    kw.setdefault("workers", 2)
    kw.setdefault("name", "fleet")
    kw.setdefault("spawn_timeout_s", 10.0)
    return ProcFrontDoor(ProcConfig(launcher=fleet, **kw))


def test_stats_frame_merges_as_worker_labeled_series(metrics_on):
    fleet = _ObsFleet()
    with _door(fleet) as door:
        door.submit(_request()).result(timeout=10)
        for name, worker in fleet.workers.items():
            worker.send(wire.FrameType.STATS, {
                "worker": name,
                "unix_time": time.time(),
                "metrics": {
                    "waffle_searches_total": {
                        "type": "counter", "series": {"{}": 5.0},
                    },
                },
                "slo": {"dispatch": {"count": 5, "p95_s": 0.025}},
                "incidents": 0,
            })
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            if all(w["stats_frames"] == 1 for w in door.worker_stats()):
                break
            time.sleep(0.01)
        rows = {w["worker"]: w for w in door.worker_stats()}
        stats = door.stats()
    assert all(w["stats_frames"] == 1 for w in rows.values()), rows
    assert all(w["stats_at"] is not None for w in rows.values())
    assert all(w["dispatch_p95_s"] == 0.025 for w in rows.values())
    assert stats["fleet"]["stats_frames"] == 2
    # one exposition, one series a worker
    text = metrics_on.render_prometheus()
    for name in rows:
        assert f'waffle_searches_total{{worker="{name}"}} 5.0' in text
    # the spec told the workers to arm their metrics
    assert all(w.spec["metrics"] for w in fleet.workers.values())


def _incident():
    return {
        "schema": "waffle-flight-incident/1",
        "seq": 7,
        "reason": "backend_demoted",
        "trace_id": "fleet/job-1",
        "unix_time": 1.5e9,
        "detail": {"why": "injected"},
        "path": "/worker/side/incident-000007.json",
    }


def test_forwarded_incident_dumped_once_with_attribution(
        tmp_path, metrics_on):
    obs_flight.configure(dedupe_s=60)
    obs_flight.reset()
    previous = obs_flight.incident_dir()
    fleet = _ObsFleet()
    try:
        with _door(fleet, workers=1,
                   serve=ServeConfig(flight_dir=str(tmp_path))) as door:
            worker = fleet.workers["fleet:w0"]
            for _ in range(2):  # the same (reason, trace_id): deduped
                worker.send(wire.FrameType.INCIDENT, {
                    "worker": worker.name, "incident": _incident(),
                })
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline:
                if door.worker_stats()[0]["incidents"] == 2:
                    break
                time.sleep(0.01)
            stats = door.stats()
        assert stats["fleet"]["incidents_forwarded"] == 2
        dumps = sorted(tmp_path.glob("incident-*.json"))
        assert len(dumps) == 1, [d.name for d in dumps]
        dumped = json.loads(dumps[0].read_text())
        assert dumped["reason"] == "backend_demoted"
        assert dumped["worker"] == "fleet:w0"
        assert dumped["origin"] == "remote"
        assert dumped["trace_id"] == "fleet/job-1"
        # the worker-side path is kept, not overwritten by the door's
        assert dumped["worker_path"] == _incident()["path"]
        kept = obs_flight.incidents()
        assert [i["reason"] for i in kept] == ["backend_demoted"]
        assert kept[0]["path"] == str(dumps[0])
    finally:
        obs_flight.set_incident_dir(previous)
        obs_flight.configure(dedupe_s=obs_flight.DEFAULT_DEDUPE_S)
        obs_flight.reset()


def test_ingest_remote_matches_jax():
    obs_flight.reset()
    jflight.reset()
    try:
        mine = [obs_flight.ingest_remote(_incident(), worker="w0"),
                obs_flight.ingest_remote(_incident(), worker="w1"),
                obs_flight.ingest_remote("nope"),
                obs_flight.ingest_remote(
                    dict(_incident(), reason=None, trace_id=9))]
        theirs = [jflight.ingest_remote(_incident(), worker="w0"),
                  jflight.ingest_remote(_incident(), worker="w1"),
                  jflight.ingest_remote("nope"),
                  jflight.ingest_remote(
                      dict(_incident(), reason=None, trace_id=9))]
        assert [m is None for m in mine] == [False, True, True, False]
        assert [t is None for t in theirs] == [m is None for m in mine]
        for m, t in zip(mine, theirs):
            if m is None:
                continue
            assert m.pop("ingested_unix_time") > 0
            t.pop("ingested_unix_time")
            assert m == t
        assert mine[0]["origin"] == "remote"
        assert mine[3]["reason"] == "unknown"
    finally:
        obs_flight.reset()
        jflight.reset()


def test_unknown_incident_payload_is_ignored():
    obs_flight.reset()
    fleet = _ObsFleet()
    try:
        with _door(fleet, workers=1) as door:
            worker = fleet.workers["fleet:w0"]
            worker.send(wire.FrameType.INCIDENT, {"incident": "nope"})
            worker.send(wire.FrameType.STATS, ["not", "a", "dict"])
            door.submit(_request()).result(timeout=10)
            stats = door.stats()
        assert stats["fleet"]["incidents_forwarded"] == 0
        assert stats["fleet"]["stats_frames"] == 0
        assert obs_flight.incidents() == []
    finally:
        obs_flight.reset()


# ---------------------------------------------------------------------
# nothing sent while the plane is off
# ---------------------------------------------------------------------

def test_submit_carries_no_trace_when_tracing_disabled():
    assert not obs_trace.tracing_enabled()
    assert not obs_metrics.metrics_enabled()
    fleet = _ObsFleet()
    with _door(fleet) as door:
        for h in [door.submit(_request()) for _ in range(4)]:
            h.result(timeout=10)
        stats = door.stats()
    submits = [obj for w in fleet.workers.values() for obj in w.submits]
    assert len(submits) == 4
    # the key is absent, not present and empty
    assert all("trace" not in obj for obj in submits)
    assert all(not w.spec["trace"] and not w.spec["metrics"]
               for w in fleet.workers.values())
    assert stats["fleet"] == {
        "stats_frames": 0, "incidents_forwarded": 0, "span_events": 0,
    }


def test_real_worker_sends_no_stats_frames_when_disabled():
    # the real worker with the plane off: even at a short STATS period
    # no STATS frame arrives and no span buffer rides the RESULT frames
    assert not obs_trace.tracing_enabled()
    assert not obs_metrics.metrics_enabled()
    fleet = _ObsFleet(real=True)
    req = JobRequest(kind="single", reads=(b"ACGTACGTAC",) * 3,
                     config=_cfg())
    with _door(fleet, workers=1, name="dark",
               stats_interval_s=0.1) as door:
        door.submit(req).result(timeout=60)
        time.sleep(0.5)  # several would-be STATS periods
        stats = door.stats()
    assert stats["fleet"] == {
        "stats_frames": 0, "incidents_forwarded": 0, "span_events": 0,
    }


# ---------------------------------------------------------------------
# a real worker process: one connected trace across the processes
# ---------------------------------------------------------------------

def test_subprocess_job_yields_one_connected_cross_process_tree(
        monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    tracer = obs_trace.get_tracer()
    tracer.enable(True)
    tracer.clear()
    obs_metrics.enable_metrics(True)
    obs_slo.reset()
    try:
        req = JobRequest(kind="single", reads=(b"ACGTACGTAC",) * 3,
                         config=_cfg())
        with ProcFrontDoor(ProcConfig(workers=1, name="e2e")) as door:
            handle = door.submit(req)
            handle.result(timeout=120)
            stats = door.stats()
        assert stats["fleet"]["span_events"] > 0

        events = tracer.chrome_events()
        pid = handle.trace.chrome_pid
        trace_id = handle.trace.trace_id
        spans = [e for e in events
                 if e.get("ph") == "X"
                 and e.get("args", {}).get("trace_id") == trace_id]
        names = {e["name"] for e in spans}
        # the door's and the worker's phases on one timeline
        assert {"door:job", "door:queued", "serve:job", "search"} <= \
            names, names
        # every span under the job's own Chrome pid
        assert {e["pid"] for e in spans} == {pid}
        # the worker's spans name it; the door's do not
        assert {bool(e["args"].get("worker")) for e in spans} == \
            {True, False}
        # parent links are closed and single-rooted at door:job
        by_id = {e["args"]["span_id"]: e for e in spans}
        roots = [e for e in spans if e["args"]["parent_id"] is None]
        assert [e["name"] for e in roots] == ["door:job"]
        for e in spans:
            parent = e["args"]["parent_id"]
            assert parent is None or parent in by_id, e
        # the worker's serve:job hangs directly under the door's root
        serve_job = next(e for e in spans if e["name"] == "serve:job")
        assert serve_job["args"]["parent_id"] == \
            roots[0]["args"]["span_id"]
        # flow arrows across the socket, both ways: every finish has
        # its start
        flows = [e for e in events
                 if e.get("cat") == "flow" and e.get("pid") == pid]
        starts = {e["id"] for e in flows if e["ph"] == "s"}
        finishes = {e["id"] for e in flows if e["ph"] == "f"}
        assert starts and finishes
        assert finishes <= starts
        assert len(starts & finishes) >= 2  # the submit and result hops
    finally:
        tracer.reset_enabled()
        tracer.clear()
        obs_metrics.registry().reset()
        obs_metrics.reset_metrics_enabled()
        obs_slo.reset()
