"""The port's in-process serving path (``waffle_con_tpu_torch/serve/``)
against the JAX package's.

* Served results: ``tests/test_serve.py``'s eight mixed jobs (the golden
  fixtures and generated draws) served concurrently on ``"torch"`` (CPU)
  equal JAX's serial ``"python"`` results and the port's own serial runs;
  mixed-geometry single jobs gang across jobs through the serving pool
  and still equal both.
* Scheduling: admission order under aging on the same synthetic trace and
  fake clock as ``tests/test_serve.py``, equal to JAX's
  ``AdmissionQueue``; priorities, full-queue rejection, cancel (queued
  and mid-run), deadlines (in the queue and mid-run), a supervised job
  demoting inside the service with the port's ``faults``, metrics, the
  stats file, and a service built with a placement policy.
* The pool-release order: a job's pages are back before its handle is
  finished.
* The superset resume: a job submitted with a snapshot of a subset of
  its reads resumes with the missing reads as extras and equals the
  serial superset search and JAX's; ``stats()["checkpoints"]`` counts
  ``resumed`` and ``rejected`` as JAX's does.
"""

import json
import time

import numpy as np
import pytest
import torch

from waffle_con_tpu import CdwfaConfigBuilder as JBuilder
from waffle_con_tpu.serve import JobRequest as JJobRequest
from waffle_con_tpu.serve import service as jservice
from waffle_con_tpu.serve.job import JobHandle as JJobHandle
from waffle_con_tpu.serve.scheduler import AdmissionQueue as JAdmissionQueue
from waffle_con_tpu.utils import fixtures as jfixtures
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.runtime import events, faults, supervisor
from waffle_con_tpu_torch.serve import (
    ConsensusService,
    DeadlineExceeded,
    JobCancelled,
    JobRequest,
    JobStatus,
    PlacementPolicy,
    ServeConfig,
    ServiceClosed,
    ServiceOverloaded,
)
from waffle_con_tpu_torch.serve.job import JobHandle
from waffle_con_tpu_torch.serve.scheduler import AdmissionQueue
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils import fixtures
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

pytestmark = pytest.mark.serve

DUAL_READS = (b"ACGTACGT", b"ACGTACGT", b"ACTTACGT", b"ACTTACGT")
#: every wait of a test has its own timeout, so a hang fails the test
WAIT_S = 120


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def fresh_arena():
    ragged.reset_arena()
    yield
    ragged.reset_arena()


def _cfg(backend="torch", **kw):
    b = CdwfaConfigBuilder().backend(backend)
    if backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _jcfg(**kw):
    b = JBuilder().backend("python")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _key(kind, res):
    """A result as plain data (the port's and JAX's result types differ)."""
    one = lambda c: None if c is None else (c.sequence, list(c.scores))  # noqa: E731
    if kind == "priority":
        return ([[one(c) for c in chain] for chain in res.consensuses],
                list(res.sequence_indices))
    if kind == "dual":
        return [(one(d.consensus1), one(d.consensus2), list(d.is_consensus1),
                 list(d.scores1), list(d.scores2)) for d in res]
    return [one(c) for c in res]


def _mixed_requests(pkg):
    """``tests/test_serve.py``'s eight mixed jobs: every golden fixture
    scenario plus generated single and dual draws, as the JAX package's
    ``"python"`` requests (``pkg="jax"``) or the port's ``"torch"`` ones."""
    if pkg == "jax":
        cfg, req, fx = _jcfg, JJobRequest, jfixtures
    else:
        cfg, req, fx = _cfg, JobRequest, fixtures
    fcfg = cfg(wildcard=ord("*"))
    out = []
    sequences, _ = fx.load_dual_fixture("dual_001", True,
                                        fcfg.consensus_cost)
    out.append(req(kind="dual", reads=tuple(sequences), config=fcfg))
    for name, include in (("multi_exact_001", True),
                          ("multi_err_001", False),
                          ("multi_samesplit_001", True),
                          ("priority_001", True)):
        chains, _ = fx.load_priority_fixture(name, include,
                                             fcfg.consensus_cost)
        out.append(req(kind="priority", reads=tuple(tuple(c) for c in chains),
                       config=fcfg, tag=name))
    scfg = cfg(min_count=2)
    for seed in (0, 1):
        _, reads = generate_test(4, 160, 6, 0.02, seed=seed)
        out.append(req(kind="single", reads=tuple(reads), config=scfg))
    out.append(req(kind="dual", reads=DUAL_READS, config=cfg(min_count=1)))
    return out


def _serve(requests, **kw):
    with ConsensusService(ServeConfig(**kw)) as svc:
        handles = svc.submit_all(requests)
        results = [h.result(timeout=WAIT_S) for h in handles]
        stats = svc.stats()
    return results, stats


def test_mixed_jobs_equal_jax_python_and_serial():
    jreqs, reqs = _mixed_requests("jax"), _mixed_requests("port")
    want = [_key(r.kind, jservice._build_engine(r).consensus())
            for r in jreqs]
    serial = [_key(r.kind, _build_engine(r).consensus()) for r in reqs]
    results, stats = _serve(reqs, workers=4, batch_window_s=0.02)
    got = [_key(r.kind, res) for r, res in zip(reqs, results)]
    assert serial == want
    assert got == want
    assert stats["jobs"]["done"] == len(reqs) and stats["jobs"]["failed"] == 0
    assert stats["ragged"]["pages_used"] == 0


def _mixed_geometry(pkg):
    """``tests/test_ragged.py``'s eight single jobs of distinct (reads,
    length) shapes: different buckets, so only the pool gangs them."""
    shapes = [(4, 90), (7, 140), (3, 60), (10, 200), (5, 120), (6, 180),
              (4, 250), (8, 100)]
    out = []
    for seed, (n, length) in enumerate(shapes):
        _, reads = generate_test(n, length, 6, 0.02, seed=seed)
        if pkg == "jax":
            out.append(JJobRequest(kind="single", reads=tuple(reads),
                                   config=_jcfg(min_count=max(2, n // 4))))
        else:
            out.append(JobRequest(kind="single", reads=tuple(reads),
                                  config=_cfg(min_count=max(2, n // 4))))
    return out


def test_mixed_geometry_jobs_gang_and_equal_serial():
    jreqs, reqs = _mixed_geometry("jax"), _mixed_geometry("port")
    want = [_key("single", jservice._build_engine(r).consensus())
            for r in jreqs]
    results, stats = _serve(reqs, workers=8, batch_window_s=0.05,
                            max_batch=8)
    assert [_key("single", r) for r in results] == want
    pool, disp = stats["ragged"], stats["dispatch"]
    assert pool["groups"] >= 1 and pool["members"] >= 2
    assert disp["ragged_groups"] == pool["groups"]
    assert pool["admits"] == pool["releases"]
    assert pool["pages_used"] == 0
    assert pool["group_failures"] == 0 == pool["plan_refused"]


def test_pool_pages_are_back_when_result_returns(monkeypatch):
    """A job is finished only once its pool pages are released: with every
    release slowed by 0.2 s, ``stats()`` read right after the last
    ``result()`` (before ``close()``) shows every admission released."""
    release = ragged.release_job

    def slow_release(job_id, arena=None):
        time.sleep(0.2)
        release(job_id, arena=arena)

    monkeypatch.setattr(ragged, "release_job", slow_release)
    reqs = _mixed_geometry("port")[:4]
    with ConsensusService(ServeConfig(workers=4, batch_window_s=0.05,
                                      max_batch=4)) as svc:
        handles = svc.submit_all(reqs)
        for h in handles:
            h.result(timeout=WAIT_S)
        pool = svc.stats()["ragged"]
    assert pool["admits"] >= 2
    assert pool["admits"] == pool["releases"]
    assert pool["pages_used"] == 0


def test_tiny_pool_still_equal_to_serial():
    reqs = _mixed_geometry("port")[:4]
    want = [_key("single", _build_engine(r).consensus()) for r in reqs]
    results, stats = _serve(reqs, workers=4, batch_window_s=0.02,
                            ragged_rows=16, ragged_page=8)
    assert [_key("single", r) for r in results] == want
    assert stats["ragged"]["pages_used"] == 0


def test_batch_occupancy_above_one_under_concurrent_load():
    _, reads = generate_test(4, 100, 4, 0.02, seed=3)
    req = JobRequest(kind="single", reads=tuple(reads),
                     config=_cfg(min_count=2))
    results, stats = _serve([req] * 4, workers=4, batch_window_s=0.05,
                            max_batch=4)
    want = _key("single", _build_engine(req).consensus())
    assert all(_key("single", r) == want for r in results)
    assert stats["dispatch"]["coalesced_batches"] > 0
    assert stats["dispatch"]["mean_batch_occupancy"] > 1.0


# ------------------------------------------------ admission / backpressure


def test_full_queue_rejects_typed_not_blocking():
    req = JobRequest(kind="dual", reads=DUAL_READS, config=_cfg(min_count=1))
    svc = ConsensusService(ServeConfig(workers=2, queue_limit=2),
                           autostart=False)
    h1, h2 = svc.submit(req), svc.submit(req)
    t0 = time.monotonic()
    with pytest.raises(ServiceOverloaded):
        svc.submit(req)
    assert time.monotonic() - t0 < 1.0, "rejection must not block"
    assert svc.stats()["jobs"]["rejected"] == 1
    svc.start()
    assert (_key("dual", h1.result(timeout=WAIT_S))
            == _key("dual", h2.result(timeout=WAIT_S)))
    svc.close()
    with pytest.raises(ServiceClosed):
        svc.submit(req)


def test_priority_classes_fifo_within_class():
    cfg = _cfg(min_count=1)
    svc = ConsensusService(ServeConfig(workers=1), autostart=False)
    low_a, low_b = (svc.submit(JobRequest("dual", DUAL_READS, config=cfg))
                    for _ in range(2))
    high = svc.submit(JobRequest("dual", DUAL_READS, config=cfg, priority=5))
    svc.start()
    for h in (low_a, low_b, high):
        h.result(timeout=WAIT_S)
    svc.close()
    assert high.started_at < low_a.started_at < low_b.started_at


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _trace_pops(queue_cls, handle_cls, req_cls, aging, seed=7, n=400):
    """``tests/test_serve.py``'s synthetic put/pop trace on a fake clock:
    the popped job ids in order and the aged pops."""
    rng = np.random.default_rng(seed)
    clk = _FakeClock()
    q = queue_cls(1000, aging_s=aging, clock=clk)
    popped, seq, queued = [], 0, 0
    for _ in range(n):
        clk.t += float(rng.exponential(0.05))
        if rng.random() < 0.6 or not queued:
            prio = int(rng.integers(0, 3))
            q.put(handle_cls(seq, req_cls(kind="dual", reads=DUAL_READS,
                                          priority=prio)))
            seq += 1
            queued += 1
            continue
        popped.append(q.get(timeout=0).job_id)
        queued -= 1
    return popped, q.aged_pops


@pytest.mark.parametrize("aging", [0.5, 2.0, None])
def test_admission_order_equals_jax_on_a_synthetic_trace(aging):
    got = _trace_pops(AdmissionQueue, JobHandle, JobRequest, aging)
    want = _trace_pops(JAdmissionQueue, JJobHandle, JJobRequest, aging)
    assert got == want
    if aging == 0.5:
        assert got[1] > 0, "the trace never took the aging path"


def test_aged_low_priority_job_pops_through_a_high_flood():
    clk = _FakeClock()
    q = AdmissionQueue(100, aging_s=1.0, clock=clk)
    low = JobHandle(0, JobRequest("dual", DUAL_READS, priority=0))
    q.put(low)
    highs = [JobHandle(1 + i, JobRequest("dual", DUAL_READS, priority=2))
             for i in range(50)]
    for h in highs:
        q.put(h)
    clk.t = 2.0
    assert q.get(timeout=0) is low
    assert q.aged_pops == 1
    assert q.get(timeout=0) is highs[0]


# ------------------------------------------------ deadlines / cancellation


def _slow_request(**kw):
    """A ``"python"`` search of some seconds (12 reads x 1.5 kb at 4 %)."""
    _, reads = generate_test(4, 1500, 12, 0.04, seed=2)
    return JobRequest(kind="single", reads=tuple(reads),
                      config=_cfg("python", min_count=2), **kw)


def test_cancel_queued_job_finalizes_immediately():
    req = JobRequest(kind="dual", reads=DUAL_READS, config=_cfg(min_count=1))
    svc = ConsensusService(ServeConfig(workers=1), autostart=False)
    keep, doomed = svc.submit(req), svc.submit(req)
    assert doomed.cancel()
    assert doomed.status is JobStatus.CANCELLED
    with pytest.raises(JobCancelled):
        doomed.result(timeout=0)
    assert not doomed.cancel(), "a second cancel reports already-terminal"
    svc.start()
    assert keep.result(timeout=WAIT_S)
    svc.close()
    assert svc.stats()["jobs"]["cancelled"] == 1


def test_cancel_mid_run_aborts_at_a_call_boundary():
    with ConsensusService(ServeConfig(workers=1)) as svc:
        h = svc.submit(_slow_request())
        assert h.wait_running(WAIT_S)
        time.sleep(0.2)
        assert h.cancel()
        with pytest.raises(JobCancelled):
            h.result(timeout=WAIT_S)
        assert h.status is JobStatus.CANCELLED


def test_deadline_lapsed_in_queue_expires_at_pop():
    events.clear_events()
    svc = ConsensusService(ServeConfig(workers=1), autostart=False)
    h = svc.submit(JobRequest(kind="dual", reads=DUAL_READS,
                              config=_cfg(min_count=1), deadline_s=0.01))
    time.sleep(0.05)
    svc.start()
    with pytest.raises(DeadlineExceeded):
        h.result(timeout=WAIT_S)
    assert h.status is JobStatus.EXPIRED
    svc.close()
    assert svc.stats()["jobs"]["expired"] == 1
    assert events.get_events("deadline_exceeded")
    events.clear_events()


def test_deadline_mid_run_expires_at_a_call_boundary():
    with ConsensusService(ServeConfig(workers=1)) as svc:
        h = svc.submit(_slow_request(deadline_s=0.4))
        with pytest.raises(DeadlineExceeded):
            h.result(timeout=WAIT_S)
        assert h.status is JobStatus.EXPIRED


# ------------------------------------------------ fault tolerance composes


@pytest.mark.faultinject
def test_backend_demotion_inside_served_job():
    """A supervised ``"torch"`` job served concurrently still demotes
    torch -> python mid-search on injected faults, equal to the unfaulted
    run."""
    faults.clear()
    events.clear_events()
    plan = faults.install(faults.FaultPlan())
    try:
        reads = (b"ACGTACGTACGT", b"ACGTACGTACGT", b"ACCTACGTACGT")
        want = _key("single", _build_engine(JobRequest(
            "single", reads, config=_cfg(min_count=1))).consensus())
        plan.add("timeout", backend="torch", at=3, count=None)
        plan.add("timeout", backend="torch", at=4, count=None)
        sup = _cfg(min_count=1, backend_chain=("python",),
                   dispatch_retries=1, breaker_threshold=2,
                   retry_backoff_s=0.0)
        with ConsensusService(ServeConfig(workers=2)) as svc:
            h = svc.submit(JobRequest(kind="single", reads=reads, config=sup))
            got = h.result(timeout=WAIT_S)
        demotions = events.get_events("backend_demoted")
        assert [(d["from_backend"], d["to_backend"]) for d in demotions] == [
            ("torch", "python")]
        assert _key("single", got) == want
    finally:
        faults.clear()
        events.clear_events()
        supervisor.shutdown_executors(wait=True)


# ------------------------------------------------ metrics, stats, config


def test_serve_metrics_emitted():
    obs_metrics.enable_metrics(True)
    obs_metrics.registry().reset()
    try:
        _, reads = generate_test(4, 120, 6, 0.02, seed=4)
        req = JobRequest(kind="single", reads=tuple(reads),
                         config=_cfg(min_count=2))
        _serve([req] * 2, workers=4, batch_window_s=0.05, queue_limit=2)
        snap = obs_metrics.registry().snapshot()
    finally:
        obs_metrics.registry().reset()
        obs_metrics.reset_metrics_enabled()
    assert "waffle_serve_queue_depth" in snap
    jobs = snap["waffle_serve_jobs_total"]["series"]
    assert sum(v for k, v in jobs.items() if 'outcome="done"' in k) == 2
    assert "waffle_serve_job_latency_seconds" in snap
    occupancy = snap["waffle_serve_batch_occupancy"]["series"]
    assert sum(s["count"] for s in occupancy.values()) > 0


def test_stats_file_written(tmp_path):
    path = tmp_path / "stats.json"
    req = JobRequest(kind="dual", reads=DUAL_READS, config=_cfg(min_count=1))
    _serve([req], workers=1, stats_file=str(path))
    data = json.loads(path.read_text())
    assert data["service"] == "consensus"
    assert data["stats"]["jobs"]["done"] == 1
    assert "dispatch" in data["slo"]


def test_config_fields_replace_the_jax_knobs():
    cfg = ServeConfig(ragged=False, ragged_mixed_w=False, ragged_rows=4096,
                      ragged_page=8, ragged_e=256, ragged_l=10240,
                      ragged_c=12288, ragged_gang=8)
    ac = cfg.arena_config()
    assert (ac.rows, ac.page_rows, ac.band_e, ac.read_len, ac.cons_len,
            ac.gang, ac.enabled, ac.mixed_w) == (
        4096, 8, 256, 10240, 12288, 8, False, False)
    assert ac.W == 514
    for bad in (dict(ragged_rows=8), dict(ragged_gang=65),
                dict(ragged_e=4), dict(queue_limit=0)):
        with pytest.raises(ValueError):
            ServeConfig(**bad)
    svc = ConsensusService(ServeConfig(placement=PlacementPolicy()),
                           autostart=False)
    svc.close()
    assert svc.stats()["jobs"]["mesh_placed"] == 0


def _subset_snapshot(reads, cfg, at=5):
    """A bound-free snapshot of the serial search of ``reads``, taken at
    poll ``at`` (the search runs on to its end)."""
    snaps = []
    ctrl = ckpt_mod.CheckpointController(snapshot_at_pops={at},
                                         on_snapshot=snaps.append)
    with ckpt_mod.installed(ctrl):
        _build_engine(JobRequest("single", reads, config=cfg)).consensus()
    assert len(snaps) == 1
    state = snaps[0].body["state"]
    assert state["maximum_error"] is None and not state["results"]
    return snaps[0]


def test_superset_resume_through_submit_checkpoint():
    """``submit(superset, checkpoint=<snapshot of a subset>)`` searches
    the superset: the request's reads missing from the checkpoint join
    the resumed search.  The parent's service resumed the checkpoint's
    reads alone and returned the subset's consensus."""
    truth, reads = generate_test(4, 160, 8, 0.03, seed=21)
    reads = tuple(reads)
    extra = corrupt(truth, 0.05, np.random.default_rng(22))
    cfg = _cfg(min_count=2)
    snap = _subset_snapshot(reads, cfg)
    superset = JobRequest("single", reads + (extra,), config=cfg)
    want = _build_engine(superset).consensus()
    jreq = JJobRequest("single", reads + (extra,), config=_jcfg(min_count=2))
    assert _key("single", want) == _key(
        "single", jservice._build_engine(jreq).consensus())
    # the subset's own result differs: the extra read changes the answer
    subset = _build_engine(JobRequest("single", reads, config=cfg))
    assert _key("single", subset.consensus()) != _key("single", want)
    events.clear_events()
    with ConsensusService(ServeConfig(workers=2)) as svc:
        handle = svc.submit(superset, checkpoint=snap.to_wire())
        got = handle.result(timeout=WAIT_S)
        ckpts = svc.stats()["checkpoints"]
    assert got == want
    assert handle._resumed_from_checkpoint
    assert ckpts["resumed"] == 1 and ckpts["rejected"] == 0
    assert set(ckpts) == {"snapshots", "bytes", "resumed", "rejected"}
    assert [e["extra_reads"] for e in events.get_events("job_resumed")] == [1]


def test_rejected_checkpoints_counted_and_resumed_taken_back():
    """A body that fails when the engine consumes it (a node's priority
    edited, the CRC re-signed) restarts the job from scratch: ``rejected``
    counts it and ``resumed`` is taken back to 0.  A body that fails its
    CRC is rejected before any resume."""
    reads = tuple(generate_test(4, 160, 8, 0.03, seed=21)[1])
    cfg = _cfg(min_count=2)
    snap = _subset_snapshot(reads, cfg)
    body = json.loads(json.dumps(snap.body))
    body["state"]["entries"][0]["priority"][0] += 7
    edited = ckpt_mod.SearchCheckpoint("single", body).to_wire()
    torn = snap.to_wire()
    torn["crc"] ^= 1
    req = JobRequest("single", reads, config=cfg)
    want = _build_engine(req).consensus()
    events.clear_events()
    with ConsensusService(ServeConfig(workers=1)) as svc:
        first = svc.submit(req, checkpoint=edited)
        assert first.result(timeout=WAIT_S) == want
        after_deferred = svc.stats()["checkpoints"]
        # it resumed first, and was rejected inside consensus()
        assert len(events.get_events("job_resumed")) == 1
        assert len(events.get_events("checkpoint_rejected")) == 1
        second = svc.submit(req, checkpoint=torn)
        assert second.result(timeout=WAIT_S) == want
        after_torn = svc.stats()["checkpoints"]
    assert (after_deferred["resumed"], after_deferred["rejected"]) == (0, 1)
    assert (after_torn["resumed"], after_torn["rejected"]) == (0, 2)
