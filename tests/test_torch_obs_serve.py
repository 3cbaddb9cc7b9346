"""The serving path's obs modules and lock checker of the port against
the JAX package's: ``analysis/lockcheck.py`` (a seeded inversion raises
and leaves a flight incident; the same acquisition sequences record the
same order edges as JAX's), ``obs/slo.py`` (the same latency sequences
give the same snapshots and slow-search verdicts), ``obs/flight.py`` (the
same trigger sequences fire and dedupe alike; incidents stay in memory
unless a directory is set) and ``obs/phases.py`` (the four phases of a
dispatch sum to its wall on the CPU for the solo, dual and ragged
families; profiling off costs nothing).
"""

import json
import threading

import numpy as np
import pytest
import torch

from waffle_con_tpu.analysis import lockcheck as jlockcheck
from waffle_con_tpu.obs import flight as jflight
from waffle_con_tpu.obs import slo as jslo
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.analysis.lockcheck import LockOrderError
from waffle_con_tpu_torch.obs import flight, phases, slo
from waffle_con_tpu_torch.obs.instrument import TimedScorer, maybe_instrument
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.serve import ConsensusService, JobRequest, ServeConfig
from waffle_con_tpu_torch.serve.service import _build_engine
from waffle_con_tpu_torch.utils.example_gen import generate_test

BUDGET = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def checked():
    """The checker on in both packages, their graphs cleared."""
    for mod in (lockcheck, jlockcheck):
        mod.enable_lockcheck(True)
        mod.reset()
    yield
    for mod in (lockcheck, jlockcheck):
        mod.reset()
        mod.reset_enabled()


@pytest.fixture
def obs_clean():
    for mod in (flight, slo, jflight, jslo):
        mod.reset()
    yield
    for mod in (flight, slo, jflight, jslo):
        mod.reset()
    flight.set_incident_dir(None)


# ---------------------------------------------------------------- lockcheck


def _acquire_sequence(mod):
    """Nested acquisitions of three sites and a sibling pair, then an
    inversion attempt: the recorded edges and whether it raised."""
    a, b, c = (mod.make_lock(f"t.seq_{n}") for n in "ABC")
    s1, s2 = mod.make_lock("t.seq_sib"), mod.make_lock("t.seq_sib")
    r = mod.make_rlock("t.seq_R")
    with a:
        with b:
            pass
    with b:
        with c:
            with r:
                with r:
                    pass
    with s1:
        with s2:
            pass
    with a:
        assert c.acquire(blocking=False)
        c.release()
    raised = False
    with c:
        try:
            a.acquire()
        except mod.LockOrderError:
            raised = True
    return sorted(mod.edges()), raised


def test_lock_edges_and_inversion_equal_jax(checked, obs_clean):
    got = _acquire_sequence(lockcheck)
    want = _acquire_sequence(jlockcheck)
    assert got == want
    assert got[1] is True  # C -> A closes the cycle A -> B -> C
    assert [i["reason"] for i in flight.incidents()] == [
        "lock_order_inversion"]


def test_inversion_detected_across_threads(checked):
    a, b = lockcheck.make_lock("t.x_A"), lockcheck.make_lock("t.x_B")

    def first():
        with a:
            with b:
                pass

    t = lockcheck.make_thread(target=first)
    t.start()
    t.join()
    caught = []

    def second():
        try:
            with b:
                a.acquire()
        except LockOrderError as exc:
            caught.append(exc)

    t2 = threading.Thread(target=second)
    t2.start()
    t2.join()
    assert len(caught) == 1 and "t.x_A" in str(caught[0])


def test_disabled_factories_return_plain_primitives():
    lockcheck.enable_lockcheck(False)
    lock = lockcheck.make_lock("t.plain")
    assert isinstance(lock, type(threading.Lock()))
    assert not isinstance(lockcheck.make_rlock("t.r"), lockcheck._CheckedLock)


def test_served_job_runs_clean_under_lockcheck(checked):
    """The serving stack's locks, made after the checker is on, complete
    a job with no inversion."""
    ragged.reset_arena()
    req = JobRequest(kind="single", reads=(b"ACGTACGTAC",) * 4,
                     config=CdwfaConfigBuilder().backend("torch")
                     .device("cpu").build())
    svc = ConsensusService(ServeConfig(workers=2))
    try:
        got = svc.submit(req).result(timeout=60.0)
    finally:
        svc.close()
        ragged.reset_arena()
    want = _build_engine(req).consensus()
    assert [(c.sequence, c.scores) for c in got] == [
        (c.sequence, c.scores) for c in want]


# ---------------------------------------------------------------- slo


def _latency_sequence(mod):
    rng = np.random.default_rng(5)
    tracker = mod.SloTracker(window_s=300.0)
    verdicts = []
    for v in rng.exponential(0.01, size=40):
        tracker.observe_dispatch(float(v))
    for v in list(rng.uniform(0.01, 0.02, size=25)) + [1.0, 0.015, 2.0]:
        verdicts.append(tracker.observe_search(float(v)))
    tracker.observe_job(0.5)
    snap = tracker.snapshot()
    for window in ("dispatch", "job"):
        snap[window] = {k: v for k, v in snap[window].items()}
    return verdicts, snap


def test_slo_snapshots_and_slow_searches_equal_jax(obs_clean):
    got, want = _latency_sequence(slo), _latency_sequence(jslo)
    assert got == want
    assert got[0][-3:] == [True, False, True]
    assert got[1]["slow_searches"] == 2


def test_rolling_window_percentiles_and_expiry():
    w = slo.RollingWindow(max_age_s=300.0, max_count=1000)
    jw = jslo.RollingWindow(max_age_s=300.0, max_count=1000)
    for v in range(1, 101):
        w.observe(v / 1000.0, now=float(v))
        jw.observe(v / 1000.0, now=float(v))
    assert w.percentiles(now=100.0) == jw.percentiles(now=100.0)
    assert w.percentiles(now=100.0)["p95"] == pytest.approx(0.095)
    assert w.ewma == jw.ewma
    old = slo.RollingWindow(max_age_s=10.0, max_count=1000)
    old.observe(5.0, now=100.0)
    old.observe(0.001, now=109.0)
    assert old.percentiles(now=111.0)["p99"] == pytest.approx(0.001)
    assert len(old) == 1


def test_slo_settings_in_code(obs_clean):
    try:
        slo.configure(k=1.5)
        assert slo.slow_search_k() == 1.5
        with pytest.raises(ValueError):
            slo.configure(window_s=0)
    finally:
        slo.configure(window_s=slo.DEFAULT_WINDOW_S, k=slo.DEFAULT_K)


# ---------------------------------------------------------------- flight


def _trigger_sequence(mod, monkeypatch):
    """A trigger storm on one recorder with a 10 s dedupe window and a
    fake clock: which triggers fire, and the incidents' reasons."""
    t = [1000.0]
    monkeypatch.setattr(mod.time, "time", lambda: t[0])
    rec = mod.FlightRecorder(ring_size=16, dedupe_s=10.0)
    for i in range(40):
        rec.record("probe", trace_id=f"t{i % 2}", i=i)
    fired = []
    for step, (reason, tid) in enumerate([
            ("deadline_exceeded", "t0"), ("deadline_exceeded", "t0"),
            ("deadline_exceeded", "t1"), ("slow_search", "t0"),
            ("service_overloaded", None), ("service_overloaded", None)]):
        t[0] += 1.0
        fired.append(rec.trigger(reason, trace_id=tid, step=step)
                     is not None)
    t[0] += 20.0  # past the window: the first incident re-fires
    fired.append(rec.trigger("deadline_exceeded", trace_id="t0") is not None)
    incidents = rec.incidents()
    return (fired, [(i["reason"], i["trace_id"], len(i["trace"]),
                     i["detail"]) for i in incidents],
            [r["i"] for r in rec.records()])


def test_flight_triggers_equal_jax(monkeypatch, obs_clean):
    monkeypatch.delenv("WAFFLE_FLIGHT_DIR", raising=False)
    got = _trigger_sequence(flight, monkeypatch)
    want = _trigger_sequence(jflight, monkeypatch)
    assert got == want
    assert got[0] == [True, False, True, True, True, False, True]
    assert got[2] == list(range(24, 40))  # the ring is bounded


def test_flight_incidents_stay_in_memory_unless_a_dir_is_set(
        obs_clean, tmp_path):
    flight.record("step", trace_id="job-1", n=1)
    first = flight.trigger("deadline_exceeded", trace_id="job-1")
    assert first["trace"][0]["kind"] == "step" and "path" not in first
    assert not list(tmp_path.iterdir())
    flight.set_incident_dir(str(tmp_path))
    incident = flight.trigger("watchdog_budget_exceeded", trace_id="job-9",
                              total=10, budget=5)
    files = list(tmp_path.glob("incident-*-watchdog_budget_exceeded.json"))
    assert len(files) == 1 and incident["path"] == str(files[0])
    on_disk = json.loads(files[0].read_text())
    assert on_disk["schema"] == "waffle-flight-incident/1"
    assert on_disk["detail"] == {"total": 10, "budget": 5}
    assert "slo" in on_disk and "events" in on_disk


def test_service_flight_dir_field(obs_clean, tmp_path):
    ConsensusService(ServeConfig(flight_dir=str(tmp_path)),
                     autostart=False).close()
    assert flight.incident_dir() == str(tmp_path)


# ---------------------------------------------------------------- phases


@pytest.fixture
def profiling():
    phases.enable_profiling(True)
    phases.reset()
    yield
    phases.reset()
    phases.reset_profiling_enabled()


def _timed(reads, band=None):
    b = CdwfaConfigBuilder().min_count(2).backend("torch").device("cpu")
    if band is not None:
        b = b.initial_band(band)
    return maybe_instrument(TorchScorer(reads, b.build()), "torch")


def _assert_conserved(rec):
    ph = rec.phases()
    assert rec.wall_s > 0.0 and rec.device_s > 0.0
    assert abs(sum(ph.values()) - rec.wall_s) <= 0.05 * rec.wall_s + 1e-6, (
        rec.op, rec.wall_s, ph)


def test_solo_and_dual_dispatch_phases_conserve(profiling):
    _, reads = generate_test(4, 200, 6, 0.01, seed=0)
    sc = _timed(reads)
    assert isinstance(sc, TimedScorer)
    h = sc.root(np.ones(len(reads), dtype=bool))
    assert sc.run_extend(h, b"", BUDGET, BUDGET, 0, 2, False, 64)[0] > 0
    _, r1 = generate_test(4, 150, 6, 0.01, seed=1)
    _, r2 = generate_test(4, 150, 6, 0.01, seed=2)
    dual = _timed(list(r1) + list(r2))
    ha, hb = (dual.root(np.ones(12, dtype=bool)) for _ in range(2))
    out = dual.run_extend_dual(
        ha, hb, b"", b"", me_budget=BUDGET, other_cost=BUDGET, other_len=0,
        min_count=2, ed_delta=2, imb_min=4, l2=False, weighted=False,
        max_steps=32)
    assert out[0] > 0
    recs = {r.op: r for r in phases.recent_records()}
    assert recs["run"].kernel == "solo" and recs["run"].geom.startswith("B")
    assert recs["run_dual"].kernel == "dual"
    for op in ("run", "run_dual"):
        _assert_conserved(recs[op])
    assert phases.totals()["device_compute"] > 0.0


@pytest.mark.serve
def test_ragged_group_phases_conserve(profiling):
    ragged.reset_arena()
    try:
        jobs = [generate_test(4, 100, 5, 0.02, seed=s)[1] for s in (1, 2)]
        with ragged.serve_scope():
            scorers = [TorchScorer(r, CdwfaConfigBuilder().backend("torch")
                                   .device("cpu").initial_band(b).build())
                       for r, b in zip(jobs, (8, 24))]
        args = [(s.root(np.ones(len(j), bool)), b"", BUDGET, BUDGET, 0, 2,
                 False, 8) for s, j in zip(scorers, jobs)]
        specs = [ragged.probe((s.ragged_run_probe, a, {}))
                 for s, a in zip(scorers, args)]
        assert len(ragged.run_group(specs)) == 2
        rec = [r for r in phases.recent_records()
               if r.op == "ragged_group"][-1]
        assert rec.kernel == "ragged" and rec.geom == "G2W66"
        _assert_conserved(rec)
    finally:
        ragged.reset_arena()


def test_disabled_profiling_costs_nothing():
    phases.reset_profiling_enabled()
    phases.reset()
    assert phases.begin("run", "torch") is None
    assert phases.device_scope(None, torch.device("cpu")) is phases.NULL_SCOPE
    assert phases.transfer_scope(None) is phases.NULL_SCOPE
    assert phases.totals() == {p: 0.0 for p in phases.PHASES}
    _, reads = generate_test(4, 60, 4, 0.0, seed=0)
    sc = TorchScorer(reads, CdwfaConfigBuilder().backend("torch")
                     .device("cpu").build())
    assert maybe_instrument(sc, "torch") is sc


def test_outermost_record_wins_and_late_transfer(profiling):
    outer = phases.begin("run", "torch")
    assert phases.begin("stats", "torch") is None
    phases.end(outer)
    assert list(phases.snapshot()) == ["other/run/k1"]
    rec = phases.begin("run", "torch")
    rec.annotate(kernel="solo", geom="B4R8W16")
    phases.end(rec)
    before = phases.totals()["transfer"]
    rec.add_transfer(0.25, 0.0)
    assert rec.late and phases.totals()["transfer"] - before == (
        pytest.approx(0.25))
