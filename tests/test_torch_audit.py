"""The port's search audit plane (``waffle_con_tpu_torch/obs/audit.py``)
against the JAX package's.

The port's ``"torch"`` backend on the CPU (its plain twins) and the JAX
package's ``"jax"`` backend record the same decision records on the same
draws (the scorer tap's ``dispatch`` records aside, which name each
package's own scorer method and backend), and ``diff_logs`` across the
two packages' logs finds no divergence.  The lockstep shadow against the
port's ``"python"`` oracle is clean on ``tests/test_audit.py``'s single
and dual draws, and a seeded ``flip_vote`` aborts it exactly once.  The
zero-overhead contract, the ring bound, the JSONL stream, the priority
engine's group markers, the differ's localisation and the metrics
counter are carried over from ``tests/test_audit.py``."""

import copy

import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from test_torch_checkpoint import _engine, _key
from waffle_con_tpu.obs import audit as jaudit
from waffle_con_tpu_torch.models import checkpoint as tck
from waffle_con_tpu_torch.obs import audit as obs_audit
from waffle_con_tpu_torch.obs import flight as obs_flight
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.ops.scorer import construct_backend
from waffle_con_tpu_torch.runtime import faults

#: ``tests/test_audit.py``'s draws: a clean 2-vs-1 fork then an
#: unambiguous tail (branch pops through the fork, device runs down the
#: tail), and a two-haplotype dual draw
SINGLE_READS = (
    b"ACGTTGCAACGTTGCA",
    b"ACGTTGCAACGTTGCA",
    b"ACCTTGCAACGTTGCA",
)
DUAL_READS = (
    b"ACGTTGCAACGTTGCA",
    b"ACGTTGCAACGTTGCA",
    b"ACGTAGCAACGTTGCA",
    b"ACGTAGCAACGTTGCA",
)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def fault_plan():
    plan = faults.install(faults.FaultPlan())
    try:
        yield plan
    finally:
        faults.clear()


def _cfg(backend, **kw):
    b = (T.CdwfaConfigBuilder().min_count(kw.pop("min_count", 1))
         .backend(backend).device("cpu"))
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _single(backend, reads=SINGLE_READS, **kw):
    engine = T.ConsensusDWFA(_cfg(backend, **kw))
    for r in reads:
        engine.add_sequence(r)
    return engine


def _dual(backend, reads=DUAL_READS, **kw):
    engine = T.DualConsensusDWFA(_cfg(backend, min_count=2, **kw))
    for r in reads:
        engine.add_sequence(r)
    return engine


def _decisions(records):
    """A log's records without the scorer tap's and the emission seq."""
    return [{k: v for k, v in r.items() if k != "seq"}
            for r in records if r["kind"] != "dispatch"]


# ------------------------------------------------- parity with JAX


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("kind", ["single", "dual", "priority"])
def test_port_records_match_jax(kind, strict):
    """The checkpoint tests' draws: one sink per search (the priority
    engine's own and one per group solve) in the same order, the same
    decision records, and no divergence either way."""
    with jaudit.capture(strict_align=strict) as jsinks:
        jres = _engine(J, kind, "jax").consensus()
    with obs_audit.capture(strict_align=strict) as tsinks:
        tres = _engine(T, kind, "torch").consensus()
    assert _key(tres) == _key(jres)
    assert [s.engine for s in tsinks] == [s.engine for s in jsinks]
    for js, ts in zip(jsinks, tsinks):
        assert _decisions(ts.records) == _decisions(js.records)
        assert obs_audit.diff_logs(ts.records, js.records) is None
        assert jaudit.diff_logs(js.records, ts.records) is None
    taps = [r for s in tsinks for r in s.records if r["kind"] == "dispatch"]
    assert taps and all(r["op"] in obs_audit._TAPPED_OPS
                        and r["backend"] == "torch" for r in taps)


def test_torch_and_python_logs_agree_and_resume_agrees():
    """The port's branch store against its python oracle, and a resumed
    search against the one from scratch, decision by decision."""
    with obs_audit.capture(strict_align=True) as sinks:
        _single("python").consensus()
        _single("torch").consensus()
    py, tc = sinks
    assert obs_audit.diff_logs(py.records, tc.records) is None
    assert obs_audit.diff_logs(tc.records, py.records) is None
    ctrl = tck.CheckpointController(snapshot_at_pops={1}, preempt=True)
    with pytest.raises(tck.SearchPreempted) as stop:
        with tck.installed(ctrl):
            _dual("torch").consensus()
    with obs_audit.capture() as sinks:
        scratch = _dual("torch").consensus()
        resumed = tck.resume_engine(stop.value.checkpoint).consensus()
    assert _key(resumed) == _key(scratch)
    assert obs_audit.diff_logs(sinks[1].records, sinks[0].records) is None


# ------------------------------------------------- zero-overhead guard


def test_disabled_search_sink_is_none():
    assert obs_audit.search_sink("single") is None
    assert not obs_audit.audit_enabled()


def test_disabled_maybe_tap_returns_scorer_unchanged():
    scorer = construct_backend(list(SINGLE_READS), _cfg("torch"), "torch")
    assert obs_audit.maybe_tap(scorer, "torch") is scorer
    assert type(scorer).__name__ == "TorchScorer"


def test_disabled_search_does_no_digest_work(monkeypatch):
    """With audit off the engines never reach a digest helper, so
    poisoning them all is invisible to a search."""

    def _poison(*_a, **_k):  # pragma: no cover - must never run
        raise AssertionError("audit digest work ran with audit disabled")

    for name in ("crc_bytes", "active_digest", "b64", "tail"):
        monkeypatch.setattr(obs_audit, name, _poison)
    assert _single("torch").consensus()[0].sequence
    assert _dual("torch").consensus()


def test_enabled_search_reaches_digests(monkeypatch):
    hits = []
    real = obs_audit.crc_bytes
    monkeypatch.setattr(
        obs_audit, "crc_bytes", lambda *a: hits.append(1) or real(*a)
    )
    with obs_audit.capture():
        _single("torch").consensus()
    assert hits


# -------------------------------------------------- decision recording


def test_capture_single_records():
    with obs_audit.capture() as sinks:
        results = _single("python").consensus()
    assert results
    (sink,) = sinks
    assert sink.engine == "single"
    kinds = {r["kind"] for r in sink.records}
    assert "branch" in kinds and "final" in kinds
    pops = [r["pop"] for r in sink.records if "pop" in r]
    assert pops == sorted(pops)
    assert [r["seq"] for r in sink.records] == list(range(len(sink.records)))
    units = [u for rec in sink.records for u in obs_audit.expand_units(rec)]
    assert units and all(key[0] in ("s", "p", "d") for key, _v in units)


def test_capture_dual_records_have_specs():
    with obs_audit.capture() as sinks:
        _dual("python").consensus()
    (sink,) = sinks
    branch = [r for r in sink.records if r["kind"] == "branch"]
    assert branch and all("specs" in r for r in branch)
    final = [r for r in sink.records if r["kind"] == "final"]
    assert final and all("imbalanced" in r for r in final)


def test_torch_run_records_and_dispatch_tap():
    with obs_audit.capture() as sinks:
        _single("torch").consensus()
    (sink,) = sinks
    runs = [r for r in sink.records if r["kind"] == "run"]
    assert runs and all(r["via"] == "run" and isinstance(r["code"], int)
                        for r in runs)
    taps = [r for r in sink.records if r["kind"] == "dispatch"]
    assert taps and all(
        r["op"] in obs_audit._TAPPED_OPS and r["backend"] == "torch"
        for r in taps
    )


def test_ring_bound_and_jsonl_stream(tmp_path):
    sink = obs_audit.AuditSink("single", ring=4)
    for i in range(10):
        sink.emit({"kind": "ignored", "pop": i})
    assert [r["pop"] for r in sink.records] == [6, 7, 8, 9]
    assert sink.records[-1]["seq"] == 9  # seq keeps counting past the cap
    path = tmp_path / "audit.jsonl"
    sink = obs_audit.AuditSink("single", ring=2, path=str(path))
    for i in range(5):
        sink.emit({"kind": "ignored", "pop": i})
    records = obs_audit.load_log(str(path))
    assert [r["pop"] for r in records] == list(range(5))
    assert len(sink.records) == 2


def test_priority_group_markers():
    engine = T.PriorityConsensusDWFA(_cfg("torch", min_count=1))
    for r in DUAL_READS:
        engine.add_sequence_chain([r])
    with obs_audit.capture() as sinks:
        engine.consensus()
    pri = [s for s in sinks if s.engine == "priority"]
    assert pri
    groups = [r for r in pri[0].records if r["kind"] == "group"]
    assert groups and all(
        {"level", "include", "size"} <= set(r) for r in groups
    )


# ------------------------------------------------ first-divergence diff


def test_diff_logs_localizes_tampered_decision():
    with obs_audit.capture() as sinks:
        _single("python").consensus()
    records = sinks[0].records
    tampered = copy.deepcopy(records)
    victim = next(r for r in tampered if r["kind"] == "branch")
    syms = bytearray(obs_audit.unb64(victim["syms"]))
    syms[0] = (syms[0] + 1) % 256
    victim["syms"] = obs_audit.b64(bytes(sorted(syms)))
    detail = obs_audit.diff_logs(records, tampered)
    assert detail is not None
    assert detail["pop_a"] == victim["pop"]
    assert detail["key"][1] == victim["len"]
    assert detail["value_a"] != detail["value_b"]


# --------------------------------------------------- lockstep shadowing


def test_clean_shadow_single_and_dual():
    obs_audit.reset_stats()
    with obs_audit.shadow_override("python"):
        single = _single("torch").consensus()
        dual = _dual("torch").consensus()
    assert single and dual
    snap = obs_audit.stats_snapshot()
    assert snap["divergences"] == 0
    assert snap["shadow_pops"] > 0


def test_shadow_noop_for_python_backend():
    obs_audit.reset_stats()
    with obs_audit.shadow_override("python"):
        _single("python").consensus()  # the oracle is the primary
    assert obs_audit.stats_snapshot()["shadow_pops"] == 0


def test_seeded_flip_vote_aborts_shadow_once(fault_plan):
    # find where the port commits a forced run, then flip that vote
    with obs_audit.capture(strict_align=True) as sinks:
        _single("torch").consensus()
    runs = [r for r in sinks[0].records
            if r["kind"] == "run" and r.get("forced")]
    assert runs, "the draw produced no forced device run"
    length = runs[0]["len"]
    fault_plan.add("flip_vote", backend="torch", op="vote", at=length,
                   count=1)
    obs_audit.reset_stats()
    with pytest.raises(obs_audit.ParityDivergence) as err:
        with obs_audit.shadow_override("python"):
            _single("torch").consensus()
    detail = err.value.detail
    assert detail["key"][0] == "s" and detail["key"][1] == length
    assert detail["value_a"] != detail["value_b"]
    assert obs_audit.stats_snapshot()["divergences"] == 1
    assert fault_plan.specs[0].fired == 1


def test_divergence_fires_one_flight_incident(fault_plan):
    # the clean shadow fires none; the flip-vote draw exactly one,
    # however many records both sides stream past the divergence
    obs_flight.reset()
    with obs_audit.shadow_override("python"):
        _single("torch").consensus()
    assert [i for i in obs_flight.incidents()
            if i["reason"] == "parity_divergence"] == []
    with obs_audit.capture(strict_align=True) as sinks:
        _single("torch").consensus()
    length = next(r["len"] for r in sinks[0].records
                  if r["kind"] == "run" and r.get("forced"))
    fault_plan.add("flip_vote", backend="torch", op="vote", at=length,
                   count=1)
    obs_flight.reset()
    try:
        with pytest.raises(obs_audit.ParityDivergence) as err:
            with obs_audit.shadow_override("python"):
                _single("torch").consensus()
        incidents = [i for i in obs_flight.incidents()
                     if i["reason"] == "parity_divergence"]
        assert len(incidents) == 1
        key = err.value.detail["key"]
        assert incidents[0]["detail"]["key"][:2] == [key[0], key[1]]
    finally:
        obs_flight.reset()


# ----------------------------------------------------- metrics & status


def test_audit_records_counter_when_metrics_on():
    obs_metrics.enable_metrics(True)
    obs_metrics.registry().reset()
    try:
        with obs_audit.capture():
            _single("python").consensus()
        series = obs_metrics.registry().snapshot()[
            "waffle_audit_records_total"]["series"]
        assert series['{engine="single"}'] > 0
    finally:
        obs_metrics.reset_metrics_enabled()
        obs_metrics.registry().reset()


def test_status_none_when_inactive_then_reports_activity():
    obs_audit.reset_stats()
    assert obs_audit.status() is None
    with obs_audit.capture():
        _single("python").consensus()
    status = obs_audit.status()
    assert status is not None and status["records"] > 0
    assert status["enabled"] is False and status["shadow"] is None
