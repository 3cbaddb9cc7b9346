"""The port's observability plane: tracer, metrics registry, search
reports, scorer instrumentation (``waffle_con_tpu_torch/obs``).

``tests/test_obs.py``'s cases on the port: span nesting and Chrome
export, the disabled-mode no-allocation guarantee, histogram bucket
math, Prometheus text exposition, scorer instrumentation through
``construct_backend`` and the search reports of the engines.  Then what
the port adds: the ``torch.profiler`` bridge (a span is a
``record_function`` range), ``fast_paths()`` through ``TimedScorer`` and
``AuditScorerTap`` equal to the bare scorer's (the kernels, the
``ARENA_*`` sizes and the launch planners' answers, refusals included),
and searches with the whole plane on giving the results and scorer
counters of searches with it off."""

import json
import logging

import numpy as np
import pytest
import torch

import waffle_con_tpu_torch as T
from test_torch_checkpoint import _engine, _key
from waffle_con_tpu_torch.obs import audit as obs_audit
from waffle_con_tpu_torch.obs import instrument
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import trace as obs_trace
from waffle_con_tpu_torch.obs.audit import AuditScorerTap
from waffle_con_tpu_torch.obs.instrument import TimedScorer, maybe_instrument
from waffle_con_tpu_torch.obs.metrics import Histogram, MetricsRegistry
from waffle_con_tpu_torch.obs.report import SearchReport
from waffle_con_tpu_torch.obs.trace import NULL_SPAN, Tracer
from waffle_con_tpu_torch.ops import torch_scorer
from waffle_con_tpu_torch.ops.scorer import (
    PythonScorer,
    construct_backend,
    fast_paths,
)

SINGLE_READS = (b"ACGTACGT", b"ACGTACGT", b"ACCTACGT")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(**kw):
    b = T.CdwfaConfigBuilder().min_count(1).backend("torch").device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


@pytest.fixture
def obs_on():
    """Metrics and tracing on, on a clean registry and tracer; teardown
    switches both off again so no state leaks."""
    obs_metrics.enable_metrics(True)
    obs_metrics.registry().reset()
    tracer = obs_trace.get_tracer()
    tracer.enable(True)
    tracer.clear()
    try:
        yield tracer
    finally:
        obs_metrics.reset_metrics_enabled()
        obs_metrics.registry().reset()
        tracer.reset_enabled()
        tracer.clear()


# ------------------------------------------------------------------ tracer


def test_tracer_nested_spans_contained():
    t = Tracer()
    t.enable(True)
    with t.span("outer", "search", engine="single"):
        with t.span("inner", "dispatch", backend="torch"):
            pass
    evs = t.chrome_events()
    assert [e["name"] for e in evs] == ["inner", "outer"]  # exit order
    inner, outer = evs
    for e in evs:
        assert e["ph"] == "X"
        assert {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e)
    assert outer["ts"] <= inner["ts"]
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-6
    assert inner["args"] == {"backend": "torch"}
    totals = t.category_totals()
    assert set(totals) == {"search", "dispatch"}
    assert totals["search"] >= totals["dispatch"]


def test_tracer_disabled_is_allocation_free():
    t = Tracer()
    assert not t.enabled  # off by default
    s1 = t.span("a", "host")
    s2 = t.span("b", "dispatch", key="value")
    assert s1 is NULL_SPAN and s2 is NULL_SPAN
    with s1:
        pass
    assert t.chrome_events() == []
    assert t.category_totals() == {}


def test_tracer_chrome_trace_file_and_clear(tmp_path):
    t = Tracer()
    t.enable(True)
    with t.span("search", "search"):
        pass
    path = tmp_path / "trace.json"
    t.write_chrome_trace(str(path))
    payload = json.loads(path.read_text())
    assert payload["displayTimeUnit"] == "ms"
    assert payload["traceEvents"][0]["name"] == "search"
    t.clear()
    assert t.chrome_events() == [] and t.category_totals() == {}


def test_trace_context_ids_and_parent_links():
    t = Tracer()
    t.enable(True)
    ctx = obs_trace.TraceContext("consensus/search-1",
                                 obs_trace.JOB_PID_BASE + 1)
    prev = obs_trace.set_current_context(ctx)
    try:
        assert obs_trace.current_trace_id() == "consensus/search-1"
        with t.span("outer", "search"):
            with t.span("inner", "dispatch"):
                pass
    finally:
        obs_trace.set_current_context(prev)
    assert obs_trace.current_trace_id() is None
    meta, inner, outer = t.chrome_events()
    assert meta["ph"] == "M" and meta["pid"] == ctx.chrome_pid
    assert inner["args"]["parent_id"] == outer["args"]["span_id"]
    assert inner["args"]["trace_id"] == "consensus/search-1"


def test_profiler_bridge_ranges_enclose_scorer_calls(obs_on):
    """With the bridge on, a search's spans are ``record_function``
    ranges in a ``torch.profiler`` trace: the ``search`` span and its
    ``dispatch:*`` spans show up by name."""
    from torch.profiler import ProfilerActivity, profile

    assert obs_on.enable_profiler_bridge(True)
    try:
        eng = T.ConsensusDWFA(_cfg())
        for r in SINGLE_READS:
            eng.add_sequence(r)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            eng.consensus()
    finally:
        obs_on.enable_profiler_bridge(False)
    names = {e.key for e in prof.key_averages()}
    assert "search" in names and "dispatch:run" in names
    spans = [e["name"] for e in obs_on.chrome_events()]
    assert "search" in spans and "dispatch:run" in spans


# ------------------------------------------------------------- histograms


def test_histogram_bucket_math():
    h = Histogram(bounds=(0.001, 0.01, 0.1))
    for v in (0.0005, 0.001, 0.005, 0.05, 0.5, 5.0):
        h.observe(v)
    assert h.counts == [2, 1, 1, 2]
    assert h.cumulative() == [2, 3, 4, 6]
    assert h.count == 6
    assert h.sum == pytest.approx(5.5565)
    h.observe(float("nan"))
    assert h.counts[-1] == 3  # NaN lands in the +Inf bucket
    with pytest.raises(ValueError):
        Histogram(bounds=())


def test_registry_snapshot_shape_and_type_stability():
    reg = MetricsRegistry()
    reg.counter("c_total", kind="x").inc(3)
    reg.gauge("g_depth").set(7)
    reg.histogram("h_lat", buckets=(1.0, 2.0), backend="torch").observe(1.5)
    snap = reg.snapshot()
    assert snap["c_total"]["type"] == "counter"
    assert snap["c_total"]["series"]['{kind="x"}'] == 3
    assert snap["g_depth"]["series"]["{}"] == 7
    hist = snap["h_lat"]["series"]['{backend="torch"}']
    assert hist["buckets"] == {"1.0": 0, "2.0": 1}
    assert hist["overflow"] == 0
    assert hist["count"] == 1 and hist["sum"] == pytest.approx(1.5)
    with pytest.raises(ValueError):
        reg.gauge("c_total")


def test_prometheus_exposition_format():
    reg = MetricsRegistry()
    reg.counter("waffle_x_total", backend="torch").inc(2)
    reg.gauge("waffle_depth").set(4)
    h = reg.histogram("waffle_lat_seconds", buckets=(0.1, 1.0), op="push")
    for v in (0.05, 0.5, 5.0):
        h.observe(v)
    lines = reg.render_prometheus().strip().splitlines()
    assert "# TYPE waffle_x_total counter" in lines
    assert 'waffle_x_total{backend="torch"} 2.0' in lines
    assert "waffle_depth 4.0" in lines
    assert "# TYPE waffle_lat_seconds histogram" in lines
    assert 'waffle_lat_seconds_bucket{op="push",le="0.1"} 1' in lines
    assert 'waffle_lat_seconds_bucket{op="push",le="1.0"} 2' in lines
    assert 'waffle_lat_seconds_bucket{op="push",le="+Inf"} 3' in lines
    assert 'waffle_lat_seconds_count{op="push"} 3' in lines
    assert any(line.startswith('waffle_lat_seconds_sum{op="push"}')
               for line in lines)


# ------------------------------------------------- scorer instrumentation


def test_construct_backend_plain_when_disabled():
    assert not obs_metrics.metrics_enabled()
    assert not obs_trace.tracing_enabled()
    scorer = construct_backend(list(SINGLE_READS), _cfg(), "python")
    assert isinstance(scorer, PythonScorer)


def test_timed_scorer_records_latency_histograms(obs_on):
    scorer = construct_backend(list(SINGLE_READS), _cfg(), "torch")
    assert isinstance(scorer, TimedScorer)
    h = scorer.root(np.ones(len(SINGLE_READS), dtype=bool))
    scorer.push(h, b"A")
    scorer.stats(h, b"A")
    scorer.push_many([(h, b"AC")])
    snap = obs_metrics.registry().snapshot()
    latency = snap["waffle_dispatch_latency_seconds"]["series"]
    key_push = '{backend="torch",op="push"}'
    assert latency[key_push]["count"] == 2
    assert latency['{backend="torch",op="stats"}']["count"] == 1
    assert snap["waffle_dispatch_total"]["series"][key_push] == 2
    branches = snap["waffle_dispatch_branches"]["series"][key_push]
    assert branches["count"] == 1
    spans = [e["name"] for e in obs_on.chrome_events()]
    assert spans.count("dispatch:push") == 2


def test_timed_scorer_counters_stay_live(obs_on):
    scorer = maybe_instrument(PythonScorer(list(SINGLE_READS), _cfg()),
                              "python")
    assert isinstance(scorer, TimedScorer)
    shared = {"adopted": 1}
    scorer.counters = shared
    assert scorer._base.counters is shared
    h = scorer.root(np.ones(len(SINGLE_READS), dtype=bool))
    scorer.push(h, b"A")
    assert shared["push_calls"] == 1


def _fp_fields(fp, Lw=64):
    return dict(
        run_extend=fp.run_extend is not None,
        run_extend_dual=fp.run_extend_dual is not None,
        run_arena=fp.run_arena is not None,
        clone_push_many=fp.clone_push_many is not None,
        arena=(fp.arena_cap, fp.arena_k, fp.arena_cre_per_event,
               fp.arena_take_max),
        takes=(fp.run_takes(), fp.run_dual_takes(), fp.arena_takes(Lw)),
    )


@pytest.mark.parametrize("refuse", [None, "plan_run", "plan_run_dual",
                                    "plan_arena"])
def test_fast_paths_through_proxies_equal_bare(monkeypatch, refuse):
    """``TimedScorer`` and ``AuditScorerTap`` (and both stacked, as
    ``construct_backend`` stacks them) hide no capability: the kernels,
    the arena's sizes and the planners' answers — a refusal included,
    counted in the backend's ``counters`` — are the bare scorer's."""
    if refuse is not None:
        monkeypatch.setattr(
            torch_scorer, "planner_refuses",
            lambda _dev, planner, *_s: planner.__name__ == refuse)
    reads = list(SINGLE_READS)
    bare = torch_scorer.TorchScorer(reads, _cfg())
    want = _fp_fields(fast_paths(bare))
    assert want["run_extend"] and want["run_arena"]
    for wrap in (lambda s: TimedScorer(s, "torch"),
                 lambda s: AuditScorerTap(s, "torch"),
                 lambda s: AuditScorerTap(TimedScorer(s, "torch"), "torch")):
        base = torch_scorer.TorchScorer(reads, _cfg())
        proxy = wrap(base)
        assert _fp_fields(fast_paths(proxy)) == want
        assert proxy.counters is base.counters
        assert proxy.ragged_run_probe(0) is None
        h = proxy.root(np.ones(len(reads), dtype=bool))
        assert proxy.ragged_run_probe(h) == (base, h)
    if refuse is not None:
        key = {"plan_run": "plan_refused_run",
               "plan_run_dual": "plan_refused_run_dual",
               "plan_arena": "plan_refused_arena"}[refuse]
        assert base.counters[key] == 1 and bare.counters[key] == 1


# --------------------------------------------------------- search reports


def test_search_report_from_single_engine(obs_on):
    engine = T.ConsensusDWFA(_cfg(backend="python"))
    for r in SINGLE_READS:
        engine.add_sequence(r)
    results = engine.consensus()
    rep = engine.last_search_report
    assert isinstance(rep, SearchReport)
    assert rep.engine == "single" and rep.backend == "python"
    assert rep.nodes_explored > 0 and rep.dispatch_total > 0
    assert rep.n_results == len(results)
    assert rep.consensus_len == len(results[0].sequence)
    assert rep.wall_s > 0
    d = rep.to_dict()
    assert d["engine"] == "single"
    assert "dispatch" in d["time_breakdown"]
    assert rep.summary_line().startswith("search summary: engine=single")
    snap = obs_metrics.registry().snapshot()
    assert snap["waffle_searches_total"]["series"]['{engine="single"}'] == 1


def test_search_report_dual_peak_queue(obs_on):
    engine = T.DualConsensusDWFA(_cfg())
    for r in (b"ACGTACGT", b"ACGTACGT", b"ACTTACGT", b"ACTTACGT"):
        engine.add_sequence(r)
    engine.consensus()
    rep = engine.last_search_report
    assert rep.engine == "dual" and rep.backend == "torch"
    assert rep.peak_queue_size > 0
    assert engine.last_search_stats["peak_queue_size"] == rep.peak_queue_size


def test_search_report_without_obs_and_summary_level(caplog):
    engine = T.PriorityConsensusDWFA(_cfg(log_search_summary=True))
    for r in (b"ACGTACGT", b"ACGTACGT", b"ACTTACGT", b"ACTTACGT"):
        engine.add_sequence_chain([r])
    with caplog.at_level(logging.INFO,
                         logger="waffle_con_tpu_torch.obs.report"):
        engine.consensus()
    rep = engine.last_search_report
    assert rep.engine == "priority" and rep.nodes_explored > 0
    assert rep.time_breakdown == {}  # no tracer, no breakdown
    # one line per inner dual solve, then the priority search's own
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs[-1] == rep.summary_line()
    assert len(msgs) == 1 + len(engine.last_search_stats["groups"])
    assert all("engine=dual" in m for m in msgs[:-1])


def test_frontier_sampler_records_host_values(monkeypatch):
    monkeypatch.setattr(instrument, "FRONTIER_SAMPLE_DEFAULT", 1)
    before = len(instrument.frontier_samples())
    engine = T.DualConsensusDWFA(_cfg(backend="python", min_count=2))
    for r in (b"ACGTACGT", b"ACGTACGT", b"ACTTACGT", b"ACTTACGT"):
        engine.add_sequence(r)
    engine.consensus()
    samples = instrument.frontier_samples()[before:]
    assert samples and all(s["engine"] == "dual" for s in samples)
    assert [s["pops"] for s in samples] == sorted(s["pops"] for s in samples)
    monkeypatch.setattr(instrument, "FRONTIER_SAMPLE_DEFAULT", 0)
    assert instrument.FrontierSampler("x").due(0) is False


# ----------------------------------------------- the plane on and off


@pytest.mark.parametrize("kind", ["single", "dual", "priority"])
def test_plane_on_changes_no_result_and_no_launch(kind):
    """Metrics, tracer (bridge on) and audit capture all on: the same
    results and the same scorer counters (kernel calls and steps, arena,
    gang and planner counters) as with everything off."""
    off = _engine(T, kind, "torch")
    want = _key(off.consensus())
    want_c = off.last_search_stats["scorer_counters"]
    obs_metrics.enable_metrics(True)
    tracer = obs_trace.get_tracer()
    tracer.enable(True)
    tracer.enable_profiler_bridge(True)
    try:
        with obs_audit.capture() as sinks:
            on = _engine(T, kind, "torch")
            got = _key(on.consensus())
    finally:
        obs_metrics.reset_metrics_enabled()
        obs_metrics.registry().reset()
        tracer.reset_enabled()
        tracer.clear()
    assert got == want
    assert on.last_search_stats["scorer_counters"] == want_c
    assert sinks and sinks[0].records
