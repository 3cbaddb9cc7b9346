"""The port's runtime plane (``waffle_con_tpu_torch/runtime/``) against
the JAX package's.

Every case of ``tests/test_fault_injection.py`` that is not bound to the
environment or to the XLA compilation cache, on the port's supervised
``"torch"`` backend (``device="cpu"``, so the kernels' plain twins run):
a fault injected mid-search demotes the live search down the backend
chain, and the result is byte-identical to the port's unsupervised
search, to JAX ``"jax"`` supervised under the same rule and to the JAX
``"python"`` oracle.  The demotion path is JAX's with ``"torch"`` in
place of ``"jax"``, and because the two supervisors see the same
sequence of scorer calls on these draws, so is the event log (JAX's
``pallas_mode`` event, which its scorer records when it is built, has no
counterpart).  ``pallas_compile`` is where the port differs on purpose:
JAX's Pallas guard falls back quietly to its XLA loop (and never runs
Pallas on the CPU), while a port kernel that fails raises, so an
unsupervised search raises and a supervised one demotes.

Every test runs under the ``runtime_clean`` fixture: a fresh plan in
both packages, and in teardown both plans cleared, both event logs
emptied and every supervisor timer thread joined, so nothing reaches the
next test of the worker.  The backoff is 0 except in the backoff test.
"""

import logging
import threading
import time

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.runtime import events as jevents
from waffle_con_tpu.runtime import faults as jfaults
from waffle_con_tpu.runtime.watchdog import dispatch_total as jdispatch_total
from waffle_con_tpu_torch.models import checkpoint as tck
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.ops import scorer as tscorer
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.runtime import events, faults, supervisor, watchdog
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

pytestmark = pytest.mark.faultinject

#: ``tests/test_fault_injection.py``'s draws
SINGLE_READS = (b"ACGTACGTACGT", b"ACGTACGTACGT", b"ACCTACGTACGT")
DUAL_READS = (b"ACGTACGT", b"ACGTACGT", b"ACTTACGT", b"ACTTACGT")
PRIORITY_CHAINS = (
    [b"ACGT", b"ACGTACGT"],
    [b"ACGT", b"ACGTACGT"],
    [b"ACTT", b"ACTTACTT"],
    [b"ACTT", b"ACTTACTT"],
)
ENGINES = ("single", "dual", "priority")
#: the event JAX's scorer records at construction (no port counterpart)
JAX_ONLY_EVENTS = ("pallas_mode",)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reset_runtime():
    faults.clear()
    jfaults.clear()
    events.clear_events()
    jevents.clear_events()
    supervisor.shutdown_executors(wait=True)


@pytest.fixture(autouse=True)
def runtime_clean():
    """A fresh installed port plan; teardown clears both packages' plans
    and event logs and joins every supervisor executor."""
    _reset_runtime()
    plan = faults.install(faults.FaultPlan())
    try:
        yield plan
    finally:
        _reset_runtime()


# ------------------------------------------------------------ helpers


def _cfg(pkg, backend, **kw):
    b = pkg.CdwfaConfigBuilder().min_count(1).backend(backend)
    if pkg is T and backend == "torch":
        b = b.device("cpu")
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _sup(pkg, backend, **kw):
    """``tests/test_fault_injection.py``'s ``_sup_cfg``."""
    kw.setdefault("backend_chain", ("python",))
    kw.setdefault("dispatch_retries", 1)
    kw.setdefault("breaker_threshold", 2)
    kw.setdefault("retry_backoff_s", 0.0)
    return _cfg(pkg, backend, **kw)


def _run(pkg, engine, cfg, data=None):
    """Run one engine; returns ``(engine, comparable result)``."""
    if engine == "priority":
        e = pkg.PriorityConsensusDWFA(cfg)
        for chain in data or PRIORITY_CHAINS:
            e.add_sequence_chain(chain)
        res = e.consensus()
        return e, (
            [[(c.sequence, list(c.scores)) for c in chain]
             for chain in res.consensuses],
            list(res.sequence_indices),
        )
    if engine == "single":
        e = pkg.ConsensusDWFA(cfg)
        for r in data or SINGLE_READS:
            e.add_sequence(r)
        return e, [(c.sequence, list(c.scores)) for c in e.consensus()]
    e = pkg.DualConsensusDWFA(cfg)
    for r in data or DUAL_READS:
        e.add_sequence(r)
    c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
    return e, [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                list(d.scores1), list(d.scores2)) for d in e.consensus()]


def _arm(fmod, rules, backend):
    """Install a plan of ``(kind, op, at, count)`` rules for ``backend``."""
    plan = fmod.install(fmod.FaultPlan())
    for kind, op, at, count in rules:
        plan.add(kind, backend=backend, op=op, at=at, count=count)
    return plan


def _demotions(evmod, rename=None):
    rename = rename or {}
    return [(rename.get(d["from_backend"], d["from_backend"]),
             rename.get(d["to_backend"], d["to_backend"]))
            for d in evmod.get_events("backend_demoted")]


def _event_log(evmod, drop=()):
    """The log's kinds with each dispatch event's op and index."""
    return [(e["kind"], e.get("op"), e.get("index"), e.get("attempt"))
            for e in evmod.get_events() if e["kind"] not in drop]


def _oracle(engine, data=None):
    return _run(J, engine, _cfg(J, "python"), data)[1]


#: fault kind -> its rules (``tests/test_fault_injection.py``'s):
#: two consecutive failures at dispatches 3 and 4 exhaust the retries
#: and demote; one garbage result at the first ``stats`` is retried
RULES = {
    "timeout": [("timeout", "*", 3, None), ("timeout", "*", 4, None)],
    "device_loss": [("device_loss", "*", 3, None),
                    ("device_loss", "*", 4, None)],
    "garbage": [("garbage", "stats", None, 1)],
}


# ------------------------------------------------------------ chain / plan


def test_effective_chain_default():
    assert supervisor.effective_chain(_cfg(T, "torch")) == (
        "torch", "native", "python")
    assert supervisor.effective_chain(_cfg(T, "native")) == (
        "native", "python")


def test_effective_chain_explicit_starts_at_backend():
    cfg = _cfg(T, "torch", backend_chain=("python", "torch"))
    assert supervisor.effective_chain(cfg) == ("torch", "python")
    with pytest.raises(ValueError):
        _cfg(T, "torch", backend_chain=("jax",))


def test_spec_count_bounds_firings(runtime_clean):
    runtime_clean.add("timeout", count=2)
    assert faults.poll("torch", "push", 0) is not None
    assert faults.poll("torch", "push", 1) is not None
    assert faults.poll("torch", "push", 2) is None
    assert len(events.get_events("fault_injected")) == 2


def test_unsupervised_scorer_is_unwrapped():
    """The default path builds the bare scorer: no supervisor, no timer."""
    sc = tscorer.make_scorer(list(SINGLE_READS), _cfg(T, "torch"))
    assert isinstance(sc, TorchScorer)
    sup = tscorer.make_scorer(list(SINGLE_READS),
                              _cfg(T, "torch", supervised=True))
    assert isinstance(sup, supervisor.BackendSupervisor)
    assert sup.backend == "torch" and sup.chain == ("torch", "native",
                                                    "python")


# ------------------------------------------- every kind x every engine


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", sorted(RULES))
def test_fault_parity_with_jax(kind, engine):
    """The port's supervised ``"torch"`` under the rule equals its
    unsupervised search, JAX ``"jax"`` under the same rule and the
    ``"python"`` oracle; the demotion path and the event log are JAX's."""
    want = _oracle(engine)
    assert _run(T, engine, _cfg(T, "torch"))[1] == want

    _arm(faults, RULES[kind], "torch")
    _eng, got = _run(T, engine, _sup(T, "torch"))
    faults.clear()
    _arm(jfaults, RULES[kind], "jax")
    _jeng, jgot = _run(J, engine, _sup(J, "jax"))
    jfaults.clear()

    assert got == want
    assert jgot == want
    assert _demotions(events) == _demotions(jevents, {"jax": "torch"})
    if kind == "garbage":
        assert _demotions(events) == []
        failed = events.get_events("dispatch_failed")
        assert failed and all("GarbageStats" in f["error"] for f in failed)
    else:
        assert _demotions(events)[0] == ("torch", "python")
    assert _event_log(events) == _event_log(jevents, JAX_ONLY_EVENTS)


@pytest.mark.parametrize("engine", ENGINES)
def test_pallas_compile_raises_unsupervised(engine):
    """An armed kernel fault is a raise: no quiet switch to the twin."""
    want = _oracle(engine)
    faults.active().add("pallas_compile", count=None)
    with pytest.raises(faults.InjectedKernelFailure):
        _run(T, engine, _cfg(T, "torch"))
    faults.clear()
    assert _run(T, engine, _cfg(T, "torch"))[1] == want


@pytest.mark.parametrize("engine", ENGINES)
def test_pallas_compile_demotes_supervised(engine):
    """Supervised, the failing kernel demotes the search (an event and a
    counter) and the result is the oracle's.  JAX's guard falls back to
    its XLA loop without an event, and runs no Pallas kernel on the CPU,
    so JAX under the same rule has no demotion."""
    want = _oracle(engine)
    obs_metrics.enable_metrics(True)
    try:
        before = obs_metrics.registry().counter(
            "waffle_backend_demotions_total", from_backend="torch",
            to_backend="python").value
        faults.active().add("pallas_compile", count=None)
        _eng, got = _run(T, engine, _sup(T, "torch"))
        after = obs_metrics.registry().counter(
            "waffle_backend_demotions_total", from_backend="torch",
            to_backend="python").value
    finally:
        obs_metrics.reset_metrics_enabled()
    faults.clear()
    assert got == want
    demoted = _demotions(events)
    assert demoted and set(demoted) == {("torch", "python")}
    assert after - before == len(demoted)
    assert all("InjectedKernelFailure" in e["error"]
               for e in events.get_events("dispatch_failed"))
    jfaults.install(jfaults.FaultPlan()).add("pallas_compile", count=None)
    assert _run(J, engine, _sup(J, "jax"))[1] == want
    assert _demotions(jevents) == []


def test_pallas_compile_fault_raises_at_dispatch():
    """``test_pallas_compile_fault_raises_in_guard``: the kernel hook
    raises while armed, then the count is spent."""
    faults.active().add("pallas_compile", op="run", count=1)
    with pytest.raises(faults.InjectedFault):
        faults.check_kernel("run")
    faults.check_kernel("run")
    faults.check_kernel("branch")


# ---------------------------------- demotion on generated draws, default chain


def _gen_single():
    _, reads = generate_test(4, 120, 8, 0.03, seed=7)
    return list(reads)


def _gen_dual():
    truth, reads1 = generate_test(4, 80, 4, 0.02, seed=4001)
    h2 = bytearray(truth)
    h2[30] = (h2[30] + 1) % 4
    h2[60] = (h2[60] + 2) % 4
    return list(reads1) + [
        corrupt(bytes(h2), 0.02, np.random.default_rng(4100 + i))
        for i in range(4)
    ]


def _gen_priority():
    _, level0 = generate_test(4, 40, 6, 0.02, seed=5000)
    t1a, _ = generate_test(4, 70, 1, 0.0, seed=5001)
    t1b = bytearray(t1a)
    t1b[35] = (t1b[35] + 1) % 4
    return [
        [level0[i], corrupt(t1a if i < 3 else bytes(t1b), 0.02,
                            np.random.default_rng(5002 + i))]
        for i in range(6)
    ]


GEN = {"single": _gen_single, "dual": _gen_dual, "priority": _gen_priority}


# ---------------------------------- demotion on generated draws, default chain


def _gen_single():
    # 8 % error at min_count 3 forks at nearly every pop: many run calls
    _, reads = generate_test(4, 90, 6, 0.08, seed=1)
    return list(reads)


def _gen_dual():
    truth, reads1 = generate_test(4, 80, 4, 0.02, seed=4001)
    h2 = bytearray(truth)
    h2[30] = (h2[30] + 1) % 4
    h2[60] = (h2[60] + 2) % 4
    return list(reads1) + [
        corrupt(bytes(h2), 0.02, np.random.default_rng(4100 + i))
        for i in range(4)
    ]


def _gen_priority():
    _, level0 = generate_test(4, 40, 6, 0.02, seed=5000)
    t1a, _ = generate_test(4, 70, 1, 0.0, seed=5001)
    t1b = bytearray(t1a)
    t1b[35] = (t1b[35] + 1) % 4
    return [
        [level0[i], corrupt(t1a if i < 3 else bytes(t1b), 0.02,
                            np.random.default_rng(5002 + i))]
        for i in range(6)
    ]


#: engine -> (draw, min_count)
GEN = {"single": (_gen_single, 3), "dual": (_gen_dual, 2),
       "priority": (_gen_priority, 2)}


def _dispatches(monkeypatch, engine, data, cfg):
    """``(op, index)`` of every supervised call of a fault-free search."""
    seen = []
    orig = supervisor.BackendSupervisor._supervised

    def spy(self, op, involved, call, **kw):
        seen.append((op, self._dispatch_index))
        return orig(self, op, involved, call, **kw)

    with monkeypatch.context() as m:
        m.setattr(supervisor.BackendSupervisor, "_supervised", spy)
        _run(T, engine, cfg, data)
    events.clear_events()
    return seen


@pytest.mark.parametrize("engine", ENGINES)
def test_device_loss_mid_search_demotes_to_native(engine, monkeypatch):
    """The default chain on draws where the run kernel, the arena and the
    batched branch step are engaged: device loss at the middle ``run``
    (or ``arena``) call and its two retries demotes torch -> native once,
    mid-search, and the result is the unsupervised search's and the
    oracle's."""
    make, mc = GEN[engine]
    data = make()
    want = _run(J, engine, _cfg(J, "python", min_count=mc), data)[1]
    assert _run(T, engine, _cfg(T, "torch", min_count=mc), data)[1] == want
    cfg = _cfg(T, "torch", min_count=mc, supervised=True,
               retry_backoff_s=0.0)
    seen = _dispatches(monkeypatch, engine, data, cfg)
    hits = [i for op, i in seen if op == "run"]
    if len(hits) < 2:
        hits = [i for op, i in seen if op == "arena"]
    assert len(hits) >= 2
    at = hits[len(hits) // 2]
    assert 0 < at < seen[-1][1]
    plan = faults.active()
    for k in range(3):
        plan.add("device_loss", backend="torch", at=at + k, count=None)
    eng, got = _run(T, engine, cfg, data)
    assert got == want
    assert _demotions(events) == [("torch", "native")]
    assert len(events.get_events("dispatch_failed")) == 3
    if engine != "priority":  # its last group has a scorer of its own
        assert eng.last_search_stats["backend"] == "native"


@pytest.mark.parametrize("engine", ENGINES)
def test_repromotion_mid_search_keeps_new_handles(engine, monkeypatch):
    """Demoted at the middle run call, promoted back after two clean
    calls: the probe waits for the next call, so the handles the call
    that earned it made are in the ledger when the search migrates, and
    no call fails after the injected ones."""
    make, mc = GEN[engine]
    data = make()
    want = _run(J, engine, _cfg(J, "python", min_count=mc), data)[1]
    cfg = _cfg(T, "torch", min_count=mc, supervised=True,
               retry_backoff_s=0.0, repromote_after=2)
    seen = _dispatches(monkeypatch, engine, data, cfg)
    hits = [i for op, i in seen if op == "run"]
    at = hits[len(hits) // 2]
    for k in range(3):
        faults.active().add("device_loss", backend="torch", at=at + k,
                            count=None)
    _eng, got = _run(T, engine, cfg, data)
    assert got == want
    assert _demotions(events) == [("torch", "native")]
    assert events.get_events("backend_promoted")
    assert len(events.get_events("dispatch_failed")) == 3
    assert events.get_events("handles_restored") == []


# ------------------------------------------------------- retry w/o demotion


def test_transient_fault_retried_without_demotion():
    want = _oracle("single")
    faults.active().add("device_loss", backend="torch", at=3, count=1)
    _, got = _run(T, "single", _sup(T, "torch"))
    assert got == want
    assert len(events.get_events("dispatch_failed")) == 1
    assert events.get_events("backend_demoted") == []
    assert events.get_events("handles_restored") == []  # raised before the call


def test_breaker_trips_before_retries_exhaust():
    faults.active().add("timeout", backend="torch", count=None)
    _run(T, "single", _sup(T, "torch", dispatch_retries=5,
                           breaker_threshold=2))
    demotions = events.get_events("backend_demoted")
    assert demotions and demotions[0]["to_backend"] == "python"
    assert len(events.get_events("dispatch_failed")) == 2


def test_chain_exhaustion_raises_backend_failure():
    faults.active().add("timeout", count=None)  # every backend, every call
    sc = tscorer.make_scorer(list(SINGLE_READS), _sup(
        T, "torch", dispatch_retries=0, breaker_threshold=1))
    assert isinstance(sc, supervisor.BackendSupervisor)
    with pytest.raises(supervisor.BackendFailure):
        sc.root(np.ones(len(SINGLE_READS), dtype=bool))


# ------------------------------------------------------------ re-promotion


@pytest.mark.parametrize("engine", ENGINES)
def test_repromotion_returns_to_torch(engine):
    """Demoted at the first calls, promoted back after five clean ones:
    the search ends on ``"torch"``, byte-identical, with JAX's events."""
    want = _oracle(engine)
    rules = [("timeout", "*", 0, None), ("timeout", "*", 1, None)]
    _arm(faults, rules, "torch")
    eng, got = _run(T, engine, _sup(T, "torch", repromote_after=5))
    faults.clear()
    _arm(jfaults, rules, "jax")
    _run(J, engine, _sup(J, "jax", repromote_after=5))
    jfaults.clear()
    assert got == want
    promoted = events.get_events("backend_promoted")
    assert promoted and promoted[0]["to_backend"] == "torch"
    assert _event_log(events) == _event_log(jevents, JAX_ONLY_EVENTS)
    if engine == "single":
        assert eng.last_search_stats["backend"] == "torch"


def test_failed_probe_backs_off_and_search_completes():
    want = _oracle("single")
    plan = faults.active()
    plan.add("timeout", backend="torch", at=0, count=None)
    plan.add("timeout", backend="torch", at=1, count=None)
    plan.add("device_loss", backend="torch", op="probe", count=None)
    _, got = _run(T, "single", _sup(T, "torch", repromote_after=3))
    assert got == want
    assert events.get_events("probe_failed")
    assert events.get_events("backend_promoted") == []


def test_no_fault_supervised_equals_unsupervised_counters():
    """Without a fault the supervised search makes the unsupervised
    search's scorer calls (the CPU form of equal kernel launches) and
    records no demotion."""
    for engine, (make, mc) in GEN.items():
        data = make()
        e0, r0 = _run(T, engine, _cfg(T, "torch", min_count=mc), data)
        e1, r1 = _run(T, engine, _cfg(T, "torch", min_count=mc,
                                      supervised=True, retry_backoff_s=0.0),
                      data)
        assert r1 == r0
        c0 = e0.last_search_stats["scorer_counters"]
        c1 = e1.last_search_stats["scorer_counters"]
        assert {k: v for k, v in c1.items() if v} == {
            k: v for k, v in c0.items() if v}, engine
    assert events.get_events("backend_demoted") == []
    assert events.get_events("dispatch_failed") == []


# --------------------------------------------------------------- timers


def test_real_timer_timeout_retried(monkeypatch):
    """A call that outlives ``dispatch_timeout_s`` is abandoned and
    retried on a fresh thread; the abandoned call is joined before the
    test returns."""
    want = _oracle("single")
    release = threading.Event()
    orig = TorchScorer.stats
    state = {"n": 0}

    def slow_stats(self, h, consensus):
        state["n"] += 1
        if state["n"] == 1:
            release.wait(10.0)
        return orig(self, h, consensus)

    monkeypatch.setattr(TorchScorer, "stats", slow_stats)
    try:
        _, got = _run(T, "single", _sup(T, "torch", dispatch_timeout_s=0.5))
    finally:
        release.set()
        assert supervisor.shutdown_executors(wait=True) >= 1
    assert got == want
    failed = events.get_events("dispatch_failed")
    assert len(failed) == 1 and "DispatchTimeout" in failed[0]["error"]
    assert events.get_events("backend_demoted") == []
    assert not [t for t in threading.enumerate()
                if t.name.startswith("waffle-dispatch")]


def test_retry_backoff_grows_exponentially(monkeypatch):
    """The one test with a backoff: each retry sleeps ``base * 2^(n-1)``
    times ``1 + jitter * U[0, 1)``."""
    sleeps = []
    monkeypatch.setattr(supervisor.time, "sleep", sleeps.append)
    monkeypatch.setattr(supervisor.random, "random", lambda: 0.5)
    plan = faults.active()
    for at in (3, 4, 5):
        plan.add("device_loss", backend="torch", at=at, count=None)
    _, got = _run(T, "single", _cfg(T, "torch", supervised=True,
                                    backend_chain=("python",),
                                    dispatch_retries=3, breaker_threshold=9,
                                    retry_backoff_s=0.01, retry_jitter=0.5))
    assert got == _oracle("single")
    assert sleeps == pytest.approx([0.0125, 0.025, 0.05])
    assert events.get_events("backend_demoted") == []


# --------------------------------------------------------------- watchdog


def test_watchdog_strict_raises_over_budget():
    with pytest.raises(watchdog.WatchdogError):
        _run(T, "single", _cfg(T, "torch", dispatch_budget=1,
                               watchdog_strict=True))


def test_watchdog_default_warns_over_budget(caplog):
    with caplog.at_level(logging.WARNING, logger="waffle_con_tpu_torch"):
        _, results = _run(T, "single", _cfg(T, "torch", dispatch_budget=1))
    assert results
    assert events.get_events("watchdog_budget_exceeded")
    assert any("over" in r.getMessage() and "budget" in r.getMessage()
               for r in caplog.records)


def test_watchdog_reads_no_environment(monkeypatch):
    """``WAFFLE_WATCHDOG=strict`` is the JAX package's knob: the port's
    strict mode is the config field alone."""
    monkeypatch.setenv("WAFFLE_WATCHDOG", "strict")
    _, results = _run(T, "single", _cfg(T, "torch", dispatch_budget=1))
    assert results
    assert events.get_events("watchdog_budget_exceeded")


@pytest.mark.parametrize("engine", ENGINES)
def test_watchdog_passes_at_pinned_budget(engine):
    """Pinned at the search's own count, strict mode passes (> budget
    fails).  The count is JAX ``"jax"``'s but for ``stats_calls``: JAX's
    scorer answers the root's snapshot from its root call uncounted, the
    port counts it."""
    eng, _ = _run(T, engine, _cfg(T, "torch"))
    counters = eng.last_search_stats["scorer_counters"]
    pinned = watchdog.dispatch_total(counters)
    assert pinned > 0
    jeng, _ = _run(J, engine, _cfg(J, "jax"))
    jc = jeng.last_search_stats["scorer_counters"]
    assert jdispatch_total(jc) - jc.get("stats_calls", 0) == (
        pinned - counters["stats_calls"])
    eng, _ = _run(T, engine, _cfg(T, "torch", dispatch_budget=pinned,
                                  watchdog_strict=True))
    assert watchdog.dispatch_total(
        eng.last_search_stats["scorer_counters"]) == pinned
    assert pinned > 1
    with pytest.raises(watchdog.WatchdogError):
        _run(T, engine, _cfg(T, "torch", dispatch_budget=pinned - 1,
                             watchdog_strict=True))


@pytest.mark.parametrize("engine", ENGINES)
def test_deadline_stops_with_a_final_checkpoint(engine):
    """A lapsed ``CheckpointController`` deadline raises
    ``DeadlineExceeded`` at the first pop boundary with a checkpoint of
    where the search stopped, and that checkpoint resumes to the
    uninterrupted result."""
    want = _run(T, engine, _cfg(T, "torch"))[1]
    ctrl = tck.CheckpointController(deadline=time.monotonic() - 1.0,
                                    label="drill")
    with tck.installed(ctrl):
        with pytest.raises(watchdog.DeadlineExceeded, match="drill"):
            _run(T, engine, _cfg(T, "torch"))
    assert ctrl.last_checkpoint is not None
    assert events.get_events("deadline_exceeded")
    eng = tck.resume_engine(
        tck.SearchCheckpoint.from_json(ctrl.last_checkpoint.to_json()))
    res = eng.consensus()
    if engine == "priority":
        got = ([[(c.sequence, list(c.scores)) for c in chain]
                for chain in res.consensuses], list(res.sequence_indices))
    elif engine == "single":
        got = [(c.sequence, list(c.scores)) for c in res]
    else:
        c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
        got = [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                list(d.scores1), list(d.scores2)) for d in res]
    assert got == want


# ------------------------------------------------------- the scorer seam


def test_config_codec_round_trips_the_runtime_fields():
    cfg = _cfg(T, "torch", supervised=True, backend_chain=("native",),
               dispatch_timeout_s=2.5, dispatch_retries=4,
               retry_backoff_s=0.0, retry_jitter=0.1, breaker_threshold=5,
               repromote_after=7, dispatch_budget=99, watchdog_strict=True)
    enc = tck.encode_config_dict(cfg)
    assert enc["backend_chain"] == ["native"]
    import json

    assert tck.decode_config_dict(json.loads(json.dumps(enc))) == cfg
    for field, bad in (("backend_chain", ["jax"]), ("dispatch_retries", -1),
                       ("breaker_threshold", 0), ("dispatch_budget", 0)):
        with pytest.raises(tck.CheckpointRejected):
            tck.decode_config_dict({**enc, field: bad})


def test_deferred_stats_resolve_once_and_write_through():
    calls = []

    def fetch():
        calls.append(1)
        return tscorer.BranchStats(np.array([1, 2]), np.zeros((2, 4)),
                                   np.array([1, 1]), np.array([False, True]))

    d = tscorer.DeferredStats(fetch)
    assert isinstance(d, tscorer.BranchStats) and not calls
    out = tscorer.resolve_stats([(0, d)])
    assert out[0][1] is d and calls == [1]
    assert list(d.eds) == [1, 2] and calls == [1]
    faults.mangle_stats(d)
    with pytest.raises(supervisor.GarbageStats):
        supervisor.BackendSupervisor._validate([d])


def test_fast_paths_follow_the_supervisors_generation():
    """A demotion bumps ``fastpath_gen``; a view forwards it, so a
    snapshot over the view re-resolves."""
    sup = tscorer.make_scorer(list(SINGLE_READS), _sup(T, "torch"))
    view = tscorer.SubsetScorer(sup, [0, 2])
    fp = tscorer.fast_paths(view)
    assert tscorer.fast_paths(view) is fp and fp.gen == 0
    h = view.root(np.ones(2, dtype=bool))
    sup._demote(RuntimeError("drill"))
    assert view.fastpath_gen == sup.fastpath_gen == 1
    fp2 = tscorer.fast_paths(view)
    assert fp2 is not fp and fp2.gen == 1
    assert fp2.run_extend is not None and fp2.run_takes()
    assert sup.backend == "python" and sup.live_handles() == 1
    view.free(h)
    assert sup.live_handles() == 0


# --------------------------------------------------------------- leaks


def test_leak_guard_after_a_supervised_fault():
    """A supervised search with a fault and a timer, then in the same
    process an unsupervised search and ``test_torch_audit``-style
    ``flip_vote`` use: after the fixture's reset no plan, event,
    executor thread or demoted state is left, and the unsupervised
    search is the oracle's with a bare scorer."""
    want = _oracle("single")
    threads0 = {t.ident for t in threading.enumerate()}
    faults.active().add("device_loss", backend="torch", at=3, count=None)
    faults.active().add("device_loss", backend="torch", at=4, count=None)
    _, got = _run(T, "single", _sup(T, "torch", dispatch_timeout_s=30.0))
    assert got == want and _demotions(events) == [("torch", "python")]
    _reset_runtime()
    assert faults.active() is None and events.get_events() == []
    assert {t.ident for t in threading.enumerate()} <= threads0
    eng, got = _run(T, "single", _cfg(T, "torch"))
    assert got == want and eng.last_search_stats["backend"] == "torch"
    assert events.get_events() == []
    plan = faults.install(faults.FaultPlan())
    plan.add("flip_vote", backend="torch", op="vote", count=1)
    assert faults.maybe_flip_vote("torch", 3)
    assert not faults.maybe_flip_vote("torch", 4)
    faults.clear()
    assert faults.active() is None
    assert events.get_events() == []
    assert supervisor.shutdown_executors() == 0
