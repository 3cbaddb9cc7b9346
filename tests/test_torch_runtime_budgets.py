"""Fast-path engagement net for the port (``tests/test_dispatch_budgets.py``
on the port's ``"torch"`` backend, ``device="cpu"``).

For each scenario family the port's blocking scorer calls (the sum over
``DISPATCH_COUNTER_KEYS``) stay within the JAX test's pinned budget, the
batched device loops are engaged (more steps than calls), and no launch
planner refused a shape.  The same budget pinned through the config
passes the watchdog in strict mode, one call fewer raises, and the
search through the supervisor makes the same calls.  The count equals
JAX ``"jax"``'s but for ``stats_calls`` (JAX answers the root's snapshot
from its root call uncounted; the port counts it).
"""

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.runtime.watchdog import dispatch_total as jdispatch_total
from waffle_con_tpu_torch.runtime import events, faults, supervisor
from waffle_con_tpu_torch.runtime.watchdog import WatchdogError, dispatch_total
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

pytestmark = pytest.mark.serve


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def runtime_clean():
    """No plan armed; the event log and the supervisors' executors are
    cleared after each test."""
    faults.clear()
    events.clear_events()
    try:
        yield
    finally:
        faults.clear()
        events.clear_events()
        supervisor.shutdown_executors(wait=True)


def _cfg(pkg, **kw):
    b = (pkg.CdwfaConfigBuilder().backend("torch" if pkg is T else "jax")
         .min_count(2).initial_band(16))
    if pkg is T:
        b = b.device("cpu")
    for key, value in kw.items():
        b = getattr(b, key)(value)
    return b.build()


def _dual_reads(seq_len, per_hap, split_at, seed=11):
    truth, reads1 = generate_test(4, seq_len, per_hap, 0.01, seed=seed)
    hap2 = bytearray(truth)
    for pos in split_at:
        hap2[pos] = (hap2[pos] + 1) % 4
    hap2 = bytes(hap2)
    reads2 = [corrupt(hap2, 0.01, np.random.default_rng(700 + i))
              for i in range(per_hap)]
    return list(reads1) + reads2


def _single_clean(pkg, **kw):
    _, reads = generate_test(4, 120, 6, 0.01, seed=5)
    engine = pkg.ConsensusDWFA(_cfg(pkg, **kw))
    for read in reads:
        engine.add_sequence(read)
    return engine


def _dual(pkg, reads, **kw):
    engine = pkg.DualConsensusDWFA(_cfg(pkg, **kw))
    for read in reads:
        engine.add_sequence(read)
    return engine


def _dual_split(pkg, **kw):
    return _dual(pkg, _dual_reads(80, 4, (30, 60)), **kw)


def _locked_tail(pkg, **kw):
    # haplotypes diverge only near the end: both branches lock a long
    # shared prefix before the dual split engages
    return _dual(pkg, _dual_reads(150, 4, (140, 145)), **kw)


def _min_af(pkg, **kw):
    return _dual(pkg, _dual_reads(80, 4, (30, 60), seed=13),
                 **{"min_af": 0.25, **kw})


def _priority_chain(pkg, **kw):
    _, level0 = generate_test(4, 60, 4, 0.01, seed=3)
    t1a, _ = generate_test(4, 80, 1, 0.0, seed=4)
    t1b = bytearray(t1a)
    t1b[30] = (t1b[30] + 1) % 4
    t1b[60] = (t1b[60] + 2) % 4
    t1b = bytes(t1b)
    engine = pkg.PriorityConsensusDWFA(_cfg(pkg, **kw))
    for i in range(4):
        level1 = corrupt(t1a if i < 2 else t1b, 0.01,
                         np.random.default_rng(200 + i))
        engine.add_sequence_chain([level0[i], level1])
    return engine


#: ``tests/test_dispatch_budgets.py``'s families and budgets
_FAMILIES = {
    "single_clean": (_single_clean, 2),
    "dual_split": (_dual_split, 19),
    "locked_tail": (_locked_tail, 9),
    "min_af": (_min_af, 19),
    "priority_chain": (_priority_chain, 85),
}


def _calls(engine):
    engine.consensus()
    return engine.last_search_stats["scorer_counters"]


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_blocking_dispatch_budget(family):
    build, budget = _FAMILIES[family]
    engine = build(T)
    assert engine.consensus()  # the scenario must actually resolve
    counters = engine.last_search_stats["scorer_counters"]
    total = dispatch_total(counters)
    assert 0 < total <= budget, (
        f"{family}: {total} blocking dispatches > budget {budget} "
        f"({ {k: v for k, v in sorted(counters.items()) if v} })"
    )
    steps = (counters.get("run_steps", 0)
             + counters.get("run_dual_steps", 0)
             + counters.get("arena_steps", 0))
    assert steps > total, (family, steps, total)
    refused = {k: v for k, v in counters.items()
               if k.startswith("plan_refused_") and v}
    assert refused == {}, (family, refused)
    jc = _calls(build(J))
    assert jdispatch_total(jc) - jc.get("stats_calls", 0) == (
        total - counters.get("stats_calls", 0)), family


@pytest.mark.parametrize("family", sorted(_FAMILIES))
def test_budget_pinned_in_the_config(family):
    """The family's own count as ``dispatch_budget`` passes in strict
    mode, supervised or not; one fewer raises."""
    build, _budget = _FAMILIES[family]
    pinned = dispatch_total(_calls(build(T)))
    for supervised in (False, True):
        c = _calls(build(T, dispatch_budget=pinned, watchdog_strict=True,
                         supervised=supervised, retry_backoff_s=0.0))
        assert dispatch_total(c) == pinned, (family, supervised)
    with pytest.raises(WatchdogError):
        _calls(build(T, dispatch_budget=pinned - 1, watchdog_strict=True))
    assert events.get_events("watchdog_budget_exceeded")
    assert events.get_events("backend_demoted") == []
