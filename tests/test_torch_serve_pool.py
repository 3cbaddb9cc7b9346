"""The serving pool of the port (``waffle_con_tpu_torch/ops/ragged.py``'s
``BandArena``) and the gang launch across stores, against the JAX package.

* Lockstep parity: three members at three band widths through four rounds
  of ``probe`` / ``run_group`` / ``run_extend``, every round's ``(steps,
  code, appended)`` and stats equal to the port's solo ``run_extend`` and
  to JAX's ``JaxScorer`` (solo and ganged); the pool's counters equal
  JAX's (``tests/test_mixed_width.py``'s ``_parity_rounds``).
* The pool's paths, mirroring ``tests/test_ragged.py`` and
  ``tests/test_mixed_width.py``: re-centring under growth, eviction when
  the band outgrows the pool, exhaustion and page recycling, the typed
  ``ArenaExhausted``, the width-equality gate, a supervisor demotion
  releasing pages.
* No fallback hides the kernel: a failed gang launch fails each member's
  call; a planner refusal takes the bucketed path and is counted.

The gang launch's planner and its members from different stores are in
``tests/test_torch_serve_kernel.py``.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu.config import CdwfaConfig as JCdwfaConfig
from waffle_con_tpu.ops import ragged as jragged
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.ops import ragged_kernel as rgk
from waffle_con_tpu_torch.ops import torch_scorer
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.runtime import events, faults, supervisor
from waffle_con_tpu_torch.runtime.supervisor import BackendSupervisor
from waffle_con_tpu_torch.serve import ArenaExhausted
from waffle_con_tpu_torch.utils.example_gen import generate_test

pytestmark = pytest.mark.serve

BIG = 10**9

#: band seeds landing on three band widths under the default pool (E=32):
#: E 8 / 16 / 32 -> W 18 / 34 / 66
BAND_SEEDS = (8, 12, 24)


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


def _cfg(band=None, **kw):
    b = CdwfaConfigBuilder().backend("torch").device("cpu")
    if band is not None:
        b = b.initial_band(band)
    for k, v in kw.items():
        b = getattr(b, k)(v)
    return b.build()


def _mutated_reads(n, lo, hi, seed):
    """``tests/test_mixed_width.py``'s draw."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, size=int(r.integers(lo, hi))).astype(np.uint8)
    reads = []
    for _ in range(n):
        b = base.copy()
        m = r.random(len(b)) < 0.03
        b[m] = r.integers(0, 4, int(m.sum())).astype(np.uint8)
        reads.append(bytes(b))
    return reads


JOBS = (
    _mutated_reads(5, 80, 120, 1),
    _mutated_reads(9, 150, 200, 2),
    _mutated_reads(3, 40, 60, 3),
)


def _round_key(out):
    steps, code, app, st, rec = out
    return (steps, code, app, st.eds.tolist(), np.asarray(st.occ).tolist(),
            st.split.tolist(), st.reached.tolist(),
            None if st.fin is None else st.fin.tolist(), rec)


def _rounds(solos, rags, probe, run_group, rounds, max_steps=8,
            grow_after=None):
    """``rounds`` lockstep rounds: each solo scorer's ``run_extend``, then
    every ragged scorer's call probed, ganged and run.  ``grow_after``
    ``(round, index)`` doubles that member's band on both sides after the
    round.  Returns each round's solo and ganged keys."""
    jobs = [s.reads for s in solos]
    hs_s = [s.root(np.ones(len(j), bool)) for s, j in zip(solos, jobs)]
    hs_r = [s.root(np.ones(len(j), bool)) for s, j in zip(rags, jobs)]
    cons_s, cons_r = [b""] * len(jobs), [b""] * len(jobs)
    solo_keys, rag_keys = [], []
    for rnd in range(rounds):
        so = [s.run_extend(h, c, BIG, BIG, 0, 2, False, max_steps,
                           allow_records=False)
              for s, h, c in zip(solos, hs_s, cons_s)]
        args = [(h, c, BIG, BIG, 0, 2, False, max_steps)
                for h, c in zip(hs_r, cons_r)]
        specs = [probe((s.ragged_run_probe, a, {})) for s, a in zip(rags, args)]
        assert all(sp is not None for sp in specs), "eligible member refused"
        run_group(specs)
        ro = [s.run_extend(*a) for s, a in zip(rags, args)]
        solo_keys.append([_round_key(o) for o in so])
        rag_keys.append([_round_key(o) for o in ro])
        for g in range(len(jobs)):
            cons_s[g] += so[g][2]
            cons_r[g] += ro[g][2]
        if grow_after is not None and grow_after[0] == rnd:
            solos[grow_after[1]]._grow_e()
            rags[grow_after[1]]._grow_e()
    return solo_keys, rag_keys


STAT_KEYS = ("groups", "members", "mean_occupancy", "mixed_w_groups",
             "gang_rows", "mean_gang_rows", "admits", "recenters",
             "releases", "exhausted", "injected_consumed")


@pytest.fixture(scope="module")
def jax_rounds():
    """JAX's four rounds (``JaxScorer`` solo and ganged through its
    ``BandArena``), its pool counters, and the same with the narrow
    member grown after round 1."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("WAFFLE_RAGGED", "1")
        mp.setenv("WAFFLE_RAGGED_MIXED_W", "1")
        for name, bands, grow in (("mixed", BAND_SEEDS, None),
                                  ("grow", (8, 24, 12), (1, 0))):
            jragged.reset_arena()
            solos = [JaxScorer(r, JCdwfaConfig(initial_band=b))
                     for r, b in zip(JOBS, bands)]
            rags = [JaxScorer(r, JCdwfaConfig(initial_band=b))
                    for r, b in zip(JOBS, bands)]
            keys = _rounds(solos, rags, jragged.probe, jragged.run_group, 4,
                           grow_after=grow)
            stats = jragged.get_arena().stats()
            for s in rags:
                s.ragged_release()
            out[name] = (keys, stats, jragged.get_arena().stats())
        jragged.reset_arena()
    return out


@pytest.mark.parametrize("case", ["mixed", "grow"])
def test_pool_rounds_match_solo_and_jax(jax_rounds, case):
    """Three members at three band widths, four lockstep rounds: the
    port's ganged calls equal its solo calls and JAX's (solo and ganged)
    round for round, and the pool's counters equal JAX's; with ``grow``
    the narrow member's band doubles after round 1 and it keeps ganging
    (re-centred in the pool)."""
    bands, grow = ((BAND_SEEDS, None) if case == "mixed"
                   else ((8, 24, 12), (1, 0)))
    solos = [TorchScorer(r, _cfg(b)) for r, b in zip(JOBS, bands)]
    rags = [TorchScorer(r, _cfg(b)) for r, b in zip(JOBS, bands)]
    assert len({s._W for s in rags}) == 3
    (j_solo, j_rag), j_stats, j_after = jax_rounds[case]
    p_solo, p_rag = _rounds(solos, rags, ragged.probe, ragged.run_group, 4,
                            grow_after=grow)
    assert p_rag == p_solo
    assert p_solo == j_solo
    assert p_rag == j_rag
    arena = ragged.get_arena()
    stats = arena.stats()
    assert {k: stats[k] for k in STAT_KEYS} == {k: j_stats[k]
                                                for k in STAT_KEYS}
    assert stats["groups"] == 4 and stats["mixed_w_groups"] == 4
    if case == "grow":
        assert stats["recenters"] == 1 and stats["releases"] == 0
    for s in rags:
        s.ragged_release()
    after = arena.stats()
    assert after["pages_used"] == 0 == j_after["pages_used"]
    assert all(s.counters["run_ragged_injected"] == 4 for s in rags)


def test_recenter_evicts_when_band_outgrows_pool():
    arena = ragged.get_arena(ragged.ArenaConfig(band_e=8))  # pool W = 18
    s = TorchScorer(_mutated_reads(4, 60, 90, 13), _cfg(8))
    assert s._W == arena.W
    assert arena.try_admit(s, job_id=1) is not None
    assert arena.stats()["pages_used"] > 0
    s._grow_e()  # W 18 -> 34 > the pool's 18: eviction
    st = arena.stats()
    assert (st["recenters"], st["releases"], st["pages_used"]) == (0, 1, 0)
    h = s.root(np.ones(4, bool))
    assert ragged.probe((s.ragged_run_probe,
                         (h, b"", BIG, BIG, 0, 2, False, 8), {})) is None
    assert arena.stats()["refused"] == {"width": 1}


def test_mixed_w_off_restores_the_equality_gate():
    arena = ragged.get_arena(ragged.ArenaConfig(mixed_w=False))
    reads = _mutated_reads(4, 60, 90, 7)
    narrow = TorchScorer(reads, _cfg(8))    # W=18 != pool W
    matched = TorchScorer(reads, _cfg(24))  # W=66 == pool W (E=32)
    assert narrow._W != arena.W and matched._W == arena.W
    h_n = narrow.root(np.ones(4, bool))
    h_m = matched.root(np.ones(4, bool))
    args = (h_n, b"", BIG, BIG, 0, 2, False, 8)
    assert ragged.probe((narrow.ragged_run_probe, args, {})) is None
    args = (h_m, b"", BIG, BIG, 0, 2, False, 8)
    assert ragged.probe((matched.ragged_run_probe, args, {})) is not None
    matched.ragged_release()
    assert arena.stats()["pages_used"] == 0


def test_geometry_hint_floors_cons_and_band():
    reads = _mutated_reads(4, 60, 90, 8)
    plain = TorchScorer(reads, _cfg(8))
    with ragged.serve_scope(ragged.ArenaConfig(cons_len=4096)):
        assert ragged.serving_active()
        served = TorchScorer(reads, _cfg(8))
    with ragged.serve_scope(ragged.ArenaConfig(mixed_w=False, band_e=64)):
        floored = TorchScorer(reads, _cfg(8))
    with ragged.serve_scope(ragged.ArenaConfig(enabled=False)):
        assert ragged.geometry_hint() is None
    assert not ragged.serving_active()
    assert (plain._C, plain._E) == (512, 8)
    assert (served._C, served._E) == (4096, 8)
    assert floored._E == 64


def test_page_table_exhaustion_is_typed():
    pt = ragged.PageTable(n_pages=2, page_rows=8)
    assert pt.alloc(1, 8).tolist() == list(range(8))
    pt.alloc(2, 5)  # rounds up to one page
    assert pt.free_pages == 0
    with pytest.raises(ArenaExhausted):
        pt.alloc(3, 1)
    assert pt.release(2)
    assert pt.free_pages == 1
    assert pt.alloc(3, 3).tolist() == list(range(8, 16))
    assert not pt.release(99)


@pytest.mark.parametrize("bands", [(None, None, None), (8, 24, 12)])
def test_exhaustion_degrades_and_pages_recycle(bands):
    arena = ragged.get_arena(ragged.ArenaConfig(rows=16, page_rows=8))
    _, reads = generate_test(8, 60, 6, 0.02, seed=11)
    with ragged.serve_scope(arena.cfg):
        scorers = [TorchScorer(tuple(reads), _cfg(b)) for b in bands]
    assert arena.try_admit(scorers[0], job_id=1) is not None
    assert arena.try_admit(scorers[1], job_id=2) is not None
    assert arena.try_admit(scorers[2], job_id=3) is None  # pool full
    assert arena.stats()["exhausted"] == 1
    # re-admission of a resident scorer is idempotent
    assert arena.try_admit(scorers[0], job_id=1) is not None
    assert arena.stats()["admits"] == 2
    arena.release_scorer(scorers[0])
    rows = arena.try_admit(scorers[2], job_id=3)
    assert rows is not None and len(rows) == 8
    arena.release_job(2)
    arena.release_scorer(scorers[2])
    st = arena.stats()
    assert st["pages_used"] == 0 and st["pages_free"] == st["pages_total"]
    # a probe that meets a full pool takes the bucketed path, counted
    arena.try_admit(scorers[0], job_id=1)
    arena.try_admit(scorers[1], job_id=2)
    h = scorers[2].root(np.ones(6, bool))
    args = (h, b"", BIG, BIG, 0, 2, False, 8)
    assert ragged.probe((scorers[2].ragged_run_probe, args, {})) is None
    assert arena.stats()["refused"] == {"exhausted": 1}


@pytest.mark.faultinject
def test_supervisor_demotion_releases_pages():
    faults.clear()
    events.clear_events()
    plan = faults.install(faults.FaultPlan())
    try:
        cfg = _cfg(min_count=1, backend_chain=("python",),
                   dispatch_retries=1, breaker_threshold=2,
                   retry_backoff_s=0.0)
        reads = (b"ACGTACGTACGT", b"ACGTACGTACGT", b"ACCTACGTACGT")
        with ragged.serve_scope():
            sup = BackendSupervisor(reads, cfg)
        inner = sup._scorer
        arena = ragged.get_arena()
        assert arena.try_admit(inner, job_id=42) is not None
        assert arena.stats()["pages_used"] > 0
        plan.add("timeout", backend="torch", count=None)
        sup.root(np.ones(len(reads), dtype=bool))
        demotions = events.get_events("backend_demoted")
        assert [(d["from_backend"], d["to_backend"]) for d in demotions] == [
            ("torch", "python")]
        st = arena.stats()
        assert st["pages_used"] == 0 and st["releases"] == 1
        # the supervisor's hop reaches the live backend, which has none
        assert sup.ragged_run_probe(0) is None
    finally:
        faults.clear()
        events.clear_events()
        supervisor.shutdown_executors(wait=True)


def _two_members():
    rags = [TorchScorer(r, _cfg(b)) for r, b in zip(JOBS[:2], (8, 24))]
    hs = [s.root(np.ones(s.num_reads, bool)) for s in rags]
    args = [(h, b"", BIG, BIG, 0, 2, False, 8) for h in hs]
    specs = [ragged.probe((s.ragged_run_probe, a, {}))
             for s, a in zip(rags, args)]
    return rags, args, specs


def test_failed_launch_fails_each_member(monkeypatch):
    """A gang whose launch fails never turns into solo runs: each
    member's own ``run_extend`` raises the failure."""
    def broken(members, in_place):
        raise RuntimeError("run_ragged kernel launch failed: test")

    monkeypatch.setattr(rgk, "run_members", broken)
    rags, args, specs = _two_members()
    keys = ragged.run_group(specs)
    assert len(keys) == 2
    for s, a in zip(rags, args):
        with pytest.raises(RuntimeError, match="launch failed: test"):
            s.run_extend(*a)
    st = ragged.get_arena().stats()
    assert st["group_failures"] == 1 and st["groups"] == 0


def test_armed_kernel_fault_fails_each_member():
    faults.clear()
    plan = faults.install(faults.FaultPlan())
    try:
        plan.add("pallas_compile", backend="torch", op="ragged")
        rags, args, specs = _two_members()
        ragged.run_group(specs)
        for s, a in zip(rags, args):
            with pytest.raises(faults.InjectedKernelFailure):
                s.run_extend(*a)
    finally:
        faults.clear()
        events.clear_events()


def test_planner_refusal_takes_the_bucketed_path(monkeypatch):
    monkeypatch.setattr(torch_scorer, "planner_refuses",
                        lambda device, planner, *shape: True)
    rags, args, specs = _two_members()
    assert ragged.run_group(specs) == []
    out = [s.run_extend(*a) for s, a in zip(rags, args)]
    assert all(o[0] >= 0 for o in out)
    assert ragged.get_arena().stats()["plan_refused"] == 1
    for s in rags:
        assert s.counters["plan_refused_ragged"] == 1
        assert "run_ragged_injected" not in s.counters
