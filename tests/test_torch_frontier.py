"""The frontier gang in the port's engines, on the CPU.

* The width policy (``FrontierSpeculator``: the ``frontier_width``
  field, the adaptive rule and its cooldown), ported
  from ``tests/test_frontier_gang.py``.
* The deposit seam at the scorer (``TorchScorer``): a deposit is consumed
  by the matching ``run_extend`` (equal to a solo run), dropped by every
  change of its slot (free, push, in-place clone-push, activate,
  deactivate, the dual run, the arena, band and consensus growth), kept
  across slot growth, and a mispredicted one runs solo.
* The single, dual and priority engines at frontier widths 2, 4, 8 and
  adaptive on ``tests/test_frontier_gang.py``'s draws: each equal to the
  port at width 1, to JAX ``"jax"`` at the same width and to the port's
  ``"python"`` oracle, with the gang counters equal to JAX's.  The two
  scorers' consensus capacity C differs (the port's is twice JAX's on
  these draws: it is sized by the run kernel's power-of-two step bucket,
  as JAX's Pallas path sizes it, and JAX's XLA loop on the CPU sizes it
  by the step bound); the gang skips a member whose run could outgrow C,
  which never happens on these draws, so the counters agree.
* ``tests/test_fuzz_parity.py``'s ``test_frontier_gang_fuzz[1]`` draw,
  held to the ``"python"`` oracle and to JAX at its width.
"""

import types

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from test_frontier_gang import _chains, _dual_reads, _noisy_reads, _tie_reads
from waffle_con_tpu.models import consensus as j_consensus
from waffle_con_tpu.models import dual_consensus as j_dual
from waffle_con_tpu_torch.models import consensus as t_consensus
from waffle_con_tpu_torch.models import dual_consensus as t_dual
from waffle_con_tpu_torch.models.frontier import FrontierSpeculator
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.ops.ragged import GangMember
from waffle_con_tpu_torch.ops.scorer import make_scorer
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import generate_test

BIG = 2**31 - 1
GANG_KEYS = ("gang_groups", "gang_members", "run_gang_injected",
             "run_gang_mispredict")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ the policy


def test_config_frontier_width_knob():
    cfg = T.CdwfaConfigBuilder().frontier_width(6).build()
    assert FrontierSpeculator(object(), cfg).width(100, 0) == 6
    # clamped to the gang capacity
    cfg = T.CdwfaConfigBuilder().frontier_width(99).build()
    sp = FrontierSpeculator(object(), cfg)
    assert sp.width(100, 0) == FrontierSpeculator.MAX_M == 8


@pytest.mark.parametrize("depth,gap", [(0, None), (3, 0), (100, 0),
                                       (100, 5)])
def test_width_one_turns_the_gang_off(depth, gap):
    """``frontier_width(1)`` is the serial search at every frontier, the
    flat deep ones the adaptive width would gang included; no serving
    layer is active in the port."""
    cfg = T.CdwfaConfigBuilder().frontier_width(1).build()
    assert FrontierSpeculator(object(), cfg).width(depth, gap) == 1
    assert not ragged.serving_active()


def test_config_frontier_width_validation():
    with pytest.raises(ValueError):
        T.CdwfaConfigBuilder().frontier_width(0).build()
    assert T.CdwfaConfigBuilder().build().frontier_width is None


def test_width_policy_adaptive():
    sp = FrontierSpeculator(object())
    assert sp.width(0, None) == 1
    assert sp.width(3, 0) == 1
    assert sp.width(64, 2) == 1  # a positive gap: the next pops are no ties
    assert sp.width(4, 0) == 2
    assert sp.width(8, 0) == 4
    assert sp.width(16, None) == 8
    assert sp.width(1000, 0) == FrontierSpeculator.MAX_M
    assert sp.last_width == FrontierSpeculator.MAX_M


def test_width_policy_cooldown():
    sp = FrontierSpeculator(object())
    sp._ts = types.SimpleNamespace(
        counters={"run_gang_injected": 1, "run_gang_mispredict": 63})
    assert sp.width(64, 0) == 1
    assert sp._cooldown == FrontierSpeculator.COOLDOWN_POPS
    for _ in range(FrontierSpeculator.COOLDOWN_POPS):
        assert sp.width(64, 0) == 1
    # the cooldown is over and the window was reset: speculation resumes
    assert sp.width(64, 0) == FrontierSpeculator.MAX_M


def test_python_backend_never_gangs():
    sc = make_scorer([b"ACGT"], T.CdwfaConfigBuilder().backend("python")
                     .build())
    sp = FrontierSpeculator(sc, T.CdwfaConfigBuilder().frontier_width(4)
                            .build())
    h = sc.root(np.ones(1, dtype=bool))
    assert sp.gang([GangMember(h, b"", BIG, BIG, 0, 8)] * 2, 1, False) == 0
    assert not sp.pending(h)


# ------------------------------------------------- the deposit seam


def _store(seed, n=6, length=200, err=0.0):
    _, reads = generate_test(4, length, n, err, seed=seed)
    cfg = T.CdwfaConfigBuilder().backend("torch").device("cpu").min_count(2)
    return reads, TorchScorer(reads, cfg.build())


def _two_root_gang(seed, max_steps=32):
    reads, sc = _store(seed)
    n = len(reads)
    h1 = sc.root(np.ones(n, dtype=bool))
    h2 = sc.root(np.ones(n, dtype=bool))
    gang = ragged.frontier_gang_for(sc)
    deposits = gang.run([GangMember(h1, b"", BIG, BIG, 0, max_steps),
                         GangMember(h2, b"", BIG, BIG, 0, max_steps)],
                        2, False)
    return reads, sc, gang, h1, h2, deposits


def _solo(reads, *args):
    """The same call on a fresh store, from a fresh root."""
    _r, sc = _store(0)
    sc = TorchScorer(reads, sc.config)
    h = sc.root(np.ones(len(reads), dtype=bool))
    out = sc.run_extend(h, *args)
    return out, sc, h


def _same_result(a, b):
    (s1, c1, a1, st1, r1), (s2, c2, a2, st2, r2) = a, b
    assert (s1, c1, a1) == (s2, c2, a2)
    for name in ("eds", "occ", "split", "reached", "fin"):
        x, y = getattr(st1, name), getattr(st2, name)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert r1 == r2 == []


def _same_slot(sc1, h1, sc2, h2):
    s1, s2 = sc1._slot_of[h1], sc2._slot_of[h2]
    n = int(sc1._state["clen"][s1])
    assert n == int(sc2._state["clen"][s2])
    for name in ("D", "e", "rmin", "er"):
        assert torch.equal(sc1._state[name][s1], sc2._state[name][s2]), name
    assert torch.equal(sc1._state["cons"][s1, :n], sc2._state["cons"][s2, :n])


def test_gang_deposit_consume_and_free():
    reads, sc, gang, h1, h2, deposits = _two_root_gang(81000)
    assert deposits == 2 and gang.pending(h1) and gang.pending(h2)
    got = sc.run_extend(h1, b"", BIG, BIG, 0, 2, False, 32,
                        allow_records=False)
    assert sc.counters["run_gang_injected"] == 1 and not gang.pending(h1)
    want, ref, g = _solo(reads, b"", BIG, BIG, 0, 2, False, 32, -1, False)
    _same_result(got, want)
    _same_slot(sc, h1, ref, g)
    assert sc.counters["gang_groups"] == 1
    assert sc.counters["gang_members"] == 2
    # free() drops the peer's deposit
    sc.free(h2)
    assert not gang.pending(h2) and gang.counters["dropped"] == 1


def test_gang_deposit_mispredict_runs_solo():
    reads, sc, gang, h1, _h2, deposits = _two_root_gang(83000)
    assert deposits == 2
    # the real pop has a tighter budget than speculated: the speculated
    # run may overrun it, so the deposit must not be used
    got = sc.run_extend(h1, b"", 0, 0, 0, 2, False, 32)
    assert sc.counters.get("run_gang_mispredict", 0) == 1
    assert sc.counters.get("run_gang_injected", 0) == 0
    want, ref, g = _solo(reads, b"", 0, 0, 0, 2, False, 32)
    _same_result(got, want)
    _same_slot(sc, h1, ref, g)


def _mutate(sc, h, h2, reads, how):
    first = bytes([reads[0][0]])
    if how == "push":
        sc.push_many([(h, first)])
    elif how == "clone_push_in_place":
        sc.clone_push_many([(h, first, True)])
    elif how == "activate":
        sc.deactivate(h, 1)
        sc.activate(h, 1, 0, b"")
    elif how == "deactivate":
        sc.deactivate_many([(h, 2)])
    elif how == "run_dual":
        sc.run_extend_dual(h, h2, b"", b"", BIG, BIG, 0, 2, 20, 2, False,
                           False, 8)
    elif how == "arena":
        lw = 1024
        win = np.zeros((2, lw), dtype=np.int32)
        sc.run_arena([(h, None, 0, 0)], BIG, 2, 0, 0, False, False, BIG, 0,
                     20, 20, 16, 1000, win, win,
                     np.zeros((2, 4), dtype=np.int32))
    elif how == "grow_e":
        sc._grow_e()
    elif how == "grow_cons":
        sc._grow_cons()


@pytest.mark.parametrize("how", [
    "push", "clone_push_in_place", "activate", "deactivate", "run_dual",
    "arena", "grow_e", "grow_cons",
])
def test_gang_deposit_dropped_on_slot_change(how):
    reads, sc, gang, h1, h2, deposits = _two_root_gang(82000)
    assert deposits == 2
    _mutate(sc, h1, h2, reads, how)
    assert not gang.pending(h1)
    # a change of one slot keeps the other branch's deposit; a geometry
    # growth, or an op over both branches, drops every one
    both = how in ("grow_e", "grow_cons", "run_dual")
    assert gang.pending(h2) == (not both)


def test_gang_deposit_kept_across_slot_growth():
    reads, sc, gang, h1, _h2, deposits = _two_root_gang(84000)
    assert deposits == 2
    B = sc._B
    extra = [sc.root(np.ones(len(reads), dtype=bool)) for _ in range(B)]
    assert sc._B > B and gang.pending(h1)
    got = sc.run_extend(h1, b"", BIG, BIG, 0, 2, False, 32,
                        allow_records=False)
    assert sc.counters["run_gang_injected"] == 1
    want, ref, g = _solo(reads, b"", BIG, BIG, 0, 2, False, 32, -1, False)
    _same_result(got, want)
    _same_slot(sc, h1, ref, g)
    assert len(extra) == B


def test_gang_skips_are_counted():
    reads, sc, gang, h1, h2, _deposits = _two_root_gang(85000)
    h3 = sc.root(np.ones(len(reads), dtype=bool))
    # h1 has a deposit, h3's run could outgrow the consensus capacity
    got = gang.run([GangMember(h1, b"", BIG, BIG, 0, 32),
                    GangMember(h3, b"", BIG, BIG, 0, sc._C)], 2, False)
    assert got == 0
    c = sc.counters
    assert (c["gang_skip_pending"], c["gang_skip_capacity"],
            c["gang_skip_members"]) == (1, 1, 1)
    assert c["gang_groups"] == 1


# ------------------------------------------- engines at every width


def _jax_cfg(m, mc):
    b = J.CdwfaConfigBuilder().backend("jax").min_count(mc)
    return (b.frontier_width(m) if m else b).build()


def _port_cfg(backend, m, mc):
    b = T.CdwfaConfigBuilder().backend(backend).device("cpu").min_count(mc)
    return (b.frontier_width(m) if m else b).build()


def _record_scorers(monkeypatch, module):
    made = []
    inner = module.make_scorer

    def recording(reads, config):
        sc = inner(reads, config)
        made.append(sc)
        return sc

    monkeypatch.setattr(module, "make_scorer", recording)
    return made


def _single(pkg, cfg, reads):
    e = pkg.ConsensusDWFA(cfg)
    for r in reads:
        e.add_sequence(r)
    res = [(c.sequence, list(c.scores)) for c in e.consensus()]
    return res, dict(e.last_search_stats.get("scorer_counters", {}))


def _dual(pkg, cfg, reads):
    e = pkg.DualConsensusDWFA(cfg)
    for r in reads:
        e.add_sequence(r)
    res = e.consensus()
    key = [(repr(d.consensus1), repr(d.consensus2), list(d.is_consensus1))
           for d in res]
    return key, dict(e.last_search_stats.get("scorer_counters", {}))


DRAWS = {
    # name: (reads, engine, min_count, port module, JAX module)
    "noisy": (_noisy_reads, _single, 2, t_consensus, j_consensus),
    "tie": (_tie_reads, _single, 4, t_consensus, j_consensus),
    "dual": (_dual_reads, _dual, 2, t_dual, j_dual),
}
_REF = {}


def _ref(name):
    """The ``"python"`` oracle and the port at width 1, once a module."""
    if name not in _REF:
        make, run, mc, _t, _j = DRAWS[name]
        reads = make()
        _REF[name] = (reads, run(T, _port_cfg("python", 1, mc), reads)[0],
                      run(T, _port_cfg("torch", 1, mc), reads)[0])
    return _REF[name]


@pytest.mark.parametrize("m", [2, 4, 8, None])
@pytest.mark.parametrize("name", sorted(DRAWS))
def test_engine_width_parity(name, m, monkeypatch):
    _make, run, mc, tmod, jmod = DRAWS[name]
    reads, want, port1 = _ref(name)
    t_made = _record_scorers(monkeypatch, tmod)
    j_made = _record_scorers(monkeypatch, jmod)
    got, tc = run(T, _port_cfg("torch", m, mc), reads)
    jgot, jc = run(J, _jax_cfg(m, mc), reads)
    assert port1 == want
    assert got == want
    assert jgot == got
    # the port sizes the consensus capacity by its run kernel's
    # power-of-two step bucket (as JAX's Pallas path does), JAX's XLA
    # loop on the CPU by the step bound: the port's C is never smaller.
    # The gang's capacity check never binds on these draws, so the
    # counters agree all the same
    assert t_made[-1]._C >= j_made[-1]._C
    assert tc.get("gang_skip_capacity", 0) == 0
    assert {k: tc.get(k, 0) for k in GANG_KEYS} == {
        k: jc.get(k, 0) for k in GANG_KEYS}
    if name == "noisy" and m == 4:
        # the gang fires and a deposit is used on this draw
        assert tc["gang_groups"] > 0 and tc["run_gang_injected"] > 0
    if name == "dual" and m is None:
        assert tc["gang_groups"] > 0


@pytest.mark.parametrize("m", [2, 4, 8, None])
def test_priority_engine_width_parity(m):
    chains = _chains()

    def run(pkg, cfg):
        e = pkg.PriorityConsensusDWFA(cfg)
        for c in chains:
            e.add_sequence_chain(c)
        res = e.consensus()
        return ([[(c.sequence, list(c.scores)) for c in chain]
                 for chain in res.consensuses], list(res.sequence_indices))

    want = run(T, _port_cfg("python", 1, 2))
    assert run(T, _port_cfg("torch", m, 2)) == want
    assert run(J, _jax_cfg(m, 2)) == want


def test_frontier_gang_fuzz_1_draw():
    """``tests/test_fuzz_parity.py::test_frontier_gang_fuzz[1]``'s draw
    and width: the port at that width and at 1 equal to the oracle, and
    to JAX ``"jax"`` at that width."""
    seed = 1
    rng = np.random.default_rng(34000 + seed)
    m = int(rng.choice([2, 4, 8]))
    seq_len = int(rng.integers(120, 260))
    n = int(rng.integers(6, 10))
    er = float(rng.choice([0.02, 0.04]))
    truth, reads = generate_test(4, seq_len, n, er, seed=35000 + seed)
    reads = [bytearray(r) for r in reads]
    for pos in rng.choice(seq_len, size=2, replace=False):
        alt = (truth[pos] + 1 + int(rng.integers(3))) % 4
        for i in range(n // 2):
            if pos < len(reads[i]):
                reads[i][pos] = alt
    reads = [bytes(r) for r in reads]
    mc = int(rng.integers(2, max(3, n // 2)))
    want = _single(T, _port_cfg("python", 1, mc), reads)[0]
    assert _single(T, _port_cfg("torch", m, mc), reads)[0] == want
    assert _single(T, _port_cfg("torch", 1, mc), reads)[0] == want
    assert _single(J, _jax_cfg(m, mc), reads)[0] == want
