"""The run paths of the port's read-sharded store
(``waffle_con_tpu_torch/ops/sharded_scorer.py``): ``run_extend``,
``run_extend_dual`` and ``run_arena``.

On ``"cpu"`` shards each call takes its plain version
(``run_kernel.run_extend_shards_plain`` and kin: the shards' slots
gathered into one store, the unsharded plain loop, the result split
back).  The same calls on 2, 4 and 8 shards and on the unsharded
``TorchScorer`` over the same reads: every output, and after every call
every shard's store gathered in read order, equal with tolerance 0.  The
scenarios: a plain run, reads at different offsets (late reads), a band
overflow that grows the band (code 5), a step cap (code 4), a dual node,
and arena calls with a competitor and with child creation, on a band
that overflows.  Then the three paths at 8 shards against the JAX
package's ``JaxScorer`` sharded over the suite's 8 XLA devices
(``mesh_shards=8``, the XLA loops ``_j_run``, ``_j_run_dual`` and
``_j_arena`` under GSPMD), through the scorers' public methods.  Then
where the shards are (:func:`sharded_scorer.placement`, a pure function):
one card fuses, the CPU takes the plain versions, two cards are refused
by every planner and counted as ``plan_refused_cross_card``; the store
offers no gang; a sharded search on the CPU runs the sharded run.
"""

import jax
import numpy as np
import pytest
import torch

import waffle_con_tpu_torch as T
from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu.parallel import shard_for_config as jshard_for_config
from waffle_con_tpu.utils.example_gen import corrupt, generate_test
from waffle_con_tpu_torch.ops import (
    arena_kernel,
    run_dual_kernel,
    run_kernel,
    sharded_scorer,
)
from waffle_con_tpu_torch.ops.sharded_scorer import ShardedScorer, placement
from waffle_con_tpu_torch.ops.state_io import gather_state, state_to_numpy
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.parallel import DeviceSet, use_device_set

BIG = 2**31 - 1
#: tracker windows and imbalance table of the arena calls (one JAX
#: compile for every scenario)
LW = 1024
IMB_LEN = 1024


def needs_devices(n):
    return pytest.mark.skipif(
        len(jax.devices()) < n, reason=f"needs {n} XLA devices"
    )


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- draws


def _two_haplotypes():
    """6 reads of one haplotype at 1 % and 6 of a second 2 SNPs away (at
    66 and 133): ``(truth, second, reads)``."""
    truth, reads1 = generate_test(4, 200, 6, 0.01, seed=1)
    h2 = bytearray(truth)
    h2[66] = (h2[66] + 1) % 4
    h2[133] = (h2[133] + 2) % 4
    h2 = bytes(h2)
    reads2 = [corrupt(h2, 0.01, np.random.default_rng(50 + i))
              for i in range(6)]
    return truth, h2, list(reads1) + reads2


def _deletion():
    """The first haplotype's 6 reads twice and 3 of them missing 12 bases
    at 30: the run's band of E=8 overflows there."""
    truth, reads1 = generate_test(4, 200, 6, 0.01, seed=1)
    reads = list(reads1) * 2 + [r[:30] + r[42:] for r in reads1[:3]]
    return truth, reads


def _late():
    """The two haplotypes with reads 3 and 9 cut to start at 20 and 25."""
    truth, h2, reads = _two_haplotypes()
    reads[3] = reads[3][20:]
    reads[9] = reads[9][25:]
    return truth, h2, reads


# ----------------------------------------------------------- scorers


def _torch_cfg(min_count):
    return (T.CdwfaConfigBuilder().backend("torch").device("cpu")
            .min_count(min_count).build())


def _store(reads, shards, min_count=3):
    """``shards`` co-resident ``"cpu"`` shards (0: the unsharded store)."""
    if shards == 0:
        return TorchScorer(reads, _torch_cfg(min_count))
    return ShardedScorer(reads, _torch_cfg(min_count), ["cpu"] * shards)


def _jax_store(reads, min_count=3):
    cfg = (JaxConfigBuilder().backend("jax").min_count(min_count)
           .mesh_shards(8).build())
    sc = JaxScorer(reads, cfg)
    jshard_for_config(sc, cfg)
    assert sc._shardings is not None
    return sc


def _state(sc):
    """A copy of a scorer's store in read order (the shards' gathered)."""
    if isinstance(sc, ShardedScorer):
        st = gather_state([sh._state for sh in sc.shards])
    else:
        st = state_to_numpy(sc._state)
    return {k: np.array(v) for k, v in st.items()}


# ------------------------------------------------------- the calls


def _stats(st):
    if st is None:
        return None
    return (st.eds.tolist(), st.occ.tolist(), st.split.tolist(),
            np.asarray(st.reached, bool).tolist(),
            None if st.fin is None else st.fin.tolist())


def _node(sc, cons, late=()):
    """A branch rooted on every read but ``late`` (``(read, offset)``
    pairs, activated at its end) and advanced through ``cons`` by runs,
    each forced to ``cons``'s next symbol (where the votes stop a run)
    and capped at its end."""
    act = np.ones(sc.num_reads, dtype=bool)
    for r, _o in late:
        act[r] = False
    h = sc.root(act)
    _advance(sc, h, b"", cons)
    for r, o in late:
        sc.activate(h, r, o, cons)
    return h


def _advance(sc, h, have, cons):
    """Branch ``h`` at ``have`` advanced through the rest of ``cons`` by
    forced, capped runs."""
    while len(have) < len(cons):
        _s, _c, app, _st, _r = sc.run_extend(
            h, have, BIG, BIG, 0, 3, False, len(cons) - len(have) - 1,
            first_sym=sc.sym_id[cons[len(have)]])
        have += app
        assert cons.startswith(have)


def _nodes(sc, conses):
    """A branch a consensus (every read active), each cloned from the
    longest one built before it that it extends, shortest first."""
    built = {}
    for cons in sorted(set(conses), key=len):
        base = max((c for c in built if cons.startswith(c)), key=len,
                   default=None)
        if base is None:
            h = sc.root(np.ones(sc.num_reads, dtype=bool))
            _advance(sc, h, b"", cons)
        else:
            h = sc.clone(built[base])
            _advance(sc, h, base, cons)
        built[cons] = h
    return built


def _run(sc, h, cons, max_steps=250, min_count=3):
    steps, code, app, st, records = sc.run_extend(
        h, cons, BIG, BIG, 0, min_count, False, max_steps)
    recs = [(s, f.tolist()) for s, f in records]
    return (steps, code, app, _stats(st), recs), cons + app


def _dual(sc, h1, h2, c1, c2, min_count=3):
    (steps, code, a1, a2, st1, st2, act1, act2, records) = sc.run_extend_dual(
        h1, h2, c1, c2, BIG, BIG, 0, min_count, 5, 2, False, False, 250)
    recs = [(s, f1.tolist(), f2.tolist(), np.asarray(x1, bool).tolist(),
             np.asarray(x2, bool).tolist())
            for s, f1, f2, x1, x2 in records]
    return (steps, code, a1, a2, _stats(st1), _stats(st2),
            np.asarray(act1, bool).tolist(), np.asarray(act2, bool).tolist(),
            recs), c1 + a1, c2 + a2


def _arena(sc, nodes, min_count=3, step_limit=512, create_mode=2):
    """One ``run_arena`` over ``nodes`` (``[(side-1 consensus, side-2
    consensus or None)]``, each a distinct consensus), node 0 the
    in-hand pop: the dump and the stats of every returned handle
    afterwards."""
    specs, hands = [], []
    lc = np.zeros((2, LW), np.int32)
    made = _nodes(sc, [c for c1, c2 in nodes for c in (c1, c2)
                       if c is not None])
    for i, (c1, c2) in enumerate(nodes):
        h1 = made[c1]
        h2 = None if c2 is None else made[c2]
        specs.append((h1, h2, len(c1), 0 if c2 is None else len(c2)))
        hands.append((h1, c1))
        if h2 is not None:
            hands.append((h2, c2))
        if i:
            lc[int(c2 is not None), max(len(c1), len(c2 or b""))] += 1
    far = max(max(s[2], s[3]) for s in specs)
    tr = np.array([[0, lc[0].sum(), far, 0], [0, lc[1].sum(), far, 0]],
                  np.int32)
    out = sc.run_arena(
        specs, BIG, min_count, 20, 0, False, False, BIG, 0, 1000, 1000,
        step_limit, 1000, lc, np.zeros((2, LW), np.int32), tr,
        create_mode=create_mode,
        mc_tab=np.full(sc.num_reads + 1, min_count, np.int32),
        imb_tab=np.zeros(IMB_LEN, np.int32))
    (events, nsteps, code, stop_node, node_steps, appended, stats, acts,
     alive, creations) = out
    for cre in creations:
        hands.append((cre["h1"], b""))
        if cre["h2"] is not None:
            hands.append((cre["h2"], b""))
    return dict(
        events=events, nsteps=nsteps, code=code, stop_node=stop_node,
        node_steps=node_steps, appended=appended,
        stats=[_stats(s) for s in stats],
        act=[None if a is None else np.asarray(a, bool).tolist()
             for a in acts],
        alive=alive,
        creations=[{k: v for k, v in c.items() if k not in ("h1", "h2")}
                   for c in creations],
        after=[_stats(sc.stats(h, c)) for h, c in hands if h in sc._slot_of],
    )


# --------------------------------------------------------- scenarios
# each drives a store through the same public calls and returns what it
# saw; ``check(sc)`` runs after every call a scenario makes


def _scenario_run(sc, check):
    truth, _h2, _reads = _two_haplotypes()
    h = sc.root(np.ones(sc.num_reads, bool))
    out, cons = _run(sc, h, b"")
    check(sc)
    # the run stopped at the first SNP: push the truth's symbol, go on
    sc.push(h, truth[: len(cons) + 1])
    out2, _ = _run(sc, h, truth[: len(cons) + 1])
    check(sc)
    return [out, out2]


def _scenario_late(sc, check):
    truth, _h2, _reads = _late()
    h = _node(sc, truth[:30], late=((3, 20), (9, 25)))
    check(sc)
    out, _ = _run(sc, h, truth[:30])
    check(sc)
    return [out]


def _scenario_overflow(sc, check):
    truth, _reads = _deletion()
    h = sc.root(np.ones(sc.num_reads, bool))
    outs, cons = [], b""
    for _ in range(3):
        out, cons = _run(sc, h, cons, min_count=4)
        check(sc)
        outs.append(out)
        if out[1] != 5:
            break
    assert outs[0][1] == 5 and sc._E > 8
    return outs + [sc._E]


def _scenario_step_cap(sc, check):
    h = sc.root(np.ones(sc.num_reads, bool))
    out, cons = _run(sc, h, b"", max_steps=7)
    check(sc)
    out2, _ = _run(sc, h, cons, max_steps=7)
    check(sc)
    assert out[1] == out2[1] == 4 and out[0] == 7
    return [out, out2]


def _scenario_dual(sc, check):
    truth, h2, _reads = _two_haplotypes()
    ha, hb = _node(sc, truth[:70]), _node(sc, h2[:70])
    out, c1, c2 = _dual(sc, ha, hb, truth[:70], h2[:70])
    check(sc)
    assert out[0] > 0
    return [out, _stats(sc.stats(ha, c1)), _stats(sc.stats(hb, c2))]


def _scenario_arena(sc, check):
    truth, h2, _reads = _two_haplotypes()
    got = [_arena(sc, [(truth[:20], None), (truth[:19], None)],
                  step_limit=12)]
    check(sc)
    got.append(_arena(sc, [(truth[:60], None), (truth[:59], None)],
                      step_limit=40))
    check(sc)
    got.append(_arena(sc, [(truth[:80], h2[:80]), (truth[:79], h2[:79])], step_limit=40))
    check(sc)
    assert got[0]["code"] == 4 and got[1]["creations"]
    return got


def _scenario_arena_overflow(sc, check):
    truth, _reads = _deletion()
    got = _arena(sc, [(truth[:20], None), (truth[:19], None)],
                 min_count=4)
    check(sc)
    assert got["code"] == 5 and sc._E > 8
    return [got]


#: name -> (scenario, reads)
SCENARIOS = {
    "run": (_scenario_run, lambda: _two_haplotypes()[2]),
    "late": (_scenario_late, lambda: _late()[2]),
    "overflow": (_scenario_overflow, lambda: _deletion()[1]),
    "step_cap": (_scenario_step_cap, lambda: _two_haplotypes()[2]),
    "dual": (_scenario_dual, lambda: _two_haplotypes()[2]),
    "arena": (_scenario_arena, lambda: _two_haplotypes()[2]),
    "arena_overflow": (_scenario_arena_overflow, lambda: _deletion()[1]),
}

_UNSHARDED = {}


def _unsharded(name):
    """The unsharded store's outputs and its store after each call (made
    once a scenario)."""
    if name not in _UNSHARDED:
        scenario, reads = SCENARIOS[name]
        states = []
        sc = _store(reads(), 0)
        outs = scenario(sc, lambda s: states.append(_state(s)))
        _UNSHARDED[name] = (outs, states, dict(sc.counters))
    return _UNSHARDED[name]


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_sharded_run_paths_match_the_unsharded_store(name, shards):
    """Every output and, after every call, every shard's store equal to
    the unsharded store's, tolerance 0; the calls went through the
    sharded plain versions, never a planner refusal."""
    want, want_states, want_counters = _unsharded(name)
    scenario, reads = SCENARIOS[name]
    sc = _store(reads(), shards)
    assert sc.placement == "plain"
    before = (run_kernel.run_extend_shards_plain.calls
              + run_dual_kernel.run_extend_dual_shards_plain.calls
              + arena_kernel.arena_shards_plain.calls)
    seen = []

    def check(s):
        got = _state(s)
        ref = want_states[len(seen)]
        for field in ref:
            np.testing.assert_array_equal(got[field], ref[field],
                                          err_msg=f"{name} call "
                                          f"{len(seen)}: {field}")
        seen.append(True)

    assert scenario(sc, check) == want
    assert len(seen) == len(want_states)
    calls = (run_kernel.run_extend_shards_plain.calls
             + run_dual_kernel.run_extend_dual_shards_plain.calls
             + arena_kernel.arena_shards_plain.calls) - before
    assert calls > 0
    for key in ("run_calls", "run_steps", "run_dual_calls", "arena_calls",
                "grow_e_events"):
        assert sc.counters.get(key, 0) == want_counters.get(key, 0), key
    assert not any(k.startswith("plan_refused") for k in sc.counters)
    assert sc.counters["shard_overflow_rollbacks"] == 0


# ------------------------------------------------- against JAX's mesh

#: the scenarios held to JAX's 8-shard scorer (one compile of each loop)
JAX_SCENARIOS = ("run", "dual", "arena")


@needs_devices(8)
@pytest.mark.parametrize("name", JAX_SCENARIOS)
def test_eight_shards_match_jax_mesh_scorer(name):
    """``ShardedScorer`` on 8 ``"cpu"`` shards against ``JaxScorer``
    sharded over 8 XLA devices: every output of the same public calls,
    tolerance 0."""
    scenario, reads = SCENARIOS[name]
    data = reads()
    want = scenario(_jax_store(data), lambda s: None)
    got = scenario(_store(data, 8), lambda s: None)
    assert got == want


# -------------------------------------------------- where the shards are


@pytest.mark.parametrize("devices,where", [
    (("cuda:0",) * 4, "fused"),
    (("cuda:0",), "fused"),
    (("cpu",) * 8, "plain"),
    (("cuda:0", "cuda:1"), "cross_card"),
    (("cuda:0", "cuda:1", "cuda:0", "cuda:1"), "cross_card"),
    (("cpu", "cuda:0"), "cross_card"),
])
def test_placement_of_the_shards(devices, where):
    assert placement(devices) == where


def test_cross_card_shards_are_refused_by_every_planner(monkeypatch):
    """Shards placed on two cards: each planner refuses, each refusal
    counted as ``plan_refused_cross_card`` and as no shape refusal; the
    search takes the expand path and its result is the unsharded one."""
    monkeypatch.setattr(sharded_scorer, "placement",
                        lambda devices: "cross_card")
    _t, reads = generate_test(4, 100, 8, 0.02, seed=5)
    reads = list(reads)
    sc = _store(reads, 2)
    assert not sc.run_takes()
    assert not sc.run_dual_takes()
    assert not sc.arena_takes(LW)
    assert sc.counters["plan_refused_cross_card"] == 3
    assert not any(k.startswith("plan_refused") and k.endswith(
        ("_run", "_run_dual", "_arena")) for k in sc.counters)
    want, _ = _search(reads, 0)
    got, c = _search(reads, 2)
    assert got == want
    assert c["plan_refused_cross_card"] > 0
    assert c["run_calls"] == c["arena_calls"] == 0


def test_the_sharded_store_joins_no_gang():
    _t, _h2, reads = _two_haplotypes()
    sc = _store(reads, 4)
    h = sc.root(np.ones(sc.num_reads, bool))
    assert sc.ragged_run_probe(h) is None
    unsharded = _store(reads, 0)
    h = unsharded.root(np.ones(unsharded.num_reads, bool))
    assert unsharded.ragged_run_probe(h) == (unsharded, h)


def _search(reads, shards):
    b = T.CdwfaConfigBuilder().backend("torch").device("cpu").min_count(3)
    if shards:
        b = b.mesh_shards(shards)
    eng = T.ConsensusDWFA(b.build())
    for r in reads:
        eng.add_sequence(r)
    with use_device_set(DeviceSet("cpu", ("cpu",) * max(shards, 1))):
        res = eng.consensus()
    return ([(c.sequence, list(c.scores)) for c in res],
            eng.last_search_stats["scorer_counters"])


def test_sharded_search_runs_the_sharded_run():
    """A single search on 4 ``"cpu"`` shards pins the path: the sharded
    run's plain version runs, and the result is the unsharded search's."""
    truth, _reads = generate_test(4, 150, 8, 0.02, seed=5)
    reads = list(_reads)
    before = run_kernel.run_extend_shards_plain.calls
    got, c = _search(reads, 4)
    assert run_kernel.run_extend_shards_plain.calls > before
    assert c["run_calls"] > 0
    assert got == _search(reads, 0)[0]
    assert got[0][0] == truth
