"""The port's ``PriorityConsensusDWFA`` against the JAX package's.

The port runs with ``backend="torch"`` on ``device="cpu"`` (one
``TorchScorer`` per chain level, seen by each worklist group through a
``SubsetScorer``; the plain run loops) and with its ``"python"`` oracle;
the JAX package with its ``"python"`` oracle.  On the twelve fixtures of
``tests/data`` and the cases of ``tests/test_priority.py``, every chain's
sequences and scores and the read assignment must be equal exactly.  The
engine's bookkeeping is held too: per-search counter deltas that sum to
the shared scorers' totals, no branch handle left behind by a group, and
a level's scorer freed as soon as it is evicted; and the port's fixture
loaders read what the JAX package's read.
"""

import gc
import weakref

import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.models.consensus import EngineError as JaxEngineError
from waffle_con_tpu_torch.models import priority_consensus
from waffle_con_tpu_torch.models.consensus import EngineError
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import generate_test
from waffle_con_tpu.utils.fixtures import (
    load_dual_fixture as jax_load_dual_fixture,
)
from waffle_con_tpu_torch.utils.fixtures import (
    PRIORITY_SCENARIOS,
    load_dual_fixture,
    load_priority_fixture,
)



@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors: the test
    workers share the host's cores, and torch's default of one thread
    per core makes them wait on each other many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key(res):
    return (
        [[(c.sequence, list(c.scores)) for c in chain]
         for chain in res.consensuses],
        list(res.sequence_indices),
    )


def _config(pkg, backend, **cfg):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T and backend == "torch":
        b = b.device("cpu")
    for k, v in cfg.items():
        if k == "consensus_cost":
            v = pkg.ConsensusCost(v.value)
        b = getattr(b, k)(v)
    return b.build()


def _run(pkg, backend, chains, seeds=None, **cfg):
    eng = pkg.PriorityConsensusDWFA(_config(pkg, backend, **cfg))
    for i, chain in enumerate(chains):
        if seeds is None:
            eng.add_sequence_chain(chain)
        else:
            eng.add_seeded_sequence_chain(chain, [None] * len(chain), seeds[i])
    return _key(eng.consensus()), eng


def _check(chains, seeds=None, **cfg):
    """The port's ``"torch"`` and ``"python"`` give the JAX package's
    ``"python"`` result; returns it and the port's engines by backend."""
    want, _ = _run(J, "python", chains, seeds, **cfg)
    engines = {}
    for backend in ("torch", "python"):
        got, engines[backend] = _run(T, backend, chains, seeds, **cfg)
        assert got == want, backend
    return want, engines


@pytest.mark.parametrize(
    "name,include,cfg", PRIORITY_SCENARIOS,
    ids=[s[0] for s in PRIORITY_SCENARIOS])
def test_fixtures(name, include, cfg):
    cfg = dict(cfg, wildcard=ord("*"))
    chains, expected = load_priority_fixture(
        name, include, cfg.get("consensus_cost", T.ConsensusCost.L1_DISTANCE))
    want, engines = _check(chains, **cfg)
    assert want[1] == expected.sequence_indices
    assert [[s for s, _ in chain] for chain in want[0]] == [
        [c.sequence for c in chain] for chain in expected.consensuses]
    assert len(engines["torch"].alphabet) == 4
    # the oracle builds one scorer per group, the torch backend one per
    # level visit (a level evicted and reached again is built again)
    st_p = engines["python"].last_search_stats
    st_t = engines["torch"].last_search_stats
    assert st_p["scorer_constructions"] == len(st_p["groups"])
    assert st_t["groups"] == [
        dict(g, scorer_counters=g_t["scorer_counters"], live_handles=0)
        for g, g_t in zip(st_p["groups"], st_t["groups"])
    ]
    assert 1 <= st_t["scorer_constructions"] <= len(st_t["groups"])


@pytest.mark.parametrize("name,include,cost", [
    ("dual_001", True, "L1_DISTANCE"),
    ("dual_early_termination_001", True, "L1_DISTANCE"),
    ("length_gap_001", False, "L2_DISTANCE"),
])
def test_dual_fixture_loader_matches_jax(name, include, cost):
    got_reads, got = load_dual_fixture(name, include, T.ConsensusCost[cost])
    want_reads, want = jax_load_dual_fixture(
        name, include, J.ConsensusCost[cost])
    assert got_reads == want_reads
    cons = lambda c: None if c is None else (c.sequence, c.scores)  # noqa: E731
    assert (cons(got.consensus1), cons(got.consensus2), got.is_consensus1) == (
        cons(want.consensus1), cons(want.consensus2), want.is_consensus1)


def test_single_sequence():
    sequence = b"ACGTACGTACGT"
    want, engines = _check([[sequence, sequence]])
    assert want == ([[(sequence, [0])] * 2], [0])
    assert engines["torch"].consensus() == T.PriorityConsensus(
        [[T.Consensus(sequence, T.ConsensusCost.L1_DISTANCE, [0])] * 2], [0])


def test_doc_example():
    chains = (
        [[b"TCCGT", b"TCCGT"]] * 3
        + [[b"TCCGT", b"ACGGT"]] * 3
        + [[b"ACGT", b"ACCCGGTT"]] * 3
    )
    want, _ = _check(chains)
    assert want == (
        [
            [(b"ACGT", [0] * 3), (b"ACCCGGTT", [0] * 3)],
            [(b"TCCGT", [0] * 6), (b"ACGGT", [0] * 3)],
            [(b"TCCGT", [0] * 6), (b"TCCGT", [0] * 3)],
        ],
        [2, 2, 2, 1, 1, 1, 0, 0, 0],
    )


def test_chain_length_mismatch():
    for pkg, err in ((J, JaxEngineError), (T, EngineError)):
        engine = pkg.PriorityConsensusDWFA(_config(pkg, "python"))
        engine.add_sequence_chain([b"ACGT", b"ACGT"])
        with pytest.raises(err) as exc:
            engine.add_sequence_chain([b"ACGT"])
        assert str(exc.value) == (
            "Expected sequences Vec of length 2, but got one of length 1")
        with pytest.raises(err) as exc:
            engine.add_sequence_chain([])
        assert str(exc.value) == "Must provide a non-empty sequences Vec"


def test_seeded_groups():
    # seeds force an initial partition even when sequences agree
    want, engines = _check([[b"ACGTACGT"]] * 6, seeds=[i % 2 for i in range(6)])
    assert len(want[0]) == 2
    assert all(chain[0][0] == b"ACGTACGT" for chain in want[0])
    # one group per seed, solved from the last seed's group first
    groups = engines["torch"].last_search_stats["groups"]
    assert [(g["level"], g["size"]) for g in groups] == [(0, 3), (0, 3)]


def test_multiconsensus_sort():
    cost = T.ConsensusCost.L1_DISTANCE
    consensuses = [T.Consensus(s, cost, [0]) for s in (b"ACGT", b"TGCA", b"AAAA")]
    multicon = T.MultiConsensus(consensuses, [2, 0, 1])
    assert multicon.consensuses == [
        T.Consensus(s, cost, [0]) for s in (b"AAAA", b"ACGT", b"TGCA")]
    assert multicon.sequence_indices == [0, 1, 2]
    jcost = J.ConsensusCost.L1_DISTANCE
    want = J.MultiConsensus(
        [J.Consensus(s, jcost, [0]) for s in (b"ACGT", b"TGCA", b"AAAA")],
        [2, 0, 1])
    assert [c.sequence for c in multicon.consensuses] == [
        c.sequence for c in want.consensuses]
    assert multicon.sequence_indices == want.sequence_indices


def _record_bases(monkeypatch):
    """Every scorer the priority engine builds, in order."""
    built = []
    make = priority_consensus.make_scorer

    def recording(reads, config):
        built.append(make(reads, config))
        return built[-1]

    monkeypatch.setattr(priority_consensus, "make_scorer", recording)
    return built


def test_group_counter_deltas_sum_to_shared_totals(monkeypatch):
    """Each group reports its own search's counters, not the shared
    scorer's running total: the groups' deltas sum to the totals of the
    scorers built (a level evicted and reached again is built again)."""
    chains, _ = load_priority_fixture(
        "priority_001", True, T.ConsensusCost.L1_DISTANCE)
    built = _record_bases(monkeypatch)
    _, eng = _run(T, "torch", chains, wildcard=ord("*"))
    st = eng.last_search_stats
    assert st["scorer_constructions"] == len(built) == 3
    totals = {}
    for sc in built:
        for k, v in sc.counters.items():
            totals[k] = totals.get(k, 0) + v
    summed = {}
    for g in st["groups"]:
        for k, v in g["scorer_counters"].items():
            assert v >= 0, k
            summed[k] = summed.get(k, 0) + v
    assert summed == st["scorer_counters"] == totals
    assert totals["run_calls"] + totals["run_dual_calls"] > 0


def test_dual_engine_reports_the_search_delta():
    """Two dual searches over one injected scorer: each reports what its
    own search dispatched (a band wide enough not to grow, so both
    searches dispatch the same)."""
    truth, reads = generate_test(4, 80, 6, 0.02, seed=8)
    reads = reads + [bytes(b ^ 1 for b in truth)] * 4
    cfg = _config(T, "torch", min_count=2, initial_band=64)
    shared = TorchScorer(reads, cfg)
    seen = []
    for _ in range(2):
        eng = T.DualConsensusDWFA(cfg, scorer=shared)
        for r in reads:
            eng.add_sequence(r)
        eng.consensus()
        seen.append(eng.last_search_stats["scorer_counters"])
    alone = T.DualConsensusDWFA(cfg)
    for r in reads:
        alone.add_sequence(r)
    alone.consensus()
    assert seen[0] == seen[1] == alone.last_search_stats["scorer_counters"]
    assert shared.counters == {k: 2 * v for k, v in seen[0].items()}
    assert seen[0]["run_dual_calls"] + seen[0]["arena_calls"] > 0


def test_injected_scorer_must_hold_the_added_reads():
    cfg = _config(T, "torch")
    eng = T.DualConsensusDWFA(cfg, scorer=TorchScorer([b"ACGT", b"ACGA"], cfg))
    eng.add_sequence(b"ACGT")
    with pytest.raises(EngineError, match="injected scorer reads"):
        eng.consensus()


def test_level_scorer_freed_on_eviction(monkeypatch):
    """With the cycle collector off, level 0's scorer is gone before the
    level-1 group is solved, and level 1's once the worklist is done:
    the dual engine's cached fast paths hold the base scorer and the
    index map, never the view, so no reference cycle keeps a base (and
    on a card its device tensors) alive."""
    truth, reads = generate_test(4, 60, 6, 0.0, seed=3)
    chains = [[r, r[::-1]] for r in reads]
    refs = []
    make = priority_consensus.make_scorer

    def weak(reads, config):
        sc = make(reads, config)
        refs.append(weakref.ref(sc))
        return sc

    alive = []
    solve = T.DualConsensusDWFA.consensus

    def spying(self):
        alive.append([r() is not None for r in refs])
        return solve(self)

    monkeypatch.setattr(priority_consensus, "make_scorer", weak)
    monkeypatch.setattr(T.DualConsensusDWFA, "consensus", spying)
    gc.collect()
    gc.disable()
    try:
        _, eng = _run(T, "torch", chains)
    finally:
        gc.enable()
    assert [g["level"] for g in eng.last_search_stats["groups"]] == [0, 1]
    assert alive == [[True], [False, True]]
    assert [r() for r in refs] == [None, None]
