"""The port's ``PriorityConsensusDWFA`` on ``"torch"`` (``device="cpu"``,
one ``TorchScorer`` per chain level seen through ``SubsetScorer`` views)
against the JAX package's on ``"jax"`` (one ``JaxScorer`` per level, seen
the same way), and against the port's ``"python"`` oracle: three
fixtures, and a generated draw with seeded chains and late level-1
offsets.  Per result, every chain's sequences and scores and the read
assignment must be equal exactly, and so must the number of scorers
built.  ``tests/test_torch_priority_generated.py`` holds the generated
two-level draws.
"""

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_priority_test
from waffle_con_tpu_torch.utils.fixtures import load_priority_fixture


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


def _run(pkg, backend, chains, offsets=None, seeds=None, **cfg):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T and backend == "torch":
        b = b.device("cpu")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    eng = pkg.PriorityConsensusDWFA(b.build())
    for i, chain in enumerate(chains):
        eng.add_seeded_sequence_chain(
            chain,
            [None] * len(chain) if offsets is None else offsets[i],
            None if seeds is None else seeds[i],
        )
    return _key(eng.consensus()), eng


def _check(chains, offsets=None, seeds=None, **cfg):
    """JAX ``"jax"``, the port's ``"torch"`` and its ``"python"`` oracle
    give the same result; returns it and the port's torch engine."""
    want, eng_j = _run(J, "jax", chains, offsets, seeds, **cfg)
    got, eng_t = _run(T, "torch", chains, offsets, seeds, **cfg)
    assert got == want
    got_p, _ = _run(T, "python", chains, offsets, seeds, **cfg)
    assert got_p == want
    assert (eng_t.last_search_stats["scorer_constructions"]
            == eng_j.last_search_stats["scorer_constructions"])
    return want, eng_t


@pytest.mark.parametrize(
    "name", ["priority_001", "multi_samesplit_001", "dual_001"])
def test_fixtures_match_jax_backend(name):
    chains, expected = load_priority_fixture(
        name, True, T.ConsensusCost.L1_DISTANCE)
    want, _ = _check(chains, wildcard=ord("*"))
    assert want[1] == expected.sequence_indices
    assert [[s for s, _ in chain] for chain in want[0]] == [
        [c.sequence for c in chain] for chain in expected.consensuses]


def test_seeded_late_offsets_match_jax_backend():
    """Two seed groups, each holding both level-1 haplotypes, and reads
    that join level 1 late: activation goes through the view's index
    map (local read index -> the shared scorer's)."""
    truth, (t1a, t1b), chains = generate_priority_test(
        12, 300, 0.01, (15, 16, 500))
    offsets = [[None, None] for _ in chains]
    for i, start in ((2, 40), (7, 60), (9, 30)):
        hap = t1a if i < 6 else t1b
        chains[i][1] = corrupt(hap[start:], 0.01, np.random.default_rng(600 + i))
        offsets[i][1] = start
    seeds = [i % 2 for i in range(12)]
    want, eng = _check(chains, offsets, seeds, min_count=2, initial_band=20,
                       offset_compare_length=20, offset_window=30)
    # one group per (seed, haplotype), level 0 at the truth everywhere
    assert len(want[0]) == 4
    assert all(chain[0][0] == truth for chain in want[0])
    groups = {(seeds[i], i < 6): want[1][i] for i in range(12)}
    assert sorted(groups.values()) == [0, 1, 2, 3]
    assert all(want[1][i] == groups[(seeds[i], i < 6)] for i in range(12))
    c = eng.last_search_stats["scorer_counters"]
    assert c["activate_calls"] > 0
