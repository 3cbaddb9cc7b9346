"""The three engines through the pop arena: the port's ``"torch"``
(``device="cpu"``, so the arena runs as its plain twin) against the JAX
package's ``"jax"``, byte for byte (sequences, scores, order, read
assignment), with the arena counters and the ``run_calls``,
``run_dual_calls``, ``clone_push_calls`` and frontier-gang counters equal
too (JAX's speculative-block keys ``arena_iters`` / ``arena_spec_events``
excepted, and on the near-tie draws the code-1 stop diagnostics compared
by their total: see ``_fold_diag``).  Both run at the default (adaptive)
frontier width.
Draws: ``tests/test_arena_creation.py``'s dual workload and tie-heavy
single draw (the arena must create children there, as JAX's own test
asserts), ``tests/test_vote_eps.py``'s near-tie dual draws, the
``priority_001`` fixture (every group's solve through its
``SubsetScorer`` view, no handle left live) and a dual draw with late
reads whose activation points cut the arena's step limit.
"""

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from test_torch_priority_jax import _key as _priority_key
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test
from waffle_con_tpu_torch.utils.fixtures import load_priority_fixture

SPECULATIVE_KEYS = ("arena_iters", "arena_spec_events")
OTHER_KEYS = ("run_calls", "run_dual_calls", "clone_push_calls",
              "gang_groups", "gang_members", "run_gang_injected",
              "run_gang_mispredict")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dual_workload(seq_len=200, per_hap=6, er=0.01):
    """``tests/test_arena_creation.py``'s ``_dual_workload``."""
    truth, reads1 = generate_test(4, seq_len, per_hap, er, seed=1)
    h2 = bytearray(truth)
    h2[seq_len // 3] = (h2[seq_len // 3] + 1) % 4
    h2[2 * seq_len // 3] = (h2[2 * seq_len // 3] + 2) % 4
    h2 = bytes(h2)
    reads2 = [corrupt(h2, er, np.random.default_rng(50 + i))
              for i in range(per_hap)]
    return list(reads1) + reads2


def _vote_eps_dual(seed):
    """``tests/test_vote_eps.py``'s ``_dual_case``."""
    rng = np.random.default_rng(100 + seed)
    t1 = bytes(rng.choice([65, 66], size=80).tolist())
    t2 = bytearray(t1)
    t2[30] = 65 + 66 - t2[30]
    t2[60] = 65 + 66 - t2[60]
    t2 = bytes(t2)
    reads = [corrupt(t1, 0.05, rng) for _ in range(6)]
    reads += [corrupt(t2, 0.05, rng) for _ in range(6)]
    return reads


def _key(res):
    if res and hasattr(res[0], "consensus1"):
        c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
        return [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                 list(d.scores1), list(d.scores2)) for d in res]
    return [(c.sequence, list(c.scores)) for c in res]


def _counters(eng):
    c = eng.last_search_stats["scorer_counters"]
    return {k: v for k, v in c.items()
            if (k.startswith("arena") and k not in SPECULATIVE_KEYS)
            or k in OTHER_KEYS}


def _builder(pkg, backend):
    """A config builder of ``pkg``'s ``backend``: the port on the CPU, JAX
    as it is; both at the default (adaptive) frontier width, so the
    counters include the gang's effect on which fast path takes a pop."""
    b = pkg.CdwfaConfigBuilder().backend(backend)
    return b.device("cpu") if pkg is T else b


def _fold_diag(c):
    """Counters with the code-1 stop diagnostics ``arena_s1_nc{n}_f{f}``
    folded into their total.  On fractional near-tie votes the child
    count ``n`` counts candidates whose float32 vote sums lie within an
    ulp of the threshold, where the reduction order XLA picks inside
    ``_j_arena`` and a sequential fold differ; the stop itself (code 1,
    host arbitration) and every decision are the same."""
    out = {k: v for k, v in c.items() if not k.startswith("arena_s1_")}
    out["arena_s1"] = sum(v for k, v in c.items() if k.startswith("arena_s1_"))
    return out


def _engines(engine, reads, exact_diag=True, **cfg):
    """The same search on JAX ``"jax"`` and the port's ``"torch"``;
    ``reads`` are ``(read, offset or None)`` pairs.  Returns the port's
    counters after checking results and counters equal (the code-1
    diagnostics folded into their total unless ``exact_diag``)."""
    out = []
    for pkg, backend in ((J, "jax"), (T, "torch")):
        b = _builder(pkg, backend)
        for k, v in cfg.items():
            b = getattr(b, k)(v)
        eng = getattr(pkg, engine)(b.build())
        for r, off in reads:
            if off is None:
                eng.add_sequence(r)
            else:
                eng.add_sequence_offset(r, off)
        out.append((_key(eng.consensus()), _counters(eng)))
    (want, c_jax), (got, c_torch) = out
    assert got == want
    if not exact_diag:
        c_jax, c_torch = _fold_diag(c_jax), _fold_diag(c_torch)
    assert c_torch == c_jax
    return c_torch


def test_dual_split_creates_children_as_jax():
    c = _engines("DualConsensusDWFA", [(r, None) for r in _dual_workload()],
                 min_count=3)
    assert c.get("arena_creations", 0) > 0
    assert c.get("arena_split_events", 0) > 0


def test_single_tie_heavy_creates_children_as_jax():
    _truth, reads = generate_test(4, 400, 8, 0.03, seed=3)
    c = _engines("ConsensusDWFA", [(r, None) for r in reads], min_count=2)
    assert c.get("arena_creations", 0) > 0
    assert c.get("arena_split_events", 0) > 0


@pytest.mark.parametrize("seed", [1, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_near_tie_dual_as_jax(seed, weighted):
    c = _engines("DualConsensusDWFA",
                 [(r, None) for r in _vote_eps_dual(seed)], exact_diag=False,
                 min_count=3, weighted_by_ed=weighted)
    assert c["arena_calls"] > 0


def test_late_reads_cut_the_step_limit_as_jax():
    """Reads 3 and 9 join at 20 and 25: their activation points (70 and
    75) bound every arena engagement before them."""
    reads = [(r, None) for r in _dual_workload()]
    for i, start in ((3, 20), (9, 25)):
        reads[i] = (reads[i][0][start:], start)
    c = _engines("DualConsensusDWFA", reads, min_count=3)
    assert c["arena_calls"] > 0


def test_priority_fixture_as_jax():
    chains, expected = load_priority_fixture(
        "priority_001", True, T.ConsensusCost.L1_DISTANCE)
    got = []
    for pkg, backend in ((J, "jax"), (T, "torch")):
        b = _builder(pkg, backend).wildcard(ord("*"))
        eng = pkg.PriorityConsensusDWFA(b.build())
        for chain in chains:
            eng.add_sequence_chain(chain)
        got.append((_priority_key(eng.consensus()), eng))
    (want, eng_j), (have, eng_t) = got
    assert have == want
    assert want[1] == expected.sequence_indices
    assert _counters(eng_t) == _counters(eng_j)
    groups_t = eng_t.last_search_stats["groups"]
    # the groups' solves engaged the arena through their views, and no
    # handle (the arena's scratch slots included) outlives a group
    assert sum(g["scorer_counters"].get("arena_calls", 0)
               for g in groups_t) > 0
    assert all(g["live_handles"] == 0 for g in groups_t)
