"""The port's ``DualConsensusDWFA`` against the JAX package's on
generated two-haplotype draws (16 reads x 160 bp, 2 SNPs), under the
default configuration and under L2, ``weighted_by_ed``, ``min_af`` (the
dynamic ``mc_tab`` / ``imb_tab`` tables) and a wildcard.  Same bar as
``tests/test_torch_dual_consensus.py``: per result, both sequences and
score vectors and the read assignment, exactly.
"""

import numpy as np
import pytest

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from test_torch_dual_consensus import BACKENDS, _check, _run
from waffle_con_tpu.utils.example_gen import corrupt, generate_test


def _two_haplotypes(seed, err):
    """16 reads x 160 bp: 8 of one haplotype, 8 of a second that differs
    at 2 SNPs (tests/test_pallas_run.py's engine draw, doubled)."""
    t1, reads1 = generate_test(4, 160, 8, err, seed=seed)
    t2 = bytearray(t1)
    t2[40] = (t2[40] + 1) % 4
    t2[120] = (t2[120] + 2) % 4
    rng = np.random.default_rng(seed + 1)
    return t1, bytes(t2), list(reads1) + [
        corrupt(bytes(t2), err, rng) for _ in range(8)
    ]


@pytest.mark.parametrize("seed,err", [(51, 0.01), (53, 0.02)])
def test_generated_two_haplotypes(seed, err):
    t1, t2, reads = _two_haplotypes(seed, err)
    want, eng = _check(reads, min_count=2)
    assert {want[0][0][0], want[0][1][0]} == {t1, t2}
    # a device fast path for dual nodes ran: the dual run kernel, or the
    # pop arena, which takes the pops that have queue competitors
    c = eng.last_search_stats["scorer_counters"]
    assert c["run_dual_calls"] + c["arena_calls"] >= 1


@pytest.mark.parametrize("cfg", [
    dict(consensus_cost="l2"),
    dict(weighted_by_ed=True),
    dict(min_af=0.25),
    dict(wildcard=ord("*")),
], ids=["l2", "weighted", "min_af", "wildcard"])
def test_generated_config_variants(cfg):
    t1, t2, reads = _two_haplotypes(55, 0.015)
    if "wildcard" in cfg:
        rng = np.random.default_rng(56)
        starred = []
        for r in reads:
            arr = bytearray(r)
            for pos in rng.choice(len(arr), size=len(arr) // 20, replace=False):
                arr[pos] = ord("*")
            starred.append(bytes(arr))
        reads = starred
    cfg_j, cfg_t = dict(cfg, min_count=2), dict(cfg, min_count=2)
    if cfg.get("consensus_cost") == "l2":
        cfg_j["consensus_cost"] = J.ConsensusCost.L2_DISTANCE
        cfg_t["consensus_cost"] = T.ConsensusCost.L2_DISTANCE
    for jb, tb in BACKENDS:
        want, _ = _run(J, jb, reads, **cfg_j)
        got, eng = _run(T, tb, reads, **cfg_t)
        assert got == want, (jb, tb)
    assert want[0][1] is not None
