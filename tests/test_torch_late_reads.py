"""The engines on late reads and band growth: the port's ``"torch"``
(``device="cpu"``, so the offset scan and the column replay run as their
plain twins) and its ``"python"`` oracle against the JAX package's
``"jax"``, byte for byte (sequences, scores, order), on draws whose late
reads take the device offset scan (the default ``offset_window`` and
``offset_compare_length`` of 50) and whose default band grows.  The
scorer counters of late reads and band growth must equal JAX's.
"""

import numpy as np
import pytest
import torch

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from test_torch_priority_jax import _key as _priority_key
from waffle_con_tpu_torch.ops import replay_kernel
from waffle_con_tpu_torch.utils.example_gen import (
    corrupt,
    generate_priority_test,
    generate_test,
)

COUNTERS = ("activate_calls", "offset_scan_calls", "grow_e_events",
            "replayed_cols")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _late(reads, seed, cut):
    """Every 4th read (``i % 4 == 3``) cut at a start drawn from
    ``default_rng(seed).integers(*cut)``; returns ``[(read, offset or
    None)]``."""
    rng = np.random.default_rng(seed)
    out = []
    for i, r in enumerate(reads):
        if i % 4 == 3:
            s = int(rng.integers(*cut))
            out.append((r[s:], s))
        else:
            out.append((r, None))
    return out


def _engine_key(res):
    if res and hasattr(res[0], "consensus1"):
        c = lambda x: None if x is None else (x.sequence, list(x.scores))  # noqa: E731
        return [(c(d.consensus1), c(d.consensus2), list(d.is_consensus1),
                 list(d.scores1), list(d.scores2)) for d in res]
    return [(c.sequence, list(c.scores)) for c in res]


def _run(pkg, backend, engine, reads, **cfg):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T and backend == "torch":
        b = b.device("cpu")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    eng = getattr(pkg, engine)(b.build())
    for r, off in reads:
        if off is None:
            eng.add_sequence(r)
        else:
            eng.add_sequence_offset(r, off)
    return _engine_key(eng.consensus()), eng


def _counters(eng):
    c = eng.last_search_stats["scorer_counters"]
    return {k: c.get(k, 0) for k in COUNTERS}


def _check(engine, reads, **cfg):
    """JAX ``"jax"``, the port's ``"torch"`` and its ``"python"`` give the
    same results; the torch scorer's counters equal JAX's, and the plain
    twins of both new kernels ran.  Returns the result and the counters."""
    scans = replay_kernel.offset_scan_plain.calls
    replays = replay_kernel.replay_rows_plain.calls
    want, eng_j = _run(J, "jax", engine, reads, **cfg)
    got, eng_t = _run(T, "torch", engine, reads, **cfg)
    assert got == want
    assert _counters(eng_t) == _counters(eng_j)
    assert replay_kernel.offset_scan_plain.calls > scans
    assert replay_kernel.replay_rows_plain.calls > replays
    got_p, _ = _run(T, "python", engine, reads, **cfg)
    assert got_p == want
    return want, _counters(eng_t)


def test_single_late_reads_default_band():
    """24 reads x 400 bp at 2 %, every 4th cut at 100-200: six
    activations through the device scan, and the band grows."""
    truth, reads = generate_test(4, 400, 24, 0.02, seed=71)
    want, c = _check("ConsensusDWFA", _late(reads, 7, (100, 200)),
                     min_count=4)
    assert want[0][0] == truth
    assert c["activate_calls"] == c["offset_scan_calls"] == 6
    assert c["grow_e_events"] > 0


def test_dual_late_reads_both_haplotypes():
    """16 reads x 400 bp, two haplotypes 2 SNPs apart, late reads on
    both."""
    rng = np.random.default_rng(72)
    t1, reads1 = generate_test(4, 400, 8, 0.01, seed=72)
    t2 = bytearray(t1)
    for pos, shift in ((150, 1), (290, 2)):
        t2[pos] = (t2[pos] + shift) % 4
    t2 = bytes(t2)
    reads = list(reads1) + [corrupt(t2, 0.01, rng) for _ in range(8)]
    want, c = _check("DualConsensusDWFA", _late(reads, 7, (100, 200)),
                     min_count=4)
    assert {want[0][0][0], want[0][1][0]} == {t1, t2}
    assert c["activate_calls"] >= 4 and c["offset_scan_calls"] > 0
    assert c["grow_e_events"] > 0


def test_priority_seeded_late_offsets_default_window():
    """The seeded late-offset draw of ``test_torch_priority_jax.py`` at
    the default window and compare length: JAX takes its device scan for
    every level-1 activation, and so does the port's shared scorer
    through each group's ``SubsetScorer`` view."""
    truth, (t1a, t1b), chains = generate_priority_test(
        12, 300, 0.01, (15, 16, 500))
    offsets = [[None, None] for _ in chains]
    for i, start in ((2, 40), (7, 60), (9, 30)):
        hap = t1a if i < 6 else t1b
        chains[i][1] = corrupt(hap[start:], 0.01,
                               np.random.default_rng(600 + i))
        offsets[i][1] = start
    seeds = [i % 2 for i in range(12)]
    got = {}
    for pkg, be in ((J, "jax"), (T, "torch"), (T, "python")):
        b = pkg.CdwfaConfigBuilder().backend(be).min_count(2).initial_band(20)
        if pkg is T and be == "torch":
            b = b.device("cpu")
        eng = pkg.PriorityConsensusDWFA(b.build())
        for i, chain in enumerate(chains):
            eng.add_seeded_sequence_chain(chain, offsets[i], seeds[i])
        got[be] = (_priority_key(eng.consensus()),
                   None if be == "python" else _counters(eng))
    assert got["torch"] == got["jax"]
    assert got["python"][0] == got["jax"][0]
    c = got["torch"][1]
    assert c["activate_calls"] > 0
    assert c["offset_scan_calls"] == c["activate_calls"]
    assert all(chain[0][0] == truth for chain in got["jax"][0][0])
