"""The port's C++ engine suite (``waffle_con_tpu_torch/native/``) against
the JAX package's (``waffle_con_tpu/native/``), on the CPU.

The C++ source is a byte-for-byte copy, built into the port's own
library.  Held here: ``native_wfa_ed`` on seeded pairs; ``NativeScorer``
against the port's ``PythonScorer`` call by call; the port's single,
dual and priority engines with ``backend("native")`` against JAX's
``"native"``; and ``native_consensus`` / ``native_dual_consensus`` /
``native_priority_consensus`` against the JAX functions on the fixtures
and draws of ``tests/test_native_engines.py`` and ``tests/test_native.py``,
the coverage-gap error text included.  Every comparison is byte for
byte: sequences, scores, order, read assignment and group indices.
"""

import filecmp
import os

import numpy as np
import pytest

import waffle_con_tpu as J
import waffle_con_tpu.native as JN
import waffle_con_tpu_torch as T
import waffle_con_tpu_torch.native as TN
from waffle_con_tpu.utils import fixtures as jfix
from waffle_con_tpu_torch.models.consensus import EngineError
from waffle_con_tpu_torch.ops.alignment import wfa_ed_config
from waffle_con_tpu_torch.ops.scorer import PythonScorer
from waffle_con_tpu_torch.utils import fixtures as tfix
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfg(pkg, **kw):
    b = pkg.CdwfaConfigBuilder()
    for k, v in kw.items():
        if k == "consensus_cost":
            v = getattr(pkg.ConsensusCost, v)
        b = getattr(b, k)(v)
    return b.build()


def _cons(c):
    return None if c is None else (c.sequence, c.consensus_cost.value,
                                   list(c.scores))


def _key(res):
    """A result of any engine or native entry as plain data."""
    if hasattr(res, "sequence_indices"):
        return ([[_cons(c) for c in chain] for chain in res.consensuses],
                list(res.sequence_indices))
    if res and hasattr(res[0], "consensus1"):
        return [(_cons(d.consensus1), _cons(d.consensus2),
                 list(d.is_consensus1), list(d.scores1), list(d.scores2))
                for d in res]
    if res and isinstance(res[0], tuple):
        return [(s, list(sc)) for s, sc in res]
    return [_cons(c) for c in res]


def test_source_is_the_jax_packages_byte_for_byte():
    assert filecmp.cmp(
        os.path.join(REPO, "waffle_con_tpu_torch/native/src/waffle_native.cpp"),
        os.path.join(REPO, "waffle_con_tpu/native/src/waffle_native.cpp"),
        shallow=False,
    )


def test_library_is_the_ports_own():
    path = TN.library_path()
    assert path.parent == TN.BUILD_DIR
    assert "waffle_con_tpu_torch" in str(path)
    assert TN.load_library()._name == str(path)
    assert path.exists()


@pytest.mark.parametrize("wildcard", [None, 2])
@pytest.mark.parametrize("both", [True, False])
def test_wfa_ed(both, wildcard):
    rng = np.random.default_rng(21)
    for _ in range(40):
        a = bytes(rng.integers(0, 4, size=rng.integers(0, 40)))
        b = bytes(rng.integers(0, 4, size=rng.integers(0, 40)))
        got = TN.native_wfa_ed(a, b, both, wildcard)
        assert got == JN.native_wfa_ed(a, b, both, wildcard)
        assert got == wfa_ed_config(a, b, both, wildcard)


def _compare(a, b):
    np.testing.assert_array_equal(a.eds, b.eds)
    np.testing.assert_array_equal(a.occ, b.occ)
    np.testing.assert_array_equal(a.split, b.split)
    np.testing.assert_array_equal(a.reached, b.reached)


@pytest.mark.parametrize("seed,wildcard,early", [
    (22, None, False), (23, ord("N"), False), (24, None, True),
])
def test_scorer_call_by_call(seed, wildcard, early):
    """Root (one read inactive), push, stats, clone, a late activation,
    a deactivation and ``finalized_eds`` on both branches, through the
    port's ``NativeScorer`` and its ``PythonScorer``."""
    rng = np.random.default_rng(seed)
    syms = b"ACGT" + (b"N" if wildcard else b"")
    reads = [bytes(rng.choice(list(syms), size=int(rng.integers(10, 40))))
             for _ in range(6)]
    config = _cfg(T, wildcard=wildcard, allow_early_termination=early)
    py, nt = PythonScorer(reads, config), TN.NativeScorer(reads, config)
    active = np.array([True] * 5 + [False])
    hp, hn = py.root(active), nt.root(active)
    consensus = b""
    branches = []
    for step in range(30):
        sp = py.stats(hp, consensus)
        _compare(sp, nt.stats(hn, consensus))
        if step % 5 == 4:
            sym = int(rng.choice(list(b"ACGT")))
        else:
            sym = int(py.symtab[int(np.argmax(sp.occ.sum(axis=0)))])
        consensus += bytes([sym])
        _compare(py.push(hp, consensus), nt.push(hn, consensus))
        if step == 8:
            py.activate(hp, 5, 3, consensus)
            nt.activate(hn, 5, 3, consensus)
        if step == 12:
            branches.append((py.clone(hp), nt.clone(hn), consensus))
        if step == 20:
            py.deactivate(hp, 1)
            nt.deactivate(hn, 1)
    np.testing.assert_array_equal(
        py.finalized_eds(hp, consensus), nt.finalized_eds(hn, consensus))
    cp, cn, cons = branches[0]
    _compare(py.stats(cp, cons), nt.stats(cn, cons))
    np.testing.assert_array_equal(
        py.finalized_eds(cp, cons), nt.finalized_eds(cn, cons))
    py.free(cp)
    nt.free(cn)


# -- the engines with backend("native") --------------------------------


def _single_reads():
    return [(r, None) for r in generate_test(4, 60, 8, 0.02, seed=17)[1]]


def _offset_reads():
    return list(zip([b"ACGTACGTACGTACGT", b"ACGTACGTACGT", b"GTACGTACGT"],
                    [None, 4, 7]))


def _dual_draw(seed):
    """``tests/test_native_engines.py``'s randomized two-haplotype draw."""
    truth, reads = generate_test(4, 80, 6, 0.02, seed=seed)
    h2 = bytearray(truth)
    h2[len(h2) // 2] = (h2[len(h2) // 2] + 1) % 4
    return list(reads) + [bytes(h2)] * 4


def _dual_fixture(name, cost="L1_DISTANCE"):
    seqs, _ = tfix.load_dual_fixture(name, True,
                                     getattr(T.ConsensusCost, cost))
    return seqs


ENGINE_CASES = [
    ("ConsensusDWFA", _single_reads, {}),
    ("ConsensusDWFA", lambda: [(s, None) for s in (
        b"ACGTACCGT****", b"**GTATGTAC**", b"****ACGTACGT")],
     dict(wildcard=ord("*"), consensus_cost="L2_DISTANCE")),
    ("ConsensusDWFA", _offset_reads,
     dict(offset_window=1, offset_compare_length=4)),
    ("DualConsensusDWFA", lambda: [(s, None) for s in _dual_fixture(
        "dual_001")], dict(wildcard=ord("*"))),
    ("DualConsensusDWFA", lambda: [(s, None) for s in _dual_draw(1)],
     dict(min_count=2)),
    ("DualConsensusDWFA", lambda: [(s, None) for s in _dual_draw(2)],
     dict(min_count=2, weighted_by_ed=True)),
]


@pytest.mark.parametrize("engine,make,cfg", ENGINE_CASES,
                         ids=["single", "single_wild_l2", "single_offsets",
                              "dual_001", "dual_draw", "dual_weighted"])
def test_engines_on_native_as_jax(engine, make, cfg):
    reads = make()
    got = []
    for pkg in (J, T):
        eng = getattr(pkg, engine)(_cfg(pkg, backend="native", **cfg))
        for r, off in reads:
            eng.add_sequence_offset(r, off)
        got.append(_key(eng.consensus()))
    assert got[1] == got[0]
    assert got[1]


@pytest.mark.parametrize("name,cfg", [
    ("priority_001", dict(wildcard=ord("*"))),
    ("multi_exact_001", dict(wildcard=ord("*"))),
])
def test_priority_engine_on_native_as_jax(name, cfg):
    chains, expected = tfix.load_priority_fixture(
        name, True, T.ConsensusCost.L1_DISTANCE)
    got = []
    for pkg in (J, T):
        eng = pkg.PriorityConsensusDWFA(_cfg(pkg, backend="native", **cfg))
        for chain in chains:
            eng.add_sequence_chain(chain)
        got.append(_key(eng.consensus()))
    assert got[1] == got[0]
    assert got[1][1] == expected.sequence_indices


# -- the complete C++ engines ------------------------------------------


DUAL_FIXTURES = [
    ("dual_001", True, dict(wildcard=ord("*"))),
    ("length_gap_001", True,
     dict(wildcard=ord("*"), consensus_cost="L2_DISTANCE")),
    ("dual_early_termination_001", True,
     dict(wildcard=ord("*"), allow_early_termination=True, min_count=2)),
]


@pytest.mark.parametrize("name,include,cfg", DUAL_FIXTURES,
                         ids=[c[0] for c in DUAL_FIXTURES])
def test_native_dual_fixtures_as_jax(name, include, cfg):
    config = _cfg(T, **cfg)
    seqs, expected = tfix.load_dual_fixture(name, include,
                                            config.consensus_cost)
    jseqs, _ = jfix.load_dual_fixture(name, include,
                                      _cfg(J, **cfg).consensus_cost)
    assert seqs == jseqs
    got = TN.native_dual_consensus(seqs, config=config)
    assert _key(got) == _key(JN.native_dual_consensus(
        seqs, config=_cfg(J, **cfg)))
    if name != "length_gap_001":
        assert got == [expected]


DUAL_DRAWS = [
    ("weighted_by_ed", lambda: [b"ACGTACGTACGT"] * 4 + [b"ACCTACGTACGT"] * 4,
     dict(min_count=2, weighted_by_ed=True)),
    ("min_af_dynamic_counts",
     lambda: [b"ACGTACGTACGT"] * 6 + [b"ACCTACGTACGT"] * 2,
     dict(min_count=1, min_af=0.3)),
    ("empty_fallback", lambda: [b"AAAA", b"CCCC", b"GGGG"],
     dict(min_count=3)),
    ("randomized_0", lambda: _dual_draw(0), dict(min_count=2)),
    ("randomized_1", lambda: _dual_draw(1), dict(min_count=2)),
    ("randomized_2", lambda: _dual_draw(2), dict(min_count=2)),
]


@pytest.mark.parametrize("make,cfg", [c[1:] for c in DUAL_DRAWS],
                         ids=[c[0] for c in DUAL_DRAWS])
def test_native_dual_draws_as_jax(make, cfg):
    seqs = make()
    got = TN.native_dual_consensus(seqs, config=_cfg(T, **cfg))
    want = JN.native_dual_consensus(seqs, config=_cfg(J, **cfg))
    assert _key(got) == _key(want)
    assert isinstance(got[0], T.DualConsensus)


PRIORITY_FIXTURES = [
    ("priority_001", True, {}), ("priority_002", True, {}),
    ("priority_003", True, {}), ("multi_exact_001", True, {}),
    ("multi_exact_002", True, {}), ("multi_err_001", False, {}),
    ("multi_err_002", False, {}), ("multi_samesplit_001", True, {}),
    ("multi_postcon_001", True, dict(min_count=2)),
]


@pytest.mark.parametrize("name,include,cfg", PRIORITY_FIXTURES,
                         ids=[c[0] for c in PRIORITY_FIXTURES])
def test_native_priority_fixtures_as_jax(name, include, cfg):
    config = _cfg(T, wildcard=ord("*"), **cfg)
    chains, expected = tfix.load_priority_fixture(name, include,
                                                  config.consensus_cost)
    got = TN.native_priority_consensus(chains, config=config)
    want = JN.native_priority_consensus(
        chains, config=_cfg(J, wildcard=ord("*"), **cfg))
    assert isinstance(got, T.PriorityConsensus)
    assert _key(got) == _key(want)
    assert got.sequence_indices == expected.sequence_indices


@pytest.mark.parametrize("with_offsets", [False, True])
def test_native_priority_seeds_and_offsets_as_jax(with_offsets):
    """Seed groups, and offsets on level 1 (where the engine reports a
    finalize of an uninitialised read, the same error on both sides)."""
    chains = [[b"ACGTACGTAC", b"AAAACCCCGGTTAC"]] * 3 + [
        [b"ACGTACGTAC", b"GGGGTTTTAACCAG"]] * 3
    offsets = [[None, None]] * 5 + [[None, 2]] if with_offsets else None
    seeds = [0, None, None, 1, None, None]
    out = []
    for mod, pkg in ((TN, T), (JN, J)):
        try:
            out.append(_key(mod.native_priority_consensus(
                chains, offsets, seeds, config=_cfg(pkg, min_count=2))))
        except Exception as exc:  # the error is part of the contract
            out.append((type(exc).__name__, str(exc)))
    assert out[0] == out[1]
    if with_offsets:
        assert out[0] == ("EngineError", "Finalize called on DWFA that "
                          "was never initialized.")
    else:
        assert out[0][1] == [0, 1, 1, 2, 3, 3]


SINGLE_DRAWS = [
    ("generated", lambda: (generate_test(4, 80, 10, 0.02, seed=33)[1], None),
     {}),
    ("wildcards_l1", lambda: ([b"ACGTACCGT****", b"**GTATGTAC**",
                               b"****ACGTACGT"], None),
     dict(wildcard=ord("*"))),
    ("wildcards_l2", lambda: ([b"ACGTACCGT****", b"**GTATGTAC**",
                               b"****ACGTACGT"], None),
     dict(wildcard=ord("*"), consensus_cost="L2_DISTANCE")),
    ("offsets", lambda: tuple(map(list, zip(*_offset_reads()))),
     dict(offset_window=1, offset_compare_length=4)),
    ("early_termination", lambda: ([b"ACGTACGTAC", b"ACGTAC", b"ACGTACGT"],
                                   None),
     dict(allow_early_termination=True, min_count=1)),
]


@pytest.mark.parametrize("make,cfg", [c[1:] for c in SINGLE_DRAWS],
                         ids=[c[0] for c in SINGLE_DRAWS])
def test_native_consensus_as_jax(make, cfg):
    reads, offsets = make()
    got = TN.native_consensus(reads, offsets, _cfg(T, **cfg))
    assert got == JN.native_consensus(reads, offsets, _cfg(J, **cfg))
    assert got and all(isinstance(s, bytes) for s, _ in got)


def _gap_cfg(pkg, backend="native"):
    return _cfg(pkg, allow_early_termination=True, offset_window=4,
                offset_compare_length=10, min_count=1, backend=backend)


def test_coverage_gap_text_as_jax():
    """The coverage-gap error (rc 2) carries both lengths, as the JAX
    package and the reference format it, raised as the port's
    ``EngineError`` by the full C++ engine and by ``backend("native")``."""
    expected = ("Encountered coverage gap: consensus is length 2 with no "
                "candidates, but sequences activate at 40")
    with pytest.raises(EngineError) as err:
        TN.native_consensus([b"AA", b"CC"], offsets=[None, 30],
                            config=_gap_cfg(T))
    assert str(err.value) == expected
    with pytest.raises(J.models.consensus.EngineError) as jerr:
        JN.native_consensus([b"AA", b"CC"], offsets=[None, 30],
                            config=_gap_cfg(J))
    assert str(jerr.value) == expected
    eng = T.ConsensusDWFA(_gap_cfg(T))
    eng.add_sequence_offset(b"AA", None)
    eng.add_sequence_offset(b"CC", 30)
    with pytest.raises(EngineError, match=expected):
        eng.consensus()


@pytest.mark.parametrize("entry", ["consensus", "dual"])
def test_rc1_no_initial_read_as_jax(entry):
    """rc 1: every read has an offset, so none sees the consensus."""
    fn = {"consensus": (TN.native_consensus, JN.native_consensus),
          "dual": (TN.native_dual_consensus, JN.native_dual_consensus)}[entry]
    errors = []
    for f, pkg in zip(fn, (T, J)):
        with pytest.raises(Exception) as err:
            f([b"ACGT", b"ACGG"], [3, 4], _cfg(pkg))
        errors.append((type(err.value).__name__, str(err.value)))
    assert errors[0] == errors[1]
    assert errors[0][0] == "EngineError"


def test_offsets_length_checked():
    with pytest.raises(EngineError, match="one entry per sequence"):
        TN.native_consensus([b"ACGT"], [None, 1])
    with pytest.raises(EngineError, match="non-empty"):
        TN.native_priority_consensus([])


def test_dual_haplotypes_recovered():
    """A generated two-haplotype draw: the C++ dual engine splits the
    reads by haplotype, as the port's own dual engine on ``"python"``."""
    rng = np.random.default_rng(3)
    truth, reads1 = generate_test(4, 200, 6, 0.01, seed=3)
    h2 = bytearray(truth)
    h2[70] = (h2[70] + 1) % 4
    h2 = bytes(h2)
    reads = list(reads1) + [corrupt(h2, 0.01, rng) for _ in range(6)]
    config = _cfg(T, min_count=3)
    got = TN.native_dual_consensus(reads, config=config)
    eng = T.DualConsensusDWFA(_cfg(T, min_count=3, backend="python"))
    for r in reads:
        eng.add_sequence(r)
    assert _key(got) == _key(eng.consensus())
    assert {got[0].consensus1.sequence, got[0].consensus2.sequence} == {
        truth, h2}
