"""The port's ``DualConsensusDWFA`` against the JAX package's.

The port runs with ``backend="torch"`` on ``device="cpu"`` (its plain run
loops) and with its ``"python"`` oracle; the JAX package with
``backend="jax"`` and ``"python"``.  Per result, in order, the sequences
and scores of both consensuses, the read assignment and both full score
vectors must be equal exactly (``DualConsensus.__eq__`` ignores scores,
so the tests compare tuples).
"""

import pytest

import waffle_con_tpu as J
import waffle_con_tpu_torch as T
from waffle_con_tpu.models.consensus import EngineError as JaxEngineError
from waffle_con_tpu.utils.fixtures import load_dual_fixture
from waffle_con_tpu_torch.models.consensus import EngineError

BACKENDS = [("jax", "torch"), ("python", "python")]


def _key(results):
    cons = lambda c: None if c is None else (c.sequence, list(c.scores))  # noqa: E731
    return [
        (cons(d.consensus1), cons(d.consensus2), list(d.is_consensus1),
         list(d.scores1), list(d.scores2))
        for d in results
    ]


def _run(pkg, backend, reads, offsets=None, **cfg):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T and backend == "torch":
        b = b.device("cpu")
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    eng = pkg.DualConsensusDWFA(b.build())
    for i, r in enumerate(reads):
        eng.add_sequence_offset(r, None if offsets is None else offsets[i])
    return _key(eng.consensus()), eng


def _check(reads, offsets=None, backends=BACKENDS, **cfg):
    """Every (jax backend, port backend) pair gives the same results;
    returns them and the port's torch engine."""
    eng_t = None
    for jb, tb in backends:
        want, _ = _run(J, jb, reads, offsets, **cfg)
        got, eng = _run(T, tb, reads, offsets, **cfg)
        assert got == want, (jb, tb)
        if tb == "torch":
            eng_t = eng
    return want, eng_t


@pytest.mark.parametrize("name,include,cfg", [
    ("dual_001", True, dict(wildcard=ord("*"))),
    ("dual_early_termination_001", True,
     dict(wildcard=ord("*"), allow_early_termination=True)),
    ("length_gap_001", False,
     dict(wildcard=ord("*"), min_count=2, dual_max_ed_delta=5,
          max_queue_size=1000, consensus_cost="l2")),
])
def test_fixtures(name, include, cfg):
    if cfg.get("consensus_cost") == "l2":
        cfg = dict(cfg)
        del cfg["consensus_cost"]
        cfg_j = dict(cfg, consensus_cost=J.ConsensusCost.L2_DISTANCE)
        cfg_t = dict(cfg, consensus_cost=T.ConsensusCost.L2_DISTANCE)
        cost = J.ConsensusCost.L2_DISTANCE
    else:
        cfg_j = cfg_t = cfg
        cost = J.ConsensusCost.L1_DISTANCE
    reads, expected = load_dual_fixture(name, include, cost)
    for jb, tb in BACKENDS:
        want, _ = _run(J, jb, reads, **cfg_j)
        got, _ = _run(T, tb, reads, **cfg_t)
        assert got == want, (jb, tb)
    assert got[0][0][0] == expected.consensus1.sequence
    assert got[0][2] == expected.is_consensus1


def test_doc_example():
    want, _ = _check([
        b"TCCGT", b"ACCGT", b"ACCGT", b"ACCAT",
        b"CCGTAAT", b"CGTAAAT", b"CGTAAT", b"CGTAAT",
    ])
    assert want[0][0] == (b"ACCGT", [1, 0, 0, 1])
    assert want[0][1] == (b"CGTAAT", [1, 1, 0, 0])


@pytest.mark.parametrize("sequence,alt", [(b"ACGT", b"AGGTA"),
                                          (b"ACGTA", b"AGGT")])
def test_dual_unequal(sequence, alt):
    want, _ = _check([sequence, alt], min_count=1)
    assert want[0][0][0] == sequence and want[0][1][0] == alt


def test_dual_noise_before_variation():
    _check([
        b"ACGTACGTACGT", b"ACCGTACGTACGT", b"ACGTACGTACGT",
        b"ACGTACGTCCCT", b"ACGTACGTCCCT", b"ACCGTACGTCCCT",
    ], min_count=1, max_queue_size=1000)


def test_equal_options():
    want, _ = _check([
        b"ACGTACGTACGT", b"ACGTCCGTCCGT", b"ACGTACGTCCGT", b"ACGTCCGTACGT",
    ], min_count=1, max_queue_size=1000)
    assert len(want) == 6


def test_tail_extension():
    want, _ = _check([b"ACGT", b"ACGTT"], min_count=1, max_queue_size=1000)
    assert [w[0][0] for w in want] == [b"ACGT", b"ACGTT"]


def test_dual_max_ed_delta():
    reads, _ = load_dual_fixture("dual_001", True, J.ConsensusCost.L1_DISTANCE)
    want, _ = _check(reads, wildcard=ord("*"), dual_max_ed_delta=0)
    assert want[0][2] == [True, True, False, True, True, False, False,
                          False, False, False]


def test_offset_windows():
    want, _ = _check(
        [b"ACGTACGTACGTACGT", b"ACGTACGTACGT", b"GTACGTACGT"],
        offsets=[None, 4, 7], offset_window=1, offset_compare_length=4,
    )
    assert want == [((b"ACGTACGTACGTACGT", [0, 0, 0]), None,
                     [True, True, True], [0, 0, 0], [None, None, None])]


def test_offset_gap_err():
    for pkg, err, be in ((J, JaxEngineError, "jax"), (T, EngineError, "torch")):
        with pytest.raises(err) as exc:
            _run(pkg, be, [b"ACGTACGTACGTACGT", b"ACGTACGTACGTACGT"],
                 offsets=[None, 1000], offset_window=1,
                 offset_compare_length=4)
        assert str(exc.value) == (
            "Finalize called on DWFA that was never initialized."
        )
