"""The port's single-consensus search against the JAX package's.

``waffle_con_tpu_torch.ConsensusDWFA`` with ``backend="torch"`` on the CPU
(its branch store in torch tensors, its run loop the plain PyTorch twin
of the CUDA kernel) must give byte-identical sequences, scores and result
order to ``waffle_con_tpu.ConsensusDWFA`` with ``backend="jax"`` and with
``backend="python"``, and to its own ``"python"`` oracle backend.
"""

import numpy as np
import pytest

import waffle_con_tpu as J
from waffle_con_tpu.models.consensus import EngineError as JaxEngineError
from waffle_con_tpu.utils.example_gen import generate_test
import waffle_con_tpu_torch as T
from waffle_con_tpu_torch.models.consensus import EngineError


def _search(pkg, backend, reads, offsets=None, **cfg):
    b = pkg.CdwfaConfigBuilder().backend(backend)
    if pkg is T:
        b = b.device("cpu")
    for k, v in cfg.items():
        if k == "consensus_cost":
            v = getattr(pkg.ConsensusCost, v)
        b = getattr(b, k)(v)
    eng = pkg.ConsensusDWFA(b.build())
    for i, r in enumerate(reads):
        eng.add_sequence_offset(r, None if offsets is None else offsets[i])
    return eng, [(c.sequence, c.scores) for c in eng.consensus()]


def _check_all(reads, offsets=None, truth=None, **cfg):
    """Port torch == port python == JAX jax == JAX python."""
    eng, got = _search(T, "torch", reads, offsets, **cfg)
    _e, oracle = _search(T, "python", reads, offsets, **cfg)
    _e, want_jax = _search(J, "jax", reads, offsets, **cfg)
    _e, want_py = _search(J, "python", reads, offsets, **cfg)
    assert got == oracle
    assert got == want_jax
    assert got == want_py
    if truth is not None:
        assert got[0][0] == truth
    return eng


def _truncated(reads):
    return [r[: len(r) - (k % 4)] for k, r in enumerate(reads)]


DRAWS = [
    dict(seed=0, err=0.0, n=10, length=150),
    dict(seed=1, err=0.01, n=12, length=200),
    dict(seed=2, err=0.03, n=12, length=180),
    dict(seed=4, err=0.05, n=12, length=150),
]


@pytest.mark.parametrize("draw", DRAWS, ids=lambda d: f"seed{d['seed']}")
def test_generated_draws(draw):
    truth, reads = generate_test(4, draw["length"], draw["n"], draw["err"],
                                 seed=draw["seed"])
    eng = _check_all(reads, truth=truth if draw["err"] <= 0.03 else None,
                     min_count=3)
    assert eng.last_search_stats["scorer_counters"]["run_calls"] >= 1


def test_early_termination():
    truth, reads = generate_test(4, 150, 10, 0.02, seed=11)
    _check_all(_truncated(reads), min_count=3, allow_early_termination=True)


def test_l2_cost():
    _truth, reads = generate_test(4, 150, 10, 0.04, seed=12)
    _check_all(reads, min_count=3, consensus_cost="L2_DISTANCE")


def test_wildcard():
    rng = np.random.default_rng(77)
    _truth, reads = generate_test(4, 150, 6, 0.02, seed=78)
    star = ord("*")
    wc_reads = []
    for r in reads:
        arr = bytearray(r)
        for pos in rng.choice(len(arr), size=len(arr) // 15, replace=False):
            arr[pos] = star
        wc_reads.append(bytes(arr))
    _check_all(wc_reads, min_count=2, wildcard=star)


def test_band_growth():
    """A tiny initial band forces band overflow (code 5) and replays."""
    _truth, reads = generate_test(4, 100, 6, 0.04, seed=91)
    eng = _check_all(reads, min_count=2, initial_band=2)
    assert eng.last_search_stats["scorer_counters"]["grow_e_events"] >= 1


def test_offset_windows():
    """Late-activating reads (the reference's offset-window case)."""
    expected = b"ACGTACGTACGTACGT"
    sequences = [b"ACGTACGTACGTACGT", b"ACGTACGTACGT", b"GTACGTACGT"]
    eng = _check_all(sequences, offsets=[None, 4, 7], offset_window=1,
                     offset_compare_length=4)
    _e, got = _search(T, "torch", sequences, [None, 4, 7], offset_window=1,
                      offset_compare_length=4)
    assert got == [(expected, [0, 0, 0])]
    assert eng.last_search_stats["scorer_counters"]["activate_calls"] >= 1


def test_offsets_generated():
    """Reads that start late in a generated draw activate mid-search at
    mixed offsets, so runs take the kernel's per-read-offset windows."""
    truth, reads = generate_test(4, 200, 10, 0.01, seed=21)
    starts = [None] * 6 + [40, 40, 75, 90]
    late = [r if s is None else r[s:] for r, s in zip(reads, starts)]
    _check_all(late, offsets=starts, min_count=3, offset_window=10,
               offset_compare_length=12)


def test_offset_gap_error():
    sequences = [b"ACGTACGTACGTACGT", b"ACGTACGTACGTACGT"]
    for pkg, err in ((T, EngineError), (J, JaxEngineError)):
        with pytest.raises(err) as exc:
            _search(pkg, "torch" if pkg is T else "jax", sequences,
                    [None, 1000], offset_window=1, offset_compare_length=4)
        assert str(exc.value) == (
            "Finalize called on DWFA that was never initialized."
        )


def test_tie_order():
    """Tied results come back in the same (lexicographic) order."""
    sequences = [b"ACGTACGTACGT", b"ACGTACCTACGT"]
    _check_all(sequences)
    _e, got = _search(T, "torch", sequences)
    assert [s for s, _ in got] == [b"ACGTACCTACGT", b"ACGTACGTACGT"]
