"""The torch column primitives against the JAX package's, on random states.

``waffle_con_tpu_torch.ops.torch_scorer``'s ``init_col``, ``col_step``,
``stats_core`` and ``finalized`` are the twins of ``_init_col``,
``_col_step_w``, ``_stats_core_w`` and ``_finalized``
(``waffle_con_tpu/ops/jax_scorer.py``).  The same numpy-seeded inputs go
through both; every output must be equal exactly (integer DP).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waffle_con_tpu.ops import jax_scorer as J
from waffle_con_tpu_torch.ops import torch_scorer as T


def _random_state(rng, R, E, A):
    """A random branch row: band values mixing small costs and INF,
    per-read folds, offsets, an active mask, read lengths and a read
    window (dense ids, some -1 padding)."""
    W = 2 * E + 2
    D = rng.integers(0, 3 * E, size=(R, W)).astype(np.int32)
    D[rng.random((R, W)) < 0.2] = T.INF
    e = rng.integers(0, E, size=R).astype(np.int32)
    rmin = np.where(rng.random(R) < 0.5, rng.integers(0, E, size=R), T.INF)
    er = np.where(rng.random(R) < 0.3, e, T.INF)
    off = rng.integers(0, 4, size=R).astype(np.int32)
    act = rng.random(R) < 0.8
    rlen = rng.integers(E, 6 * E, size=R).astype(np.int32)
    chars = rng.integers(-1, A, size=(R, W)).astype(np.int16)
    return dict(D=D, e=e.astype(np.int32), rmin=rmin.astype(np.int32),
                er=er.astype(np.int32), off=off, act=act, rlen=rlen,
                chars=chars)


def _tt(x):
    return torch.from_numpy(np.ascontiguousarray(x))


CASES = [
    (E, wc, et) for E in (8, 64) for wc in (False, True) for et in (False, True)
]


@pytest.mark.parametrize("E,wc,et", CASES,
                         ids=[f"E{E}-wc{int(w)}-et{int(t)}" for E, w, t in CASES])
def test_col_step_and_stats_match_jax(E, wc, et):
    rng = np.random.default_rng(1000 * E + 10 * wc + et)
    R, A = 16, 5
    wc_id = 4 if wc else -2
    for trial in range(3):
        s = _random_state(rng, R, E, A)
        jnew = int(rng.integers(E, 4 * E))
        sym = int(rng.integers(0, A))
        want = J._col_step_w(
            jnp.asarray(s["D"]), jnp.asarray(s["e"]), jnp.asarray(s["rmin"]),
            jnp.asarray(s["er"]), jnp.asarray(s["off"]),
            jnp.asarray(s["act"]), jnp.asarray(s["rlen"]),
            jnp.asarray(s["chars"]), jnp.int32(jnew), jnp.int32(sym),
            jnp.int32(wc_id), jnp.asarray(et), jnp.int32(E),
        )
        got = T.col_step(
            _tt(s["D"]), _tt(s["e"]), _tt(s["rmin"]), _tt(s["er"]),
            _tt(s["off"]), _tt(s["act"]), _tt(s["rlen"]), _tt(s["chars"]),
            jnew, sym, wc_id, et, E,
        )
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())

        clen = int(rng.integers(0, 4 * E))
        want = J._stats_core_w(
            jnp.asarray(s["D"]), jnp.asarray(s["e"]), jnp.asarray(s["rmin"]),
            jnp.asarray(s["er"]), jnp.asarray(s["off"]),
            jnp.asarray(s["act"]), jnp.asarray(s["rlen"]),
            jnp.asarray(s["chars"]), jnp.int32(clen), A, jnp.int32(E),
        )
        got = T.stats_core(
            _tt(s["D"]), _tt(s["e"]), _tt(s["rmin"]), _tt(s["er"]),
            _tt(s["off"]), _tt(s["act"]), _tt(s["rlen"]), _tt(s["chars"]),
            clen, A, E,
        )
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())


@pytest.mark.parametrize("E", [8, 64])
def test_init_col_and_finalized_match_jax(E):
    rng = np.random.default_rng(E)
    R = 16
    W = 2 * E + 2
    s = _random_state(rng, R, E, 4)
    want = J._init_col(jnp.asarray(s["off"]), jnp.asarray(s["act"]),
                       jnp.asarray(s["rlen"]), jnp.int32(E), W)
    got = T.init_col(_tt(s["off"]), _tt(s["act"]), _tt(s["rlen"]), E, W)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(w), g.numpy())

    fin_w, ovf_w = J._finalized(jnp.asarray(s["e"]), jnp.asarray(s["rmin"]),
                                jnp.asarray(s["act"]), jnp.int32(E))
    fin_g, ovf_g = T.finalized(_tt(s["e"]), _tt(s["rmin"]), _tt(s["act"]), E)
    np.testing.assert_array_equal(np.asarray(fin_w), fin_g.numpy())
    assert bool(ovf_w) == bool(ovf_g)


def test_batched_primitives_match_per_branch():
    """The torch primitives take leading branch dimensions (the batched
    push and the band replay use them); a batch equals its rows."""
    rng = np.random.default_rng(7)
    E, R, A = 8, 16, 4
    rows = [_random_state(rng, R, E, A) for _ in range(3)]
    rlen = _tt(rows[0]["rlen"])
    stack = lambda k: torch.stack([_tt(r[k]) for r in rows])  # noqa: E731
    jnew = torch.tensor([9, 12, 15], dtype=torch.int32)
    sym = torch.tensor([0, 3, 1], dtype=torch.int32)
    batched = T.col_step(stack("D"), stack("e"), stack("rmin"), stack("er"),
                         stack("off"), stack("act"), rlen, stack("chars"),
                         jnew, sym, -2, False, E)
    for b, r in enumerate(rows):
        one = T.col_step(_tt(r["D"]), _tt(r["e"]), _tt(r["rmin"]),
                         _tt(r["er"]), _tt(r["off"]), _tt(r["act"]), rlen,
                         _tt(r["chars"]), int(jnew[b]), int(sym[b]), -2,
                         False, E)
        for x, y in zip(batched, one):
            assert torch.equal(x[b], y)
