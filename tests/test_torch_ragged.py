"""The frontier gang's launch on the CPU: ``ragged_plain`` against the JAX
package's ``_j_run_ragged`` and each gang deposit against a solo run.

* ``ragged_plain`` (``waffle_con_tpu_torch/ops/ragged.py``) and the JAX
  package's ``_j_run_ragged`` (``BandArena._build_kernel()``, run on the
  CPU) get the same pools, made with numpy from branches of a seeded
  draw: self-gangs of 2, 4 and 8 members, a forced first push that
  overflows (code 5), the step cap (code 4), L2 with ``cost_overflow``,
  the wildcard, early termination, members that stop many iterations
  before the others, inactive rows, and members of different band widths
  in one pool (``wrow``: the twin takes it, the CUDA kernel does not).
  Every output (int32 state, stop codes, symbols, stats) must be equal
  exactly, at ``cols=1`` and at JAX's default ``_run_cols()``.  The twin's
  float32 vote fold (``seg_vote_fold``) is held bitwise to JAX's segment
  sum.
* Each deposit of ``run_ragged_plain`` (the members read from their slots
  of the branch store) equals the port's solo ``run_extend_plain`` from
  the same state with records off: the packed output, the band rows, the
  folds and the consensus.
* ``plan_ragged`` is ``plan_run``'s geometry per member and refuses what
  the kernel does not take.

One JAX pool shape per module (P=128 rows, W=34, L=256, C=512, 8 vote
columns), so ``_j_run_ragged`` compiles once per ``cols``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waffle_con_tpu.ops import jax_scorer as jx
from waffle_con_tpu.ops.ragged import ArenaConfig, BandArena
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.ops import ragged_kernel as rgk
from waffle_con_tpu_torch.ops import run_kernel as rk
from waffle_con_tpu_torch.ops.ragged import (
    JP_COLS, GangMember, gang_iters, ragged_plain, seg_vote_fold)
from waffle_con_tpu_torch.ops.torch_scorer import INF, TorchScorer
from waffle_con_tpu_torch.utils.example_gen import generate_test

P, W, L, C, G1, A = 128, 34, 256, 512, 9, 8
BIG = 2**31 - 1


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_ragged():
    return BandArena(ArenaConfig())._build_kernel()


def _scorer(reads, E=16, **cfg):
    b = CdwfaConfigBuilder().backend("torch").device("cpu").initial_band(E)
    for k, v in cfg.items():
        b = getattr(b, k)(v)
    return TorchScorer(reads, b.build())


def _branches(sc, truth, prefixes):
    """One branch per prefix of ``truth`` (distinct lengths): a clone of
    the root pushed symbol by symbol.  Returns ``{prefix: slot}``."""
    h = sc.root(np.ones(sc.num_reads, dtype=bool))
    at = {}
    for k in range(max(prefixes) + 1):
        if k in prefixes:
            at[k] = sc._slot_of[sc.clone(h)]
        if k < max(prefixes):
            sc.push(h, truth[: k + 1])
    return at


def _pool(members):
    """The numpy pool of ``members``: ``(scorer, slot, jp row, edits)``
    each, member g on rows g*R .. (g+1)*R-1 of a P-row pool at band width
    W (a narrower member's rows stride ``wrow`` = its width, the columns
    past it INF); ``edits`` maps a field to a function of its rows."""
    reads = np.full((P, L), -1, np.int16)
    rlen = np.zeros(P, np.int32)
    D = np.full((P, W), INF, np.int32)
    e = np.zeros(P, np.int32)
    rmin = np.full(P, INF, np.int32)
    er = np.full(P, INF, np.int32)
    off = np.zeros(P, np.int32)
    act = np.zeros(P, bool)
    seg = np.full(P, G1 - 1, np.int32)
    wrow = np.full(P, W, np.int32)
    cons = np.zeros((G1, C), np.int32)
    clen = np.zeros(G1, np.int32)
    jp = np.zeros((G1, JP_COLS), np.int32)
    row0 = 0
    for g, (sc, slot, jrow, edits) in enumerate(members):
        st = sc._state
        R, w = sc._R, sc._W
        rs = slice(row0, row0 + R)
        reads[rs, : sc._L] = sc._reads.numpy()[:, :L]
        rlen[rs] = sc._rlen.numpy()
        D[rs, :w] = st["D"][slot].numpy()
        for name, arr in (("e", e), ("rmin", rmin), ("er", er),
                          ("off", off), ("act", act)):
            arr[rs] = st[name][slot].numpy()
        seg[rs] = g
        wrow[rs] = w
        cons[g, : st["cons"].shape[1]] = st["cons"][slot].numpy()[:C]
        clen[g] = int(st["clen"][slot])
        jp[g] = jrow
        for name, fn in edits.items():
            arr = {"e": e, "act": act, "rmin": rmin}[name]
            arr[rs] = fn(arr[rs].copy())
        row0 += R
    assert row0 <= P
    return (reads, rlen, D, e, rmin, er, off, act, seg, wrow, cons, clen,
            jp)


def _jp(sc, *, me=BIG, oc=BIG, ol=0, mc=3, l2=False, ms=40, fs=-1):
    return (1, me, oc, ol, mc, int(l2), ms, fs, sc._wc, int(sc._et))


def _compare_with_jax(jax_ragged, pool, cols=1):
    got = ragged_plain(*(torch.from_numpy(np.array(x)) for x in pool), A)
    want = jax_ragged(*pool, A=A, cols=cols)
    names = ("D", "e", "rmin", "er", "cons", "clen", "steps", "code",
             "iters", "eds", "occ", "split", "reached", "fin", "fin_ovf")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    return {n: g.numpy() for n, g in zip(names, got)}


def _noisy(seed=3, err=0.02, n=8, length=200):
    return generate_test(4, length, n, err, seed=seed)


@pytest.mark.parametrize("G", [2, 4, 8])
def test_self_gang_matches_jax(jax_ragged, G):
    truth, reads = _noisy(seed=10 + G)
    prefixes = [3 + 5 * k for k in range(G)]
    sc = _scorer(reads)
    at = _branches(sc, truth, prefixes)
    members = []
    for k, p in enumerate(prefixes):
        fs = (-1, sc.sym_id[truth[p]], (sc.sym_id[truth[p]] + 1) % 4)[k % 3]
        members.append((sc, at[p], _jp(sc, ms=30 + 3 * k, fs=fs), {}))
    out = _compare_with_jax(jax_ragged, _pool(members))
    assert (out["code"][:G] != 0).all() and (out["code"][G:] == 0).all()
    assert out["steps"][:G].sum() > G


def test_forced_push_overflow_and_step_cap(jax_ragged):
    """Code 5 from the forced push itself (a row already at the band's
    edge), code 5 after a loop step, and code 4 at the step cap."""
    truth, reads = _noisy(seed=21)
    sc = _scorer(reads, E=8)
    at = _branches(sc, truth, [2, 5, 9])
    E = (sc._W - 2) // 2
    edge = lambda e: np.where(np.arange(len(e)) == 1, E, e)  # noqa: E731
    members = [
        (sc, at[2], _jp(sc, fs=sc.sym_id[truth[2]]), {"e": edge}),
        (sc, at[5], _jp(sc, ms=6), {}),
        (sc, at[9], _jp(sc), {"e": edge}),
    ]
    out = _compare_with_jax(jax_ragged, _pool(members))
    assert out["code"][0] == 5 and out["steps"][0] == 0
    assert out["iters"][0] == 0
    assert out["code"][1] == 4 and out["steps"][1] == 6
    assert out["code"][2] == 5


def test_l2_cost_overflow(jax_ragged):
    """L2 costs (wrapping int32 totals) and ``cost_overflow`` (a read past
    2,048) make the vote dirty (code 1)."""
    truth, reads = _noisy(seed=22, err=0.04)
    sc = _scorer(reads, allow_early_termination=True)
    at = _branches(sc, truth, [4, 8])
    big = lambda e: np.where(np.arange(len(e)) == 0, 2100, e)  # noqa: E731
    members = [
        (sc, at[4], _jp(sc, l2=True, ms=50), {}),
        (sc, at[8], _jp(sc, l2=True, ms=50), {"e": big}),
    ]
    out = _compare_with_jax(jax_ragged, _pool(members))
    assert out["code"][1] == 1 and out["steps"][1] == 0


def test_wildcard_and_inactive_rows(jax_ragged):
    truth, reads = _noisy(seed=23)
    reads = [bytes(9 if k % 15 == 14 else b for k, b in enumerate(r))
             for r in reads]
    sc = _scorer(reads, wildcard=9)
    at = _branches(sc, truth, [3, 6, 11])
    drop = lambda a: np.where(np.arange(len(a)) % 3 == 1, False, a)  # noqa: E731
    members = [
        (sc, at[3], _jp(sc, fs=sc.sym_id[truth[3]]), {}),
        (sc, at[6], _jp(sc), {"act": drop}),
        (sc, at[11], _jp(sc, mc=2), {}),
    ]
    assert sc._wc >= 0
    _compare_with_jax(jax_ragged, _pool(members))


def test_early_termination_reached_and_early_stops(jax_ragged):
    """Reads of different lengths under early termination (reached states
    stop with code 2), and members stopping long before the others:
    budget and lost pops (code 3)."""
    truth, reads = _noisy(seed=24, length=60)
    reads = [r[: len(r) - 4 * (k % 3)] for k, r in enumerate(reads)]
    sc = _scorer(reads, allow_early_termination=True)
    at = _branches(sc, truth, [2, 30, 40])
    members = [
        (sc, at[2], _jp(sc, ms=200), {}),
        (sc, at[30], _jp(sc, me=0, ms=200), {}),
        (sc, at[40], _jp(sc, oc=1, ol=45, ms=200), {}),
    ]
    out = _compare_with_jax(jax_ragged, _pool(members))
    assert out["code"][0] == 2
    assert set(out["code"][1:3]) <= {3}


def test_mixed_band_widths(jax_ragged):
    """Members of two band widths in one pool: the narrow one's rows stride
    ``wrow`` = 18 of the pool's 34 columns."""
    truth, reads = _noisy(seed=25)
    wide, narrow = _scorer(reads, E=16), _scorer(reads, E=8)
    aw = _branches(wide, truth, [4, 9])
    an = _branches(narrow, truth, [6, 12])
    members = [
        (wide, aw[4], _jp(wide), {}),
        (narrow, an[6], _jp(narrow, fs=narrow.sym_id[truth[6]]), {}),
        (wide, aw[9], _jp(wide, ms=25), {}),
        (narrow, an[12], _jp(narrow), {}),
    ]
    pool = _pool(members)
    assert set(pool[9].tolist()) == {18, 34}
    _compare_with_jax(jax_ragged, pool)


def test_default_cols_matches(jax_ragged):
    """JAX's default ``_run_cols()`` (several columns a loop iteration)
    gives the same bytes as ``cols=1``, and so the same as the twin."""
    truth, reads = _noisy(seed=26)
    sc = _scorer(reads)
    at = _branches(sc, truth, [5, 7, 13, 17])
    members = [(sc, at[p], _jp(sc, ms=23 + p), {}) for p in (5, 7, 13, 17)]
    cols = jx._RUN_COLS_DEFAULT.get("cpu", 1)
    assert cols > 1
    _compare_with_jax(jax_ragged, _pool(members), cols=cols)


def test_seg_vote_fold_bitwise():
    rng = np.random.default_rng(5)
    occ = rng.integers(0, 4, size=(P, A)).astype(np.int32)
    occ[rng.random(P) < 0.2] = 0
    split = occ.sum(1).astype(np.int32)
    seg = rng.integers(0, G1, size=P).astype(np.int32)
    got = seg_vote_fold(torch.from_numpy(occ), torch.from_numpy(split),
                        torch.from_numpy(seg).long(), G1).numpy()
    frac = jnp.where(
        split[:, None] > 0,
        occ.astype(np.float32)
        / jnp.maximum(split, 1)[:, None].astype(jnp.float32), 0.0)
    want = np.asarray(jnp.zeros((G1, A), jnp.float32).at[seg].add(frac))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------
# deposits against solo runs


def _solo(sc, slot, row):
    """The member alone through the plain run loop (records off), from a
    copy of the store: ``(RunResult, state after)``."""
    _s, _l, me, oc, ol, ms, fs = (int(v) for v in row)
    st = {k: v.clone() for k, v in sc._state.items()}
    args = rk.RunArgs(me_budget=me, other_cost=oc, other_len=ol,
                      min_count=sc.config.min_count,
                      l2=False, max_steps=ms, first_sym=fs,
                      allow_records=False, wc=sc._wc, et=sc._et,
                      a_real=sc.num_symbols)
    out, _rs, _rf = rk.run_extend_plain(st, slot, sc._reads, sc._rlen, args)
    return rk.unpack(out.numpy(), sc._R, sc.num_symbols, ms), st


SOLO_CASES = {
    # label: (draw seed, err, length, reads cut, prefixes, member kwargs,
    # stop codes the members must reach)
    "mixed": (31, 0.02, 200, 0, [3, 8, 14, 20],
              [dict(fs=0), dict(), dict(ms=7), dict(fs=2)], {4}),
    "reached": (32, 0.0, 40, 3, [5, 20, 33], [dict(), dict(fs=1), dict()],
                {2}),
    "lose_pop": (33, 0.02, 120, 0, [4, 9],
                 [dict(oc=2, ol=6), dict(me=1, fs=1)], {3}),
}


@pytest.mark.parametrize("label", sorted(SOLO_CASES))
def test_deposit_equals_solo_run(label):
    seed, err, length, cut, prefixes, kws, want_codes = SOLO_CASES[label]
    truth, reads = generate_test(4, length, 8, err, seed=seed)
    if cut:
        reads = [r[: len(r) - cut * (k % 2)] for k, r in enumerate(reads)]
    sc = _scorer(reads, E=8)
    at = _branches(sc, truth, prefixes)
    rows = []
    for p, kw in zip(prefixes, kws):
        fs = kw.get("fs", -1)
        rows.append((at[p], p, kw.get("me", BIG), kw.get("oc", BIG),
                     kw.get("ol", 0), kw.get("ms", 60), fs))
    params = np.asarray(rows, np.int32)
    call = rgk.GangCall(min_count=3, l2=False, wc=sc._wc, et=sc._et,
                        a_real=sc.num_symbols)
    before = {k: v.clone() for k, v in sc._state.items()}
    dep = rgk.run_ragged(sc._state, params, sc._reads, sc._rlen, call)
    for k, v in sc._state.items():  # the store is never written
        assert torch.equal(v, before[k]), k
    MS = int(params[:, 5].max())
    codes = set()
    for g, row in enumerate(params):
        got = rk.unpack(dep["out"][g].numpy(), sc._R, sc.num_symbols, MS)
        want, st = _solo(sc, int(row[0]), row)
        for name in rk.RunResult._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
                err_msg=f"member {g} {name}")
        slot = int(row[0])
        for name in ("D", "e", "rmin", "er", "clen"):
            assert torch.equal(dep[name][g], st[name][slot]), (g, name)
        n = int(st["clen"][slot])
        assert torch.equal(dep["cons"][g, :n], st["cons"][slot, :n])
        codes.add(got.code)
    assert want_codes <= codes, codes


def test_desync_member_runs_nothing():
    truth, reads = _noisy(seed=34)
    sc = _scorer(reads, E=8)
    at = _branches(sc, truth, [4, 7])
    params = np.asarray([(at[4], 4, BIG, BIG, 0, 20, -1),
                         (at[7], 6, BIG, BIG, 0, 20, -1)], np.int32)
    call = rgk.GangCall(3, False, sc._wc, sc._et, sc.num_symbols)
    dep = rgk.run_ragged(sc._state, params, sc._reads, sc._rlen, call)
    assert int(dep["out"][0, 1]) in (1, 2, 3, 4, 5)
    assert int(dep["out"][1, 1]) == -1 and int(dep["out"][1, 4]) == 7


@pytest.mark.parametrize("shifts", [(0, 1), (1, 0, 0), (1, 1)])
def test_desync_launch_counts_a_group(shifts):
    """A member out of step with its slot (``len(consensus)`` shifted)
    runs nothing and gets no deposit; the launch still counts one group,
    so ``gang_groups`` equals the gang kernel's launches, and
    ``gang_members`` counts only the in-step members."""
    truth, reads = _noisy(seed=36)
    sc = _scorer(reads, E=8)
    prefixes = [3 + 4 * k for k in range(len(shifts))]
    h = sc.root(np.ones(sc.num_reads, dtype=bool))
    hs = {}
    for k in range(max(prefixes) + 1):
        if k in prefixes:
            hs[k] = sc.clone(h)
        if k < max(prefixes):
            sc.push(h, truth[: k + 1])
    members = [GangMember(hs[p], truth[: p + d], BIG, BIG, 0, 20)
               for p, d in zip(prefixes, shifts)]
    gang = ragged.frontier_gang_for(sc)
    n = gang.run(members, 3, False)
    synced = sum(1 for d in shifts if d == 0)
    c = sc.counters
    assert n == synced
    assert c.get("gang_groups", 0) == 1 == gang.stats()["groups"]
    assert c.get("gang_members", 0) == synced
    assert c.get("gang_skip_desync", 0) == len(shifts) - synced
    assert [gang.pending(hs[p]) for p in prefixes] == [
        d == 0 for d in shifts]


def test_gang_iters_formula(jax_ragged):
    """``iters`` (live loop iterations) is a function of the forced symbol
    and the steps, which the deposits use instead of a kernel output."""
    truth, reads = _noisy(seed=35)
    sc = _scorer(reads)
    at = _branches(sc, truth, [2, 6, 9, 12])
    fss = [-1, sc.sym_id[truth[6]], -1, sc.sym_id[truth[12]]]
    members = [(sc, at[p], _jp(sc, ms=10 + p, fs=fs), {})
               for p, fs in zip([2, 6, 9, 12], fss)]
    out = _compare_with_jax(jax_ragged, _pool(members))
    for g, fs in enumerate(fss):
        assert out["iters"][g] == gang_iters(fs, int(out["steps"][g]))


# ---------------------------------------------------------------------
# the planner


def test_plan_ragged_is_plan_run_per_member():
    for G, R, Wd, Ad in [(1, 16, 18, 4), (8, 256, 514, 4), (4, 64, 258, 4),
                         (8, 32, 130, 5)]:
        plan = rgk.plan_ragged(G, R, Wd, Ad, 512)
        assert plan.members == G
        assert plan.run == rk.plan_run(R, Wd, Ad)


@pytest.mark.parametrize("shape", [
    (0, 16, 18, 4, 512), (9, 16, 18, 4, 512), (2, 16, 18, 4, 1),
    (2, 0, 18, 4, 512), (2, 16, 17, 4, 512), (2, 65536, 258, 256, 512),
])
def test_plan_ragged_refuses(shape):
    with pytest.raises(ValueError):
        rgk.plan_ragged(*shape)
