"""Models of the late-read kernels' arithmetic, held to the plain twins
and to the JAX package.

The CUDA kernels (``csrc/offset_scan.cu``, ``csrc/col_replay.cu``) run
only on the card, where ``chip_smoke.py``'s ``replay_kernel`` phase holds
them bitwise to their plain twins.  These numpy models do what the
kernels do, word for word and lane for lane, so that their designs are
checked here on seeded draws:

* the offset scan's bit-parallel recurrence (Myers' bit vectors with a
  global top row): the match table Peq, one 64-bit word a lane, the add's
  carries across the lanes of a group by lookahead on their generate and
  propagate bits, chunks of 32 words with the carries handed on, the
  shifts' carries, the score of row m — against ``ts.offset_scan`` and
  ``_j_offset_scan``, with wildcards on either side, both sentinels,
  ``m = 0`` and the word boundaries;
* the column replay's register runs: each lane's cells, the cell above
  from the next lane, the lanes' scan, a multi-warp row's records (the
  top cell's deletion term added by the warps above), the symbols that
  slide down a cell a column fed from chunks, the folds one column late
  — against ``ts.replay_rows`` and ``_j_replay``, and the activation's
  commit rule against ``activate_row_plain``, on every placement (one
  warp, a CTA, a cluster).
"""

import jax
import numpy as np
import pytest
import torch

from waffle_con_tpu.ops.jax_scorer import _j_offset_scan, _j_replay
from waffle_con_tpu_torch.ops import replay_kernel
from waffle_con_tpu_torch.ops import torch_scorer as ts

INF = 1 << 20
BIG = 2 * INF  # an infinite u = D - t: u + t >= INF for any padding t
INT_MAX = 2**31 - 1
ALL = np.uint64(2**64 - 1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# the offset scan


def _u(x):
    return np.uint64(x)


def bitvec_scan(win, heads, m, wc, P, M, group=None):
    """``csrc/offset_scan.cu``'s recurrence for every (head, position):
    ``group`` lanes of one word each (the plan's, or 32 for the chunked
    shared-memory column), Peq from the head, carries as the kernel takes
    them.  Returns ``[B, P]`` int."""
    B = heads.shape[0]
    best = np.full((B, P), min(3 * M + 5, m), dtype=np.int64)
    if m == 0:
        return best
    plan = replay_kernel.plan_offset_scan(B, P, M, m)
    G = group or plan.group or 32
    words = -(-m // 64)
    nwp = plan.nwp if group is None else G * -(-words // G)
    # Peq: rows 0-255 by id, row 256 for every other symbol
    tab = np.zeros((B, replay_kernel.PEQ_ROWS, nwp), dtype=np.uint64)
    for b in range(B):
        for i in range(m):
            s = int(heads[b, i])
            if 0 <= s < 256:
                tab[b, s, i >> 6] |= _u(1 << (i & 63))
    if 0 <= wc < 256:
        other = tab[:, wc].copy()
        tab[:, :256] |= other[:, None]
        tab[:, wc] = ALL
        tab[:, 256] = other
    Pv = np.full((B, P, nwp), ALL, dtype=np.uint64)
    Mv = np.zeros((B, P, nwp), dtype=np.uint64)
    score = np.full((B, P), m, dtype=np.int64)
    wm, bm = (m - 1) >> 6, _u((m - 1) & 63)
    lanes = np.arange(G, dtype=np.uint64)
    one, top = _u(1), _u(63)
    Wn = len(win)
    for j in range(1, min(2 * M, 2 * m) + 1):
        s = win[np.minimum(np.arange(P) + j - 1, Wn - 1)]
        row = np.where((s >= 0) & (s < 256), s, 256)
        Eq = tab[:, row, :]
        Xv = Eq | Mv
        t = Eq & Pv
        summ = t + Pv
        gen, pro = summ < t, summ == ALL
        cin = np.zeros((B, P), dtype=np.uint64)
        for c in range(nwp // G):
            sl = slice(c * G, (c + 1) * G)
            g = (gen[..., sl].astype(np.uint64) << lanes).sum(-1)
            p = (pro[..., sl].astype(np.uint64) << lanes).sum(-1)
            sv = g + (g | p) + cin
            cv = sv ^ g ^ (g | p)
            summ[..., sl] += (cv[..., None] >> lanes) & one
            cin = (cv >> _u(G)) & one
        Xh = (summ ^ Pv) | Eq
        Ph = Mv | ~(Xh | Pv)
        Mh = Pv & Xh
        score += (((Ph[..., wm] >> bm) & one).astype(np.int64)
                  - ((Mh[..., wm] >> bm) & one).astype(np.int64))
        in_ph = np.concatenate([np.ones((B, P, 1), np.uint64),
                                Ph[..., :-1] >> top], -1)
        in_mh = np.concatenate([np.zeros((B, P, 1), np.uint64),
                                Mh[..., :-1] >> top], -1)
        Ph = (Ph << one) | in_ph
        Mh = (Mh << one) | in_mh
        Pv = Mh | ~(Xv | Ph)
        Mv = Ph & Xv
        best = np.minimum(best, score)
    return best


def _scan_draw(seed, P, M, m, wild, B=2, real=None):
    """A window of random symbols 0-3 (``real`` of them, then the -2
    sentinel) and ``B`` heads of ``m`` symbols (then -3), each copied from
    the window with a few edits; ``wild`` names the sides that get the
    wildcard id 4 (``"head-sentinel"`` also puts a -3 inside one head)."""
    rng = np.random.default_rng(seed)
    n = P + 2 * M if real is None else real
    win = np.full(P + 2 * M, -2, dtype=np.int32)
    win[:n] = rng.integers(0, 4, n)
    heads = np.full((B, M), -3, dtype=np.int32)
    for b in range(B):
        if m == 0:
            continue
        at = int(rng.integers(0, max(1, n - m)))
        seg = win[at:at + m]
        heads[b, :len(seg)] = seg
        heads[b, len(seg):m] = rng.integers(0, 4, m - len(seg))
        flip = rng.choice(m, size=max(1, m // 8), replace=False)
        heads[b, flip] = rng.integers(0, 4, len(flip))
    if m and "head" in wild:
        heads[:, rng.choice(m, size=max(1, m // 10), replace=False)] = 4
    if "window" in wild:
        win[rng.choice(n, size=max(1, n // 10), replace=False)] = 4
    if m and "sentinel" in wild:
        heads[0, rng.integers(0, m)] = -3
    return win, heads


@pytest.mark.parametrize("wild", ["", "head", "window", "head+window",
                                  "head+window+sentinel"])
@pytest.mark.parametrize("P,M,m,real", [
    (8, 8, 0, None), (8, 8, 5, None), (64, 64, 50, 100), (64, 64, 64, 100),
    (16, 128, 65, 200), (8, 128, 128, 200), (8, 256, 129, 300),
    (2, 256, 200, 200)])
def test_bitvec_model_matches_twin_and_jax(P, M, m, real, wild):
    """The kernel's recurrence on the plan's geometry (one thread a
    position for m <= 64, groups of 2 and 4 lanes past the word
    boundaries) equals the plain twin and the JAX loop exactly."""
    wc = 4 if wild else -2
    win, heads = _scan_draw(P * 1000 + m, P, M, m, wild, real=real)
    got = bitvec_scan(win, heads, m, wc, P, M)
    twin = ts.offset_scan(torch.from_numpy(win), torch.from_numpy(heads), m,
                          wc, P, M).numpy()
    ref = np.asarray(_j_offset_scan(win, heads, m, wc, P=P, M=M))
    np.testing.assert_array_equal(twin, ref)
    np.testing.assert_array_equal(got, twin)


@pytest.mark.parametrize("m,group", [(65, 32), (129, 32), (200, 1),
                                     (200, 2), (300, 32)])
def test_bitvec_model_other_groups(m, group):
    """Any group width gives the same scores: a thread with one word a
    chunk hands every carry on (``group`` 1), a warp resolves them by
    lookahead; ``m > 64 * group`` takes several chunks, as the
    shared-memory column does."""
    P, M = 4, 512
    win, heads = _scan_draw(m + group, P, M, m, "head+window", real=700)
    twin = ts.offset_scan(torch.from_numpy(win), torch.from_numpy(heads), m,
                          4, P, M).numpy()
    np.testing.assert_array_equal(
        bitvec_scan(win, heads, m, 4, P, M, group=group), twin)


def test_bitvec_model_chunked_long_head():
    """Past 2,048 rows the column sits in shared memory, stepped 32 words
    at a time: m = 2,100 is 33 words, two chunks."""
    P, M, m = 2, 4096, 2100
    win, heads = _scan_draw(5, P, M, m, "head", B=1, real=2400)
    assert replay_kernel.plan_offset_scan(1, P, M, m).group == 0
    twin = ts.offset_scan(torch.from_numpy(win), torch.from_numpy(heads), m,
                          4, P, M).numpy()
    np.testing.assert_array_equal(bitvec_scan(win, heads, m, 4, P, M), twin)


# ---------------------------------------------------------------------
# the column replay


def _read_sym(rd, i):
    return int(rd[i]) if 0 <= i < len(rd) else -1


def replay_row(cons, clen_b, rd, rl, off, act, wc, et, E, W, plan):
    """One row through ``csrc/col_replay.cu``'s register kernel with the
    geometry of ``plan`` (cells, row_warps, ctas): slots warp by warp
    and lane by lane, the band's cells in the top W of them (the padding
    below cell 0), each cell kept as ``u = D - t``.  Returns ``(cells
    [W], e, rmin, er)``."""
    C = plan.cells
    nwr = plan.row_warps * plan.ctas
    multi = nwr > 1
    n = nwr * 32  # lanes of the row, warp by warp
    assert n * C >= W
    pad = n * C - W
    # each lane's first cell (negative: padding), and its run of cells
    ta = np.arange(n) * C - pad
    tt = ta[:, None] + np.arange(C)
    li = np.arange(n) % 32
    gw = np.arange(n) // 32
    top = li == 31
    u = np.where(act & (tt >= E) & (tt - E <= rl), -E, BIG).astype(np.int64)
    f = [0, rl if act and rl <= E + 1 else INF, 0]
    f[2] = 0 if f[1] <= 0 else INF

    def fold(f, cm, re):
        e, rmin, er = f
        rmin_n = min(rmin, re)
        e_unc = max(e, cm)
        e_cap = e if er < INF else max(e, min(cm, max(e, rmin_n)))
        e_n = e_cap if et else e_unc
        er_n = er if er < INF else (max(e, rmin_n) if rmin_n <= e_n else INF)
        return [e_n, rmin_n, er_n]

    nsteps = max(0, clen_b - off) if act else 0
    if nsteps:
        ch = np.vectorize(lambda i: _read_sym(rd, i))(tt - E)
        tb = ta + (32 - li) * C  # the cell above each lane's warp
        rcur = np.array([_read_sym(rd, tb[k] - E + li[k]) for k in range(n)])
        rnxt = np.array([_read_sym(rd, tb[k] - E + 32 + li[k])
                         for k in range(n)])
        cons_at = lambda j: int(cons[j]) if j < len(cons) else 0  # noqa
        ccur = np.array([cons_at(off + li[k]) for k in range(n)])
        cnxt = np.array([cons_at(off + 32 + li[k]) for k in range(n)])
        pend = None
        for q in range(nsteps):
            qi = q & 31
            if q and not qi:
                rcur, ccur = rnxt, cnxt
                rnxt = np.array([_read_sym(rd, q + 32 + tb[k] - E + li[k])
                                 for k in range(n)])
                cnxt = np.array([cons_at(off + q + 32 + li[k])
                                 for k in range(n)])
            sym = ccur[qi]  # broadcast of lane qi (every warp holds it)
            i0 = q + 1 - E
            hi = min(rl - i0, W - 1)  # the last cell to keep its base
            old0 = u[:, 0].copy()
            above = np.append(u[1:, 0], BIG)
            above[top] = BIG
            un = np.concatenate([u[:, 1:], above[:, None]], 1)
            sub = (ch != sym) & (ch != wc)
            # base - t: the diagonal, and the deletion from the cell above
            base = np.minimum(u + sub, un + 2)
            # padding and cells past the read's end get BIG; cells facing
            # positions below 0 stay at least BIG unmasked
            base = np.where((tt >= 0) & (tt <= hi), base, BIG)
            pre = np.minimum.accumulate(base, axis=1)
            incl = pre[:, -1].copy()
            for k in range(n):  # the lanes' scan, warp by warp
                if li[k]:
                    incl[k] = min(incl[k], incl[k - 1])
            x = np.where(li == 0, INT_MAX,
                         np.append(INT_MAX, incl[:-1])).astype(np.int64)
            if multi:
                wrun = incl[top]
                first = old0[li == 0]
                for k in range(n):
                    xin = INT_MAX
                    for v in range(gw[k]):
                        tv = ta[(v + 1) * 32 - 1] + C - 1
                        tot = wrun[v]
                        if 0 <= tv <= hi:
                            tot = min(tot, first[v + 1] + 2)
                        xin = min(xin, tot)
                    x[k] = min(x[k], xin)
                if q:
                    f = fold(f, int(pend[0].min()), int(pend[1].min()))
                for w in range(nwr - 1):
                    k = w * 32 + 31
                    tv = ta[k] + C - 1
                    if 0 <= tv <= hi:
                        pre[k, C - 1] = min(pre[k, C - 1], first[w + 1] + 2)
            # pass 2: one minimum with the chain from below per cell
            u = np.minimum(x[:, None], pre)
            # the cells past the read's end carry the chain of the cell
            # facing it, so the top cell gives that cell's value
            t_end = rl - i0
            re = (min(int(u[-1, -1]) + t_end, INF) if 0 <= t_end <= W - 1
                  else INF)
            cm = min(int((u + tt).min()), INF)
            if multi:
                # each warp's partials, folded a column late
                pend = np.array([
                    [min(int((u + tt)[gw == w].min()), INF)
                     for w in range(nwr)],
                    [re if w == nwr - 1 else INF for w in range(nwr)]])
            else:
                f = fold(f, cm, re)
            feed = rcur[gw * 32 + qi]  # each warp's chunk
            nb = np.append(ch[1:, 0], 0)
            nb[top] = feed[top]
            ch = np.concatenate([ch[:, 1:], nb[:, None]], 1)
        if multi:
            f = fold(f, int(pend[0].min()), int(pend[1].min()))
    cells = np.full(W, INF, dtype=np.int64)
    flat, fl = tt.ravel(), np.minimum(u + tt, INF).ravel()
    cells[flat[flat >= 0]] = fl[flat >= 0]
    return cells, f[0], f[1], f[2]


def replay_model(st, reads, rlen, wc, et, E, W, plan):
    """Every row of a store through :func:`replay_row`."""
    B, R = st["off"].shape
    D = np.zeros((B, R, W), dtype=np.int64)
    folds = np.zeros((3, B, R), dtype=np.int64)
    for b in range(B):
        for r in range(R):
            D[b, r], *fr = replay_row(
                st["cons"][b], int(st["clen"][b]), reads[r], int(rlen[r]),
                int(st["off"][b, r]), bool(st["act"][b, r]), wc, et, E, W,
                plan)
            folds[:, b, r] = fr
    return D, folds


def _store(seed, B, R, n, E, clens, late=(), inactive=()):
    """Reads of a random truth with ~5 % edits (symbols 0-3, wildcard 4
    here and there), slot b's consensus the truth with every (7 + b)th
    symbol changed; ``late`` rows anchored late with the read cut there,
    ``inactive`` rows off."""
    rng = np.random.default_rng(seed)
    truth = rng.integers(0, 4, n)
    L = 64
    while L < n + 8:
        L *= 2
    reads = np.full((R, L), -1, dtype=np.int16)
    rlen = np.zeros(R, dtype=np.int32)
    off = np.zeros((B, R), dtype=np.int32)
    for r in range(R):
        seq = [int(s) for s in truth]
        for _ in range(n // 20):
            k = int(rng.integers(0, len(seq)))
            op = int(rng.integers(0, 3))
            if op == 0:
                seq[k] = int(rng.integers(0, 5))
            elif op == 1:
                seq.insert(k, int(rng.integers(0, 4)))
            elif len(seq) > 1:
                del seq[k]
        o = dict(late).get(r, 0)
        seq = seq[o:]
        off[:, r] = o
        reads[r, :len(seq)] = seq
        rlen[r] = len(seq)
    C = 64
    while C < n + 8:
        C *= 2
    cons = np.zeros((B, C), dtype=np.int32)
    for b in range(B):
        row = truth.copy()
        row[:: 7 + b] = (row[:: 7 + b] + 1) % 4
        cons[b, :n] = row
    act = np.ones((B, R), dtype=bool)
    for b, r in inactive:
        act[b, r] = False
    st = dict(off=off, act=act, cons=cons,
              clen=np.array(clens, dtype=np.int32))
    return st, reads, rlen


def _plan(cells, row_warps, ctas):
    return replay_kernel.ReplayPlan(cells, row_warps, ctas, row_warps, 1, 0)


GEOMETRIES = {
    # W: the plan's own (a warp a row), then forced ones: a CTA and a
    # cluster at small W (boundaries between warps and CTAs inside the
    # band, whole warps of padding), and more cells a lane than the band
    # needs (padding across lanes)
    18: [None, _plan(2, 1, 1), _plan(1, 1, 2)],
    34: [None, _plan(1, 2, 1), _plan(1, 1, 2), _plan(3, 1, 1),
         _plan(2, 2, 1)],
    66: [None, _plan(1, 3, 1), _plan(1, 2, 2), _plan(2, 1, 2)],
    130: [None, _plan(3, 2, 1), _plan(1, 3, 2)],
}


@pytest.mark.parametrize("et", [False, True], ids=["no_et", "et"])
@pytest.mark.parametrize("W,k", [(W, k) for W, g in GEOMETRIES.items()
                                 for k in range(len(g))])
def test_replay_model_matches_twin_and_jax(W, k, et):
    """Growth: the register kernel's arithmetic on every placement equals
    ``replay_rows`` and ``_j_replay`` on a store with mixed anchors, an
    inactive row, a short and an empty slot."""
    plan = GEOMETRIES[W][k] or replay_kernel.plan_replay(8, W)
    E = (W - 2) // 2
    st, reads, rlen = _store(W + k, 2, 4, 90, E, (80, 0 if W == 18 else 37),
                             late=((2, 9), (3, 30)), inactive=((0, 1),))
    D, folds = replay_model(st, reads, rlen, 4, et, E, W, plan)
    t = {k2: torch.from_numpy(v) for k2, v in st.items()}
    got = ts.replay_rows(t["off"], t["act"], t["cons"], t["clen"],
                         torch.from_numpy(reads), torch.from_numpy(rlen), 4,
                         et, E, W)
    want = jax.device_get(_j_replay(
        st["off"], st["act"], st["cons"], st["clen"], reads, rlen, 4, et,
        W))
    for name, model, twin, ref in zip(("D", "e", "rmin", "er"),
                                      (D, *folds), got, want):
        np.testing.assert_array_equal(model, twin.numpy(), err_msg=name)
        np.testing.assert_array_equal(model, np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("W,geom,offset,want_ovf", [
    (18, None, 60, True), (34, None, 10, True),
    (66, _plan(1, 2, 2), 5, False), (66, _plan(1, 3, 1), 79, False),
    (130, None, 85, False)])
def test_activation_model_commit_rule(W, geom, offset, want_ovf):
    """Activation: one row restarted at ``offset`` over its slot's
    consensus; the row, its folds, ``off`` and ``act`` are committed only
    when ``e < E``, as ``activate_row_plain`` commits them."""
    E = (W - 2) // 2
    plan = geom or replay_kernel.plan_replay(1, W)
    st, reads, rlen = _store(W + offset, 2, 4, 90, E, (85, 40))
    cells, e, rmin, er = replay_row(st["cons"][0], 85, reads[2],
                                    int(rlen[2]), offset, True, 4, False, E,
                                    W, plan)
    state = {k: torch.from_numpy(v) for k, v in st.items()}
    state["D"] = torch.full((2, 4, W), INF, dtype=torch.int32)
    for name, v in (("e", 0), ("rmin", INF), ("er", INF)):
        state[name] = torch.full((2, 4), v, dtype=torch.int32)
    ovf = replay_kernel.activate_row_plain(state, 0, 2, offset,
                                           torch.from_numpy(reads),
                                           torch.from_numpy(rlen), 4, False)
    assert ovf == (e >= E) == want_ovf
    if not ovf:
        np.testing.assert_array_equal(state["D"][0, 2].numpy(), cells)
        assert [int(state[k][0, 2]) for k in ("e", "rmin", "er", "off")] == [
            e, rmin, er, offset]
