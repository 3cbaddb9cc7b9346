"""The dual run kernel's launch planner and its vote fold order, on the CPU.

``plan_run_dual`` decides the geometry of the cluster kernel
``csrc/run_extend_dual.cu`` (cluster size, threads, reads per CTA, rows
per warp, band placement, shared memory); the kernel itself runs only on
the card (``chip_smoke.py``'s ``dual_kernel`` phase holds it bitwise to
``run_extend_dual_plain``).  The unit of work is a (side, read) row, and
both sides of a read sit in one CTA.  The kernel folds each side's
float32 votes per warp in read order, then per CTA over its warps, then
over the cluster's ranks; the fold-order tests show that this order and
the plain loop's take the same decision (``nominate_side``) on seeded
draws, weighted and not, dyadic and not, near ties and vote totals near
x.5 under a dynamic threshold table included.  No JAX here.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu_torch.ops import run_dual_kernel
from waffle_con_tpu_torch.ops.run_dual_kernel import (
    _nominate,
    nominate_side,
    plan_run_dual,
)
from waffle_con_tpu_torch.ops.run_kernel import MAX_CLUSTER, MAX_WARPS, SMEM_LIMIT
from waffle_con_tpu_torch.ops.torch_scorer import VOTE_EPS

SHAPES = [(64, 258), (60, 258), (1, 18), (256, 1026), (16, 18),
          (300, 514), (1024, 514), (4096, 18)]


def _owners(plan, R):
    """``(side, read) -> (rank, warp)`` as the kernel assigns rows:
    contiguous blocks of reads per CTA; a warp pair per read (side = warp
    parity) or both sides of a contiguous block of reads per warp."""
    owner = {}
    for rank in range(plan.cluster):
        r0 = rank * plan.reads_per_cta
        nloc = max(0, min(plan.reads_per_cta, R - r0))
        for warp in range(plan.threads // 32):
            if plan.rows_per_warp == 1:
                lo = min(warp >> 1, nloc)
                hi, sides = min(lo + 1, nloc), (warp & 1,)
            else:
                k = plan.rows_per_warp // 2
                lo = min(warp * k, nloc)
                hi, sides = min(lo + k, nloc), (0, 1)
            for lr in range(lo, hi):
                for sd in sides:
                    assert (sd, r0 + lr) not in owner, "row owned twice"
                    owner[sd, r0 + lr] = (rank, warp)
    return owner


@pytest.mark.parametrize("R,W", SHAPES)
def test_plan_covers_every_row_once_both_sides_in_one_cta(R, W):
    plan = plan_run_dual(R, W, 4)
    owner = _owners(plan, R)
    assert sorted(owner) == [(sd, r) for sd in (0, 1) for r in range(R)]
    for r in range(R):
        assert owner[0, r][0] == owner[1, r][0], f"read {r} split over CTAs"
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 32 * MAX_WARPS
    assert plan.rows_per_warp == 1 or plan.rows_per_warp % 2 == 0
    assert plan.smem_bytes <= SMEM_LIMIT


EXPECT = {
    # the dual north star: 8 CTAs of 16 warps, one row a warp, band on chip
    (64, 258): (8, 512, 8, 1, "smem"),
    # R not dividing the cluster: the last CTA owns 4 reads
    (60, 258): (8, 512, 8, 1, "smem"),
    (1, 18): (1, 64, 1, 1, "smem"),
    # 4.2 MB of band over 16 CTAs: too much for shared memory
    (256, 1026): (16, 512, 16, 2, "global"),
}


@pytest.mark.parametrize("R,W", SHAPES)
def test_plan_placement_rule(R, W):
    """The smallest cluster whose CTAs hold at most 16 rows, one row per
    warp, on chip; else 16 CTAs, both sides of several reads per warp, on
    chip when it fits (and a warp feeds at most 32 rings)."""
    A = 4
    plan = plan_run_dual(R, W, A)
    nw = plan.threads // 32
    on_chip = plan.band == "smem"
    assert plan.smem_bytes == run_dual_kernel._smem_bytes(
        plan.reads_per_cta, nw, W, A, on_chip)
    if (R, W) in EXPECT:
        assert (plan.cluster, plan.threads, plan.reads_per_cta,
                plan.rows_per_warp, plan.band) == EXPECT[R, W]
    if plan.rows_per_warp == 1:
        assert on_chip and nw == 2 * plan.reads_per_cta <= MAX_WARPS
        smaller = plan.cluster // 2
        if smaller:
            rpc = -(-R // smaller)
            assert 2 * rpc > MAX_WARPS or run_dual_kernel._smem_bytes(
                rpc, 2 * rpc, W, A, True) > SMEM_LIMIT
    else:
        assert plan.cluster == MAX_CLUSTER
        fits = run_dual_kernel._smem_bytes(plan.reads_per_cta, nw, W, A,
                                           True) <= SMEM_LIMIT
        assert on_chip == (fits and plan.rows_per_warp <= 32)


@pytest.mark.parametrize("R,W,A", [
    (256, 258, 256), (256, 66, 256), (1024, 258, 256), (14848, 258, 256)])
def test_plan_halves_the_warps_where_sixteen_overflow(R, W, A):
    """R = 256 at A = 256: 16 warps' histograms and partials overflow a
    CTA's shared memory, so the plan halves the warps until it fits; every
    row is still owned once, both sides of a read in one CTA, and a warp
    feeds at most 32 symbol rings when the band is on chip."""
    plan = plan_run_dual(R, W, A)
    nw = plan.threads // 32
    owner = _owners(plan, R)
    assert sorted(owner) == [(sd, r) for sd in (0, 1) for r in range(R)]
    assert all(owner[0, r][0] == owner[1, r][0] for r in range(R))
    assert plan.cluster == MAX_CLUSTER and plan.rows_per_warp % 2 == 0
    assert nw < min(MAX_WARPS, plan.reads_per_cta)
    assert plan.smem_bytes == run_dual_kernel._smem_bytes(
        plan.reads_per_cta, nw, W, A, plan.band == "smem") <= SMEM_LIMIT
    assert plan.band == "global" or plan.rows_per_warp <= 32
    assert run_dual_kernel._smem_bytes(plan.reads_per_cta, 2 * nw, W, A,
                                       False) > SMEM_LIMIT


@pytest.mark.parametrize("R,W,A", [(0, 18, 4), (16, 17, 4), (16, 18, 0),
                                   (16, 2, 4), (10**6, 514, 4),
                                   (16384, 258, 256)])
def test_plan_raises_on_impossible_shape(R, W, A):
    with pytest.raises(ValueError):
        plan_run_dual(R, W, A)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        run_dual_kernel.run_extend_dual_cuda(
            {"D": torch.zeros((2, 16, 18), dtype=torch.int32)}, 0, 1, None,
            None, None, None, None)


# ---------------------------------------------------------------------
# fold order


def _weights(e, act, weighted):
    """Per-read float32 vote weights of both sides, as the kernel and the
    plain loop compute them (``c_other / (c1 + c2)`` when both sides
    track the read under ``weighted``)."""
    f32 = np.float32
    w = act.astype(f32)
    if weighted:
        both = act[0] & act[1]
        c = np.maximum(e.astype(f32), f32(0.5))
        den = c[0] + c[1]
        w[0] = np.where(both, c[1] / den, w[0])
        w[1] = np.where(both, c[0] / den, w[1])
    return w


def _cluster_counts(occ, split, w, plan, sd):
    """The kernel's fold of side ``sd``'s votes: per warp in read order,
    per CTA over its warps in order, over the ranks in order; a read
    votes (c / split) * w for each tip symbol when w > 0 and split > 0."""
    R, A = occ.shape
    f32 = np.float32
    owners = _owners(plan, R)
    total = np.zeros(A, dtype=f32)
    has = np.zeros(A, dtype=bool)
    nonexact = False
    for rank in range(plan.cluster):
        cta = np.zeros(A, dtype=f32)
        for warp in range(plan.threads // 32):
            acc = np.zeros(A, dtype=f32)
            for r in sorted(r for (s, r), o in owners.items()
                            if s == sd and o == (rank, warp)):
                if not (w[r] > 0 and split[r] > 0):
                    continue
                votes = occ[r] > 0
                frac = occ[r].astype(f32) / f32(split[r]) * f32(w[r])
                acc = np.where(votes, acc + frac, acc).astype(f32)
                has |= votes
                nonexact |= bool(split[r] & (split[r] - 1))
            cta = cta + acc
        total = total + cta
    return total, has, nonexact


def _draw(rng, R, A, dyadic, half):
    """Both sides' tip histograms, distances and masks: each read votes
    for 1-4 tips (dyadic splits 1, 2, 4, or any of 1-7), mostly for one
    leading symbol; a few reads inactive on one side.  ``half``: every
    read votes, read pairs with mirrored distances (weights summing to
    about 1), the last read at equal distances (0.5 a side) and, for an
    even R, the one before it on side 1 only, so under ``weighted`` each
    side's vote total lies near x.5."""
    occ = np.zeros((2, R, A), dtype=np.int32)
    lead = rng.integers(A, size=2)
    for sd in (0, 1):
        for r in range(R):
            if rng.random() < 0.1 and not half:
                continue  # a read with no tip
            n = int(rng.choice([1, 2, 4])) if dyadic else int(rng.integers(1, 8))
            for _ in range(n):
                sym = lead[sd] if rng.random() < 0.6 else rng.integers(A)
                occ[sd, r, sym] += 1
    e = rng.integers(0, 9, size=(2, R)).astype(np.int32)
    act = rng.random((2, R)) > 0.05
    if half:
        act[:] = True
        n = 2 * ((R - 1) // 2)
        e[0, 1:n:2], e[1, 1:n:2] = e[1, 0:n:2], e[0, 0:n:2]
        e[:, R - 1] = 3
        if n + 1 < R:
            act[1, R - 2] = False
    return occ, occ.sum(2).astype(np.int32), e, act


@pytest.mark.parametrize("weighted", [False, True], ids=["plain", "weighted"])
@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "nondyadic"])
@pytest.mark.parametrize("R,W,A,wc", [(64, 258, 4, -2), (60, 258, 5, 4),
                                      (256, 1026, 4, -2)])
def test_cluster_fold_order_takes_the_plain_decision(R, W, A, wc, dyadic,
                                                     weighted):
    """Same ``(sym, dirty)`` from the cluster's fold order as from the
    plain loop's, side by side, over constant threshold tables around
    the leading count and a dynamic one (``mc_dyn``) with vote totals
    near x.5.  A dirty step commits nothing, so its symbol is compared
    only when the step is clean."""
    plan = plan_run_dual(R, W, A)
    rng = np.random.default_rng(R * 7 + A + 2 * dyadic + weighted)
    near_ties = halves = 0
    for draw in range(30):
        half = weighted and draw % 3 == 0
        occ, split, e, act = _draw(rng, R, A, dyadic, half)
        w = _weights(e, act, weighted)
        for sd in (0, 1):
            counts_c, has_c, nonexact_c = _cluster_counts(
                occ[sd], split[sd], w[sd], plan, sd)
            occ_t = torch.from_numpy(occ[sd])
            split_t = torch.from_numpy(split[sd])
            w_t = torch.from_numpy(w[sd])
            counts_p, has_p, nonexact_p = run_dual_kernel.dual_votes(
                occ_t, split_t, w_t)
            assert np.array_equal(has_p.numpy(), has_c)
            assert nonexact_p == nonexact_c
            if dyadic and not weighted:
                # dyadic votes of full weight sum exactly in any order
                assert np.array_equal(counts_p.numpy(), counts_c)
            top = float(counts_p.max())
            total = float(counts_p.sum())
            halves += abs(total - np.floor(total) - 0.5) < VOTE_EPS
            tables = [(np.array([m], dtype=np.int32), False)
                      for m in (1, int(top) - 1, int(top), int(top) + 1,
                                3 * R)]
            dyn = np.maximum(2, (np.arange(R + 2) * 0.3).astype(np.int32))
            tables.append((dyn.astype(np.int32), True))
            for tab, mc_dyn in tables:
                tab_t = torch.from_numpy(tab)
                dirty_p, sym_p = _nominate(occ_t, split_t, w_t, wc, weighted,
                                           tab_t, mc_dyn)
                dirty_c, sym_c = nominate_side(
                    torch.from_numpy(counts_c), torch.from_numpy(has_c),
                    nonexact_c, wc, weighted, tab_t, mc_dyn)
                assert dirty_p == dirty_c
                if not dirty_p:
                    assert sym_p == sym_c
                idx = min(max(int(np.round(counts_c.sum())), 0), len(tab) - 1)
                thr = min(float(tab[idx]), float(counts_c[has_c].max())
                          if has_c.any() else -1.0)
                near_ties += bool(
                    (np.abs(counts_c - thr) < VOTE_EPS)[has_c].any())
    assert near_ties > 0
    if weighted:
        assert halves > 0


def test_weighted_near_tie_across_ctas_is_dirty_in_either_order():
    """Two symbols whose votes differ by less than VOTE_EPS: eight reads,
    one in each CTA of the dual north star's plan, vote symbol 0 with the
    weight 400/801 (distances 401 and 400), four reads tracked on side 0
    only vote symbol 1 with full weight.  The leader is a near tie of the
    threshold, so the step is dirty in either fold order."""
    R, A = 64, 4
    plan = plan_run_dual(R, 258, A)
    assert plan.cluster == 8
    occ = np.zeros((R, A), dtype=np.int32)
    occ[0::8, 0] = 1
    occ[4::16, 1] = 1
    split = occ.sum(1).astype(np.int32)
    e = np.stack([np.full(R, 401), np.full(R, 400)]).astype(np.int32)
    act = np.ones((2, R), dtype=bool)
    act[1, 4::16] = False
    w = _weights(e, act, True)[0]
    counts_c, has_c, nonexact_c = _cluster_counts(occ, split, w, plan, 0)
    occ_t, split_t, w_t = (torch.from_numpy(x) for x in (occ, split, w))
    counts_p, _, _ = run_dual_kernel.dual_votes(occ_t, split_t, w_t)
    assert 0 < float(counts_p[1] - counts_p[0]) < VOTE_EPS
    for m in (1, 4, 10):
        tab = torch.tensor([m], dtype=torch.int32)
        a = _nominate(occ_t, split_t, w_t, -2, True, tab, False)
        b = nominate_side(torch.from_numpy(counts_c), torch.from_numpy(has_c),
                          nonexact_c, -2, True, tab, False)
        assert a[0] and b[0]
