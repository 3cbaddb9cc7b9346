"""The run kernel's launch planner and its vote fold order, on the CPU.

``plan_run`` decides the geometry of the cluster kernel
``csrc/run_extend.cu`` (cluster size, threads, reads per CTA and per warp,
band placement, shared memory); the kernel itself runs only on the card
(``chip_smoke.py``'s ``kernel`` phase holds it bitwise to
``run_extend_plain``).  The kernel folds the float32 votes per warp in
read order, then per CTA over its warps, then over the cluster's ranks;
the fold-order tests show that this order and the plain loop's take the
same decision (``nominate``) on seeded draws, exact and not, near ties
included.  No JAX here.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu_torch.ops import run_kernel
from waffle_con_tpu_torch.ops.run_kernel import (
    MAX_CLUSTER,
    MAX_WARPS,
    SMEM_LIMIT,
    nominate,
    plan_run,
    vote_counts,
)
from waffle_con_tpu_torch.ops.torch_scorer import VOTE_EPS

SHAPES = [(16, 18), (64, 258), (256, 514), (256, 1026), (300, 514),
          (1, 18), (1024, 514), (4096, 514)]


def _owners(plan, R):
    """``read -> (rank, warp)`` as the kernel assigns reads: contiguous
    blocks per CTA, contiguous blocks per warp within it."""
    owner = {}
    for rank in range(plan.cluster):
        r0 = rank * plan.reads_per_cta
        nloc = max(0, min(plan.reads_per_cta, R - r0))
        for warp in range(plan.threads // 32):
            lo = min(warp * plan.reads_per_warp, nloc)
            hi = min(lo + plan.reads_per_warp, nloc)
            for lr in range(lo, hi):
                assert r0 + lr not in owner, "read owned twice"
                owner[r0 + lr] = (rank, warp)
    return owner


@pytest.mark.parametrize("R,W", SHAPES)
def test_plan_covers_every_read_once(R, W):
    plan = plan_run(R, W, 4)
    assert sorted(_owners(plan, R)) == list(range(R))
    assert 1 <= plan.cluster <= MAX_CLUSTER
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 512
    assert plan.smem_bytes <= SMEM_LIMIT


@pytest.mark.parametrize("R,W", SHAPES)
def test_plan_placement_rule(R, W):
    """On chip whenever a cluster of at most 16 CTAs holds both band
    buffers and the symbol rings; one read per warp while 16 CTAs of 16
    warps suffice; the smallest such cluster."""
    A = 4
    plan = plan_run(R, W, A)
    nw = plan.threads // 32
    fits = run_kernel._smem_bytes(plan.reads_per_cta, nw, W, A, True)
    assert (plan.band == "smem") == (fits <= SMEM_LIMIT
                                     and plan.reads_per_warp <= 32)
    assert plan.smem_bytes == run_kernel._smem_bytes(
        plan.reads_per_cta, nw, W, A, plan.band == "smem")
    expect = {(1024, 514): "global", (4096, 514): "global"}
    assert plan.band == expect.get((R, W), "smem")
    if R <= MAX_CLUSTER * MAX_WARPS and plan.band == "smem":
        assert plan.reads_per_warp == 1
        smaller = plan.cluster // 2
        if smaller:
            rpc = -(-R // smaller)
            assert rpc > MAX_WARPS or run_kernel._smem_bytes(
                rpc, rpc, W, A, True) > SMEM_LIMIT
    # the north star and the dual north star spread over several CTAs
    if (R, W) in ((256, 514), (64, 258)):
        assert plan.cluster > 1 and plan.band == "smem"


@pytest.mark.parametrize("R,W,A", [
    (48000, 258, 256), (48000, 18, 256), (40000, 258, 256), (8208, 4, 4)])
def test_plan_halves_the_warps_where_sixteen_overflow(R, W, A):
    """Where 16 warps' histograms and partials overflow a CTA's shared
    memory (a wide alphabet, many reads) the plan halves the warps until
    it fits; every read is still owned once, and a warp feeds at most 32
    symbol rings when the band is on chip."""
    plan = plan_run(R, W, A)
    nw = plan.threads // 32
    assert sorted(_owners(plan, R)) == list(range(R))
    assert plan.cluster == MAX_CLUSTER
    assert plan.smem_bytes == run_kernel._smem_bytes(
        plan.reads_per_cta, nw, W, A, plan.band == "smem") <= SMEM_LIMIT
    assert plan.band == "global" or plan.reads_per_warp <= 32
    full = min(MAX_WARPS, plan.reads_per_cta)
    if nw < full:
        assert run_kernel._smem_bytes(plan.reads_per_cta, 2 * nw, W, A,
                                      False) > SMEM_LIMIT


@pytest.mark.parametrize("R,W,A", [(0, 18, 4), (16, 17, 4), (16, 18, 0),
                                   (10**7, 514, 4)])
def test_plan_raises_on_impossible_shape(R, W, A):
    with pytest.raises(ValueError):
        plan_run(R, W, A)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError):
        run_kernel.run_extend_cuda(
            {"D": torch.zeros((1, 16, 18), dtype=torch.int32)}, 0, None,
            None, None)


# ---------------------------------------------------------------------
# fold order


def _cluster_counts(occ, split, plan):
    """The kernel's float32 vote fold: per warp in read order, per CTA
    over its warps in order, over the ranks in order."""
    R, A = occ.shape
    f32 = np.float32
    total = np.zeros(A, dtype=f32)
    owners = _owners(plan, R)
    for rank in range(plan.cluster):
        cta = np.zeros(A, dtype=f32)
        for warp in range(plan.threads // 32):
            acc = np.zeros(A, dtype=f32)
            for r in sorted(r for r, o in owners.items() if o == (rank, warp)):
                if split[r] > 0:
                    acc = acc + occ[r].astype(f32) / f32(split[r])
            cta = cta + acc
        total = total + cta
    return total, (occ > 0).any(0)


def _draw(rng, R, A, dyadic):
    """Per-read tip histograms: each read votes for 1-4 tips (dyadic
    splits 1, 2, 4, or any of 1-7), mostly for one leading symbol."""
    occ = np.zeros((R, A), dtype=np.int32)
    lead = rng.integers(A)
    for r in range(R):
        if rng.random() < 0.1:
            continue  # a read with no tip
        n = int(rng.choice([1, 2, 4])) if dyadic else int(rng.integers(1, 8))
        for _ in range(n):
            sym = lead if rng.random() < 0.6 else rng.integers(A)
            occ[r, sym] += 1
    return occ, occ.sum(1).astype(np.int32)


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic", "nondyadic"])
@pytest.mark.parametrize("R,W,A,wc", [(256, 514, 4, -2), (300, 514, 5, 4),
                                      (1024, 514, 4, -2), (64, 258, 4, -2)])
def test_cluster_fold_order_takes_the_plain_decision(R, W, A, wc, dyadic):
    plan = plan_run(R, W, A)
    rng = np.random.default_rng(R * 7 + A + dyadic)
    near_ties = 0
    for _ in range(40):
        occ, split = _draw(rng, R, A, dyadic)
        all_exact = not bool(((split > 0) & ((split & (split - 1)) != 0)).any())
        counts_p, has_p = vote_counts(torch.from_numpy(occ),
                                      torch.from_numpy(split))
        counts_c, has_c = _cluster_counts(occ, split, plan)
        assert np.array_equal(has_p.numpy(), has_c)
        if all_exact:
            # dyadic votes sum exactly in any order
            assert np.array_equal(counts_p.numpy(), counts_c)
        top = float(counts_p.max())
        # thresholds around the leading count: a min_count above it makes
        # the maximum itself a near tie of the threshold
        for min_count in (1, int(top) - 1, int(top), int(top) + 1, 3 * R):
            got_p = nominate(counts_p, has_p, min_count, wc, all_exact, False)
            got_c = nominate(torch.from_numpy(counts_c), torch.from_numpy(has_c),
                             min_count, wc, all_exact, False)
            assert got_p == got_c
            thr = min(float(min_count), top)
            near_ties += bool(
                (np.abs(counts_c - thr) < VOTE_EPS)[has_c].any())
    assert near_ties > 0


def test_nominate_near_tie_of_two_symbols():
    """Two symbols 1/143 apart (splits 11 and 13, no dyadic vote): within
    VOTE_EPS of each other, so the leader is a near tie of the
    threshold and the step is dirty in either order."""
    occ = np.zeros((11, 4), dtype=np.int32)
    occ[:5, 0], occ[:5, 1] = 5, 6    # reads 0-4: split 11
    occ[5:, 0], occ[5:, 1] = 7, 6    # reads 5-10: split 13
    split = occ.sum(1).astype(np.int32)
    counts, has = vote_counts(torch.from_numpy(occ), torch.from_numpy(split))
    assert 0 < float(counts[0] - counts[1]) < VOTE_EPS
    counts_c, has_c = _cluster_counts(occ, split, plan_run(11, 18, 4))
    for min_count in (1, 5, 6):
        a = nominate(counts, has, min_count, -2, False, False)
        b = nominate(torch.from_numpy(counts_c), torch.from_numpy(has_c),
                     min_count, -2, False, False)
        assert a == b and a[2]
