"""The port's ``TorchScorer.run_arena`` against ``JaxScorer.run_arena``.

On the CPU the port runs the arena's plain twin
(``waffle_con_tpu_torch.ops.arena_kernel.arena_plain``); the JAX side runs
``_j_arena``.  Both scorers are brought to the same branch set through the
same root / push / activate calls, then one ``run_arena`` with the same
node specs and tracker windows.  Every returned field must be equal
exactly: the events, ``nsteps``, the stop code and node, per-node steps,
the appended symbols, each side's stats and activity, ``alive``, the
creation records (their fresh handles are each scorer's own, so only
their registration is checked) and the arena counters (JAX's
speculative-block keys ``arena_iters`` / ``arena_spec_events`` excepted:
the port runs one event per iteration).  The stats of every handle the
call returned must be equal afterwards too.  Scenarios reach each stop
code 1-5, a discard on the device, creation in both modes (singles,
split pairs, dual cross products), a full creation pool, weighted and L2
costs, fractional votes under ``split_relax``, ``mc_dyn`` with a
non-constant table and a node set with mixed offsets.  ``plan_arena``
(the cluster plan: every (side, read) row once, both sides of a read in
one CTA, the placements) and the cluster's rank-order fold of node
records are checked without JAX.
"""

import math

import numpy as np
import pytest
import torch

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu.utils.example_gen import corrupt, generate_test
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import arena_kernel
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

#: JAX counters of its speculative blocks (no counterpart in the port)
SPECULATIVE_KEYS = ("arena_iters", "arena_spec_events")
#: tracker windows and table lengths shared by every scenario, so the
#: JAX side compiles one arena per offset mode
LW = 1024
IMB_LEN = 1024


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(deletion=False):
    """Two haplotypes 2 SNPs apart (at 66 and 133), 6 reads each at 1 %;
    with ``deletion`` the last 3 reads of the first miss 12 bases at 30
    (a band of E=8 overflows there)."""
    truth, reads1 = generate_test(4, 200, 6, 0.01, seed=1)
    h2 = bytearray(truth)
    h2[66] = (h2[66] + 1) % 4
    h2[133] = (h2[133] + 2) % 4
    h2 = bytes(h2)
    reads2 = [corrupt(h2, 0.01, np.random.default_rng(50 + i))
              for i in range(6)]
    reads = list(reads1) + reads2
    if deletion:
        reads = list(reads1) * 2 + [r[:30] + r[42:] for r in reads1[:3]]
    return truth, h2, reads


def _scorers(reads, min_count=3):
    jcfg = JaxConfigBuilder().backend("jax").min_count(min_count).build()
    tcfg = (CdwfaConfigBuilder().backend("torch").device("cpu")
            .min_count(min_count).build())
    return JaxScorer(reads, jcfg), TorchScorer(reads, tcfg)


def _node(sc, cons, late=()):
    """A branch rooted on every read but ``late`` (``(read, offset)``
    pairs, activated after the pushes) and pushed through ``cons``."""
    act = np.ones(sc.num_reads, dtype=bool)
    for r, _o in late:
        act[r] = False
    h = sc.root(act)
    for k in range(len(cons)):
        sc.push(h, cons[: k + 1])
    for r, o in late:
        sc.activate(h, r, o, cons)
    return h


def _dump_stats(st):
    if st is None:
        return None
    return (st.eds.tolist(), st.occ.tolist(), st.split.tolist(),
            np.asarray(st.reached, bool).tolist())


def _run(sc, nodes, *, min_count=3, l2=False, weighted=False,
         me_budget=2**31 - 1, rest=(2**31 - 1, 0), step_limit=512,
         create_mode=2, mc_tab=None, split_relax=True, mc_dyn=False,
         pool=None, imb_min=0, thr=(0, 0)):
    """One ``run_arena`` over ``nodes`` (``[(side-1 consensus, side-2
    consensus or None, late reads)]``), node 0 the in-hand pop and the
    others queued: the trackers count the queued nodes at their lengths.
    Returns the comparable dump and the scorer's arena counters."""
    if pool is not None:
        sc.ARENA_POOL = pool
    specs, hands = [], []
    lc = np.zeros((2, LW), np.int32)
    for i, (c1, c2, late) in enumerate(nodes):
        h1 = _node(sc, c1, late)
        h2 = None if c2 is None else _node(sc, c2)
        specs.append((h1, h2, len(c1), 0 if c2 is None else len(c2)))
        hands.append((h1, c1))
        if h2 is not None:
            hands.append((h2, c2))
        if i:
            lc[int(c2 is not None), max(len(c1), len(c2 or b""))] += 1
    far = max(max(s[2], s[3]) for s in specs)
    tr = np.array([[thr[0], lc[0, thr[0]:].sum(), far, 0],
                   [thr[1], lc[1, thr[1]:].sum(), far, 0]], np.int32)
    n = len(sc.reads)
    tab = (np.full(n + 1, min_count, np.int32) if mc_tab is None
           else np.asarray(mc_tab, np.int32))
    before = dict(sc.counters)
    out = sc.run_arena(
        specs, me_budget, min_count, 20, imb_min, l2, weighted, rest[0],
        rest[1], 1000, 1000, step_limit, 1000, lc, np.zeros((2, LW), np.int32),
        tr, create_mode=create_mode, mc_tab=tab,
        imb_tab=np.full(IMB_LEN, imb_min, np.int32),
        split_relax=split_relax, mc_dyn=mc_dyn,
    )
    (events, nsteps, code, stop_node, node_steps, appended, stats, acts,
     alive, creations) = out
    for cre in creations:
        assert cre["h1"] in sc._slot_of
        assert (cre["h2"] is None) == (cre["kind"] == 0)
        hands.append((cre["h1"], b""))
        if cre["h2"] is not None:
            assert cre["h2"] in sc._slot_of
            hands.append((cre["h2"], b""))
    after = {k: v - before.get(k, 0) for k, v in sc.counters.items()
             if k.startswith("arena") and k not in SPECULATIVE_KEYS
             and v != before.get(k, 0)}
    dump = dict(
        events=events, nsteps=nsteps, code=code, stop_node=stop_node,
        node_steps=node_steps, appended=appended,
        stats=[_dump_stats(s) for s in stats],
        act=[None if a is None else np.asarray(a, bool).tolist()
             for a in acts],
        alive=alive,
        creations=[{k: v for k, v in c.items() if k not in ("h1", "h2")}
                   for c in creations],
        counters=after,
        # every returned handle's state, as the next pop would see it
        after=[_dump_stats(sc.stats(h, c)) for h, c in hands
               if h in sc._slot_of],
    )
    return dump


def _both(reads, nodes, min_count=3, **kw):
    js, ts = _scorers(reads, min_count)
    j = _run(js, nodes, min_count=min_count, **kw)
    t = _run(ts, nodes, min_count=min_count, **kw)
    for key in j:
        assert t[key] == j[key], key
    return t


def _late_reads():
    """The workload with reads 3 and 9 cut to start at 20 and 25."""
    truth, h2, reads = _workload()
    reads = list(reads)
    reads[3] = reads[3][20:]
    reads[9] = reads[9][25:]
    return truth, h2, reads


def test_step_limit_with_a_competitor():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:20], None, ()), (truth[:19], None, ())],
                step_limit=12)
    assert got["code"] == 4 and got["nsteps"] == 12


def test_rest_of_queue_wins():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:20], None, ()), (truth[:18], None, ())],
                rest=(0, 0))
    assert got["code"] == 3 and got["nsteps"] == 1


def test_host_arbitration_at_a_split_without_creation():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:60], None, ()), (truth[:58], None, ())],
                create_mode=0)
    assert got["code"] == 1
    assert any(k.startswith("arena_s1_") for k in got["counters"])


def test_reached_end():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:196], None, ()), (truth[:150], None, ())],
                step_limit=100)
    assert got["code"] == 2


def test_band_overflow():
    truth, _h2, reads = _workload(deletion=True)
    got = _both(reads, [(truth[:20], None, ()), (truth[:19], None, ())],
                min_count=4)
    assert got["code"] == 5


def test_discard_on_the_device():
    truth, _h2, reads = _workload()
    js, _ts = _scorers(reads)
    base = int(js.stats(_node(js, truth[:40]), truth[:40]).eds.sum())
    got = _both(reads, [(truth[:40], None, ()), (truth[:38], None, ()),
                        (truth[:39], None, ())], me_budget=base + 1)
    assert got["counters"].get("arena_discards", 0) > 0
    assert any(kind == "discard" for kind, _ in got["events"])


def test_single_children_mode_1():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:60], None, ()), (truth[:59], None, ())],
                create_mode=1)
    assert got["counters"]["arena_creations"] > 0
    assert all(c["kind"] == 0 for c in got["creations"])


def test_split_pairs_and_cross_products_mode_2():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:60], None, ()), (truth[:59], None, ())])
    kinds = {(c["kind"], c["parent"] >= 2) for c in got["creations"]}
    assert got["counters"]["arena_split_events"] >= 2
    # a single parent's split pair, and children of a dual child
    assert (1, False) in kinds and (1, True) in kinds


def test_full_creation_pool():
    truth, _h2, reads = _workload()
    got = _both(reads, [(truth[:60], None, ()), (truth[:59], None, ())],
                pool=2)
    assert got["code"] == 1
    diag = [k for k in got["counters"] if k.startswith("arena_s1_")]
    assert diag and all(int(k.split("_f")[1]) & 8 == 0 for k in diag)


@pytest.mark.parametrize("weighted,l2", [(True, False), (False, True)])
def test_dual_node_weighted_and_l2(weighted, l2):
    truth, h2, reads = _workload()
    got = _both(reads, [(truth[:100], h2[:100], ()),
                        (truth[:99], h2[:99], ())], weighted=weighted,
                l2=l2)
    assert got["nsteps"] > 0


def test_fractional_votes_under_split_relax():
    """Weighted dual votes are fractional: a clear-margin split is
    absorbed only through ``split_relax``."""
    truth, h2, reads = _workload()
    relaxed = _both(reads, [(truth[:60], truth[:60], ())], weighted=True)
    strict = _both(reads, [(truth[:60], truth[:60], ())], weighted=True,
                   split_relax=False)
    assert relaxed["nsteps"] > 0 and strict["nsteps"] > 0


def test_mc_dyn_table():
    truth, _h2, reads = _workload()
    n = len(reads)
    tab = [max(2, math.ceil(0.3 * k)) for k in range(n + 1)]
    got = _both(reads, [(truth[:60], None, ()), (truth[:59], None, ())],
                min_count=2, mc_tab=tab, mc_dyn=True, split_relax=False)
    assert got["nsteps"] > 0


def test_mixed_offsets():
    truth, _h2, reads = _late_reads()
    got = _both(reads, [(truth[:40], None, ((3, 20), (9, 25))),
                        (truth[:39], None, ((3, 20),))])
    assert got["nsteps"] > 0


# ---------------------------------------------------------------------
# the launch planner (no JAX)


def _arena_owners(plan, R):
    """``(side, read) -> (rank, warp)`` as the kernel assigns a commit's
    rows: contiguous blocks of ``reads_per_cta`` reads per CTA; row ``q =
    side * reads_per_cta + local read`` of a CTA to warp ``q % warps``."""
    nw = plan.threads // 32
    owner = {}
    for rank in range(plan.cluster):
        r0 = rank * plan.reads_per_cta
        nloc = max(0, min(plan.reads_per_cta, R - r0))
        for q in range(2 * plan.reads_per_cta):
            sd, lr = divmod(q, plan.reads_per_cta)
            if lr < nloc:
                assert (sd, r0 + lr) not in owner, "row owned twice"
                owner[sd, r0 + lr] = (rank, q % nw)
    return owner


def _placement_rule(K, R, W, A, Lw):
    """The documented rule, written out: the smallest cluster of at most
    16 rows a CTA, then the first placement that fits, in the order band,
    trackers, records (shared memory before device memory), the fold
    round from 8 nodes down."""
    c = 1
    while c < 16 and 2 * -(-R // c) > 16:
        c *= 2
    rpc = -(-R // c)
    for band in (True, False):
        for trk in (True, False):
            for rec in (True, False):
                for fold in (8, 4, 2, 1):
                    smem = arena_kernel._smem_bytes(K, A, rpc, c, fold, W,
                                                    Lw, band, rec, trk)
                    if smem <= arena_kernel.SMEM_LIMIT:
                        return c, rpc, band, rec, trk, fold, smem
    return None


@pytest.mark.parametrize("K,R,W,A", [
    (64, 16, 18, 4), (64, 64, 258, 4), (64, 32, 130, 5), (64, 256, 514, 4),
    (64, 16, 2050, 4), (1, 1, 4, 1), (64, 1024, 514, 128),
    (64, 8, 18, 4), (64, 7, 18, 4), (64, 9, 66, 4), (64, 13, 258, 4),
    (64, 33, 258, 4), (64, 65, 258, 4), (64, 128, 258, 4), (64, 64, 258, 128),
    (32, 100, 1026, 5),
])
def test_plan_arena(K, R, W, A):
    plan = arena_kernel.plan_arena(K, R, W, A, 4096, 8192)
    nw = plan.threads // 32
    # every (side, read) row once, both sides of a read in one CTA
    owner = _arena_owners(plan, R)
    assert sorted(owner) == [(sd, r) for sd in (0, 1) for r in range(R)]
    for r in range(R):
        assert owner[0, r][0] == owner[1, r][0], f"read {r} split over CTAs"
    assert 1 <= plan.cluster <= 16 and 1 <= nw <= 16
    assert plan.threads == 32 * min(16, 2 * plan.reads_per_cta)
    assert plan.rows_per_warp == -(-2 * plan.reads_per_cta // nw)
    # one row a warp whenever 16 CTAs can hold the rows that way
    assert (plan.rows_per_warp == 1) == (R <= 128)
    assert plan.smem_bytes <= arena_kernel.SMEM_LIMIT
    c, rpc, band, rec, trk, fold, smem = _placement_rule(K, R, W, A, 4096)
    assert (plan.cluster, plan.reads_per_cta, plan.band, plan.records,
            plan.trackers, plan.fold_nodes, plan.smem_bytes) == (
        c, rpc, "smem" if band else "global", "smem" if rec else "global",
        "smem" if trk else "global", fold, smem)
    # the north stars' geometries stage their rows
    if (R, W) in ((16, 18), (64, 258), (32, 130), (256, 514)):
        assert plan.band == "smem"


#: (K, R, W, A, Lw) -> (cluster, threads, reads per CTA, rows per warp,
#: band, records, trackers, fold nodes)
PLACEMENTS = {
    # the dual north star: 8 CTAs of 16 warps, everything in shared memory
    (64, 64, 258, 4, 8192): (8, 512, 8, 1, "smem", "smem", "smem", 8),
    # the priority north star's level-1 dual group
    (64, 32, 130, 4, 4096): (4, 512, 8, 1, "smem", "smem", "smem", 8),
    # W = 514 at the largest cluster: the trackers move out, then the
    # fold round shrinks to 4 nodes
    (64, 256, 514, 4, 4096): (16, 512, 16, 2, "smem", "smem", "global", 4),
    # W = 514 at Lw = 8192: the trackers move to device memory
    (64, 64, 514, 4, 8192): (8, 512, 8, 1, "smem", "smem", "global", 8),
    # W = 2050: the rows step in device memory
    (64, 16, 2050, 4, 4096): (2, 512, 8, 1, "global", "smem", "smem", 8),
    (64, 16, 2050, 4, 8192): (2, 512, 8, 1, "global", "smem", "smem", 8),
    # A = 128: the records' vote rows move to device memory
    (64, 64, 258, 128, 8192): (8, 512, 8, 1, "smem", "global", "global", 2),
    (64, 1024, 514, 128, 4096): (16, 512, 64, 8, "global", "global",
                                 "global", 1),
    # one CTA (R <= 8), an odd R, four CTAs, sixteen
    (64, 8, 18, 4, 1024): (1, 512, 8, 1, "smem", "smem", "smem", 8),
    (64, 5, 18, 4, 1024): (1, 320, 5, 1, "smem", "smem", "smem", 8),
    (64, 13, 258, 4, 1024): (2, 448, 7, 1, "smem", "smem", "smem", 8),
    (64, 32, 18, 4, 1024): (4, 512, 8, 1, "smem", "smem", "smem", 8),
    (64, 65, 258, 4, 8192): (16, 320, 5, 1, "smem", "smem", "smem", 8),
}


@pytest.mark.parametrize("shape", sorted(PLACEMENTS))
def test_plan_arena_placements(shape):
    plan = arena_kernel.plan_arena(*shape, 8192)
    assert tuple(plan)[:-1] == PLACEMENTS[shape]
    K, R, W, A, Lw = shape
    assert plan.smem_bytes == arena_kernel._smem_bytes(
        K, A, plan.reads_per_cta, plan.cluster, plan.fold_nodes, W, Lw,
        plan.band == "smem", plan.records == "smem",
        plan.trackers == "smem")
    assert plan.smem_bytes <= arena_kernel.SMEM_LIMIT


@pytest.mark.parametrize("K,R,W,A,Lw,C", [
    (65, 16, 18, 4, 64, 64), (0, 16, 18, 4, 64, 64), (64, 16, 17, 4, 64, 64),
    (64, 16, 2, 4, 64, 64), (64, 16, 18, 129, 64, 64), (64, 0, 18, 4, 64, 64),
    (64, 16, 18, 4, 0, 64), (64, 16, 18, 4, 64, 1),
    # per-CTA state beyond shared memory even with everything movable moved
    (64, 10**6, 18, 4, 64, 64), (64, 4096, 18, 128, 64, 64),
])
def test_plan_arena_raises_on_impossible_shape(K, R, W, A, Lw, C):
    with pytest.raises(ValueError):
        arena_kernel.plan_arena(K, R, W, A, Lw, C)


def test_scratch_holds_each_cta_copy():
    plan = arena_kernel.plan_arena(64, 1024, 514, 128, 4096, 8192)
    assert (plan.band, plan.records, plan.trackers) == ("global",) * 3
    assert arena_kernel.scratch_words(plan, 64, 1024, 514, 128, 4096) == (
        2 * 1024 * 514 + 16 * 4 * 64 * 128 + 16 * 4 * 4096)
    plan = arena_kernel.plan_arena(64, 64, 258, 4, 8192, 8192)
    assert arena_kernel.scratch_words(plan, 64, 64, 258, 4, 8192) == 1


# ---------------------------------------------------------------------
# the cluster's fold of node records (no JAX)


def _cluster_record(dual, sides, clen2, args, mc_tab, imb_tab, rpc):
    """A node's record as the kernel's cluster takes it: per CTA (blocks
    of ``rpc`` reads) a partial of ``_node_eval``'s quantities — wrapping
    cost sum, largest distance, active counts, the reach / finish flags
    with each "all" as the OR of its negation, non-dyadic splits, both
    sides' float32 votes summed in read order — folded in rank order, then
    the nomination on the folded votes (``record_fold`` in
    ``csrc/arena.cu``)."""
    f32 = np.float32
    eds1, occ1, split1, reached1, a1 = sides[0]
    R, A = occ1.shape
    if dual:
        eds2, occ2, split2, reached2, a2 = sides[1]
    else:
        eds2 = split2 = np.zeros(R, np.int64)
        occ2 = np.zeros_like(occ1)
        reached2 = a2 = np.zeros(R, bool)
    a1, a2 = np.asarray(a1, bool), np.asarray(a2, bool) & dual
    r1, r2 = a1 & reached1, a2 & reached2
    e1, e2 = np.where(a1, eds1, 0), np.where(a2, eds2, 0)
    parts = []
    for r0 in range(0, R, rpc):
        tot, mx, n1, n2 = 0, 0, 0, 0
        fl = dict.fromkeys(("nall_rr", "any_rr", "nall_f1", "any_f1",
                            "nall_f2", "any_f2", "any_r1", "nondy1",
                            "nondy2"), False)
        cnt = np.zeros((2, A), f32)
        hv = np.zeros((2, A), bool)
        for r in range(r0, min(R, r0 + rpc)):
            c = [int(arena_kernel._wrap32(e * e)) if args.l2 else int(e)
                 for e in (e1[r], e2[r])]
            if dual:
                best = min(c[0] if a1[r] else arena_kernel.BIG,
                           c[1] if a2[r] else arena_kernel.BIG)
                tot += best if a1[r] or a2[r] else 0
            else:
                tot += c[0] if a1[r] else 0
            mx = max(mx, int(e1[r]), int(e2[r]))
            rr = r1[r] or r2[r]
            fl["nall_rr"] |= not (rr or (not a1[r] and not a2[r]))
            fl["any_rr"] |= rr
            fl["nall_f1"] |= a1[r] and not r1[r]
            fl["any_f1"] |= r1[r]
            fl["nall_f2"] |= a2[r] and not r2[r]
            fl["any_f2"] |= r2[r]
            fl["any_r1"] |= r1[r]
            n1 += int(a1[r])
            n2 += int(a2[r])
            for sd, (act, sp, occ) in enumerate(((a1, split1, occ1),
                                                 (a2, split2, occ2))):
                if not act[r]:
                    continue
                s = int(sp[r])
                fl[f"nondy{sd + 1}"] |= s > 0 and (s & (s - 1)) != 0
                w = f32(1)
                if args.weighted and dual and a1[r] and a2[r]:
                    c1f = max(f32(eds1[r]), f32(0.5))
                    c2f = max(f32(eds2[r]), f32(0.5))
                    w = f32((c1f if sd else c2f) / f32(c1f + c2f))
                for k in range(A):
                    if s > 0 and occ[r, k] > 0:
                        term = f32(f32(f32(occ[r, k]) / f32(s)) * w)
                        cnt[sd, k] = f32(cnt[sd, k] + term)
                        hv[sd, k] = True
        parts.append((tot, mx, n1, n2, fl, cnt, hv))
    # the fold, in rank order
    tot = sum(p[0] for p in parts) % (1 << 32)
    mx = max(p[1] for p in parts)
    n1, n2 = sum(p[2] for p in parts), sum(p[3] for p in parts)
    fl = {k: any(p[4][k] for p in parts) for k in parts[0][4]}
    cnt = np.zeros((2, A), f32)
    for p in parts:
        cnt = (cnt + p[5]).astype(f32)
    hv = np.logical_or.reduce([p[6] for p in parts])
    et = bool(args.et)
    fin1 = not fl["nall_f1"] if et else fl["any_f1"]
    fin2 = not fl["nall_f2"] if et else fl["any_f2"]
    if dual:
        reach = not fl["nall_rr"] if et else fl["any_rr"]
    else:
        reach = not fl["nall_f1"] if et else fl["any_r1"]
    covf = bool(args.l2) and mx > 2048
    out = dict(total=int(arena_kernel._wrap32(tot)), reach=reach,
               fin=(fin1, fin2), covf=covf, sym=[0, 0], mc=[0, 0],
               ex=[False, False], nt=[False, False])
    dirty = covf
    eps = f32(arena_kernel.VOTE_EPS)
    for sd in range(2 if dual else 1):
        c, h = cnt[sd], hv[sd]
        if 0 <= args.wc < A and h.sum() > 1:
            h[args.wc], c[args.wc] = False, f32(0)
        nvf = f32(0)
        for k in range(A):
            nvf = f32(nvf + c[k])
        nvr = f32(np.rint(nvf))
        tab_bad = bool(args.mc_dyn) and not abs(f32(nvf - nvr)) < eps
        exact = not fl[f"nondy{sd + 1}"] and not args.weighted and not tab_bad
        mc = int(mc_tab[min(max(int(nvr), 0), len(mc_tab) - 1)])
        maxc = max([c[k] for k in range(A) if h[k]], default=f32(-1))
        thr = min(f32(mc), maxc)
        passing = h & (c >= thr)
        near = bool(abs(f32(maxc - f32(mc))) < eps) or bool(
            (h & (np.abs(c - thr) < eps)).any())
        dirty |= ((not exact and near) or int(passing.sum()) != 1
                  or int(h.sum()) == 0 or tab_bad)
        if sd == 1:
            dirty |= fin1 or fin2
        out["sym"][sd] = int(np.argmax(np.where(passing, c, f32(-1))))
        out["mc"][sd], out["ex"][sd], out["nt"][sd] = mc, exact, near
    nlen = max(clen2) if dual else clen2[0]
    imb_v = int(imb_tab[min(max(nlen, 0), len(imb_tab) - 1)])
    out.update(dirty=dirty, imb=dual and (n1 < imb_v or n2 < imb_v),
               cnt=cnt, hv=hv)
    return out


def _gates(cnt, hv, mc):
    """The creation gates' vote tests of one side (``decide``): the
    passing symbols and whether every candidate clears ``mc`` by
    VOTE_EPS."""
    f32, eps = np.float32, np.float32(arena_kernel.VOTE_EPS)
    maxc = np.where(hv, cnt, f32(-1)).max()
    passing = hv & (cnt >= min(f32(mc), maxc))
    margin = bool(np.where(hv, np.abs(cnt - f32(mc)) > eps, True).all())
    return passing.tolist(), margin


FOLD_SCENARIOS = {
    "weighted": (lambda t, h2: [(t[:100], h2[:100], ()), (t[:99], h2[:99], ())],
                 dict(weighted=True)),
    "l2": (lambda t, h2: [(t[:100], h2[:100], ()), (t[:99], h2[:99], ())],
           dict(l2=True)),
    "split_relax": (lambda t, h2: [(t[:60], t[:60], ())],
                    dict(weighted=True)),
    "mc_dyn": (lambda t, h2: [(t[:60], None, ()), (t[:59], None, ())],
               dict(min_count=2, mc_dyn=True, split_relax=False)),
}


@pytest.mark.parametrize("scenario", sorted(FOLD_SCENARIOS))
def test_cluster_fold_takes_the_plain_decisions(scenario, monkeypatch):
    """Every record ``arena_plain`` takes in the scenario, taken again as
    the kernel's cluster folds it (per-CTA partials in rank order) at the
    plan's reads per CTA and at two other splits, gives the same record
    and the same creation-gate tests; the vote counts agree to float32
    rounding."""
    truth, h2, reads = _workload()
    make_nodes, kw = FOLD_SCENARIOS[scenario]
    kw = dict(kw)
    min_count = kw.pop("min_count", 3)
    if kw.get("mc_dyn"):
        kw["mc_tab"] = [max(2, math.ceil(0.3 * k))
                        for k in range(len(reads) + 1)]
    ts = TorchScorer(reads, CdwfaConfigBuilder().backend("torch")
                     .device("cpu").min_count(min_count).build())
    calls = []
    orig = arena_kernel._node_eval

    def recording(rec, n, dual, sides, clen2, args, mc_tab, imb_tab):
        orig(rec, n, dual, sides, clen2, args, mc_tab, imb_tab)
        calls.append((dual, sides, clen2, args, mc_tab, imb_tab, dict(
            total=int(rec.total[n]), reach=bool(rec.reach[n]),
            dirty=bool(rec.dirty[n]), sym=rec.sym[n].tolist(),
            imb=bool(rec.imb[n]), fin=tuple(rec.fin[n].tolist()),
            covf=bool(rec.covf[n]), ex=rec.ex[n].tolist(),
            mc=rec.mc[n].tolist(), nt=rec.nt[n].tolist(),
            cnt=rec.cnt[n].copy(), hv=rec.hv[n].copy())))

    monkeypatch.setattr(arena_kernel, "_node_eval", recording)
    _run(ts, make_nodes(truth, h2), min_count=min_count, **kw)
    assert len(calls) >= 5
    R = ts._state["D"].shape[1]
    plan = arena_kernel.plan_arena(64, R, ts._state["D"].shape[2],
                                   ts.num_symbols, LW, ts._C)
    fractional = 0
    for dual, sides, clen2, args, mc_tab, imb_tab, want in calls:
        sides = [s if s is None else tuple(np.asarray(x) for x in s)
                 for s in sides]
        fractional += bool((want["cnt"] % 1).any())
        for rpc in sorted({plan.reads_per_cta, 1, 5}):
            got = _cluster_record(dual, sides, clen2, args, mc_tab, imb_tab,
                                  rpc)
            for key in ("total", "reach", "dirty", "imb", "fin", "covf"):
                assert got[key] == want[key], (key, rpc)
            nsides = 2 if dual else 1
            for key in ("sym", "mc", "ex", "nt"):
                assert got[key][:nsides] == want[key][:nsides], (key, rpc)
            assert (got["hv"] == want["hv"]).all()
            np.testing.assert_allclose(got["cnt"], want["cnt"], rtol=1e-6,
                                       atol=1e-6)
            for sd in range(nsides):
                assert _gates(got["cnt"][sd], got["hv"][sd],
                              want["mc"][sd]) == _gates(
                    want["cnt"][sd], want["hv"][sd], want["mc"][sd])
    if scenario in ("weighted", "split_relax"):
        assert fractional, "no fractional vote reached"


def test_cuda_wrapper_refuses_cpu_tensors():
    _truth, _h2, reads = _workload()
    ts = _scorers(reads)[1]
    with pytest.raises(ValueError):
        arena_kernel.arena_cuda(ts._state, ts._reads, ts._rlen, [0, 1], [0],
                                np.zeros((2, 8)), np.zeros((2, 8)),
                                np.zeros((2, 4)), np.zeros(4), np.zeros(8),
                                None)


def test_layouts_are_contiguous():
    out = arena_kernel.arena_out_layout(64, 16, 4, 512)
    spans = sorted(out.values())
    assert spans[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    inp = arena_kernel.arena_in_layout(64, 1024, 32, 1024)
    assert inp["params"] == (0, arena_kernel.N_PARAMS)
    assert inp["imb_tab"][1] == arena_kernel.N_PARAMS + 128 + 64 + 8 + 4096 + 32 + 1024
