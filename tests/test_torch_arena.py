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
non-constant table and a node set with mixed offsets.  ``plan_arena`` is
checked without JAX.
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


@pytest.mark.parametrize("K,R,W,A", [
    (64, 16, 18, 4), (64, 64, 258, 4), (64, 32, 130, 5), (64, 256, 514, 4),
    (64, 16, 2050, 4), (1, 1, 4, 1), (64, 1024, 514, 128),
])
def test_plan_arena(K, R, W, A):
    plan = arena_kernel.plan_arena(K, R, W, A, 4096, 8192)
    warps = min(32, 2 * R)
    assert plan.threads == 32 * warps
    base = 16 * K + warps * 5 * A + 3 * A + 128
    stage = (2 * W + (W + 2) // 2 + 3) & ~3
    staged = 4 * (base + warps * stage) <= arena_kernel.SMEM_LIMIT
    assert plan.band == ("smem" if staged else "global")
    assert plan.smem_bytes == 4 * (base + (warps * stage if staged else 0))
    assert plan.smem_bytes <= arena_kernel.SMEM_LIMIT
    # the north stars' geometries stage their rows
    if (R, W) in ((16, 18), (64, 258), (32, 130), (256, 514)):
        assert plan.band == "smem"


@pytest.mark.parametrize("K,R,W,A,Lw,C", [
    (65, 16, 18, 4, 64, 64), (0, 16, 18, 4, 64, 64), (64, 16, 17, 4, 64, 64),
    (64, 16, 2, 4, 64, 64), (64, 16, 18, 129, 64, 64), (64, 0, 18, 4, 64, 64),
    (64, 16, 18, 4, 0, 64), (64, 16, 18, 4, 64, 1),
])
def test_plan_arena_raises_on_impossible_shape(K, R, W, A, Lw, C):
    with pytest.raises(ValueError):
        arena_kernel.plan_arena(K, R, W, A, Lw, C)


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
