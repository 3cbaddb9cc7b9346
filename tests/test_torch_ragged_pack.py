"""The gang launch's packing (``ops/ragged_kernel.py``'s ``pack_members``
and ``plan_members``, ``csrc/run_ragged.cu``'s ``RaggedMember``) on the
CPU.

* Packing as pure Python: members packed by their own ``plan_run``
  cluster ``c``, first fit decreasing, into clusters of the largest
  ``c``; ``mixed3`` ((32, 130), (64, 258), (256, 514)) takes 2 clusters,
  ``mixed8`` (one (256, 514) and seven (32, 130)) 2, eight north-star
  members 8; the unpacked plan a cluster a member; random groups never
  overlap and never leave a cluster that a later one could have held.
* The descriptors: ``_Member`` carries each member's ``(cluster, base)``
  and ``c`` as the kernel's ``RaggedMember`` does, last.
* ``run_members_plain`` on a packed group of members from four stores of
  different R and W equals each member run alone, and the JAX package's
  ``_j_run_ragged`` on one pool shape holding the same members (built as
  ``tests/test_torch_ragged.py`` builds it), exactly.

The kernel itself runs only on a card (``tests/test_torch_fused_kernels.py``
and ``chip_smoke.py``'s ``gang_kernel`` and ``serve_kernel``).
"""

import ctypes

import numpy as np
import pytest
import torch

from waffle_con_tpu.ops.ragged import ArenaConfig, BandArena
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import ragged_kernel as rgk
from waffle_con_tpu_torch.ops import run_kernel as rk
from waffle_con_tpu_torch.ops.ragged import JP_COLS
from waffle_con_tpu_torch.ops.torch_scorer import INF, TorchScorer
from waffle_con_tpu_torch.utils.example_gen import generate_test

P, W, L, C, G1, A = 128, 34, 256, 512, 9, 8
BIG = 2**31 - 1
CAP = 16384


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------
# packing


def _check_packing(plan, sizes):
    """Every member inside its cluster, no two on one CTA, the counts."""
    csize = plan.run.cluster
    assert csize == max(sizes)
    taken = set()
    for (cl, base), c in zip(plan.slots, sizes):
        assert 0 <= cl < plan.clusters and 0 <= base and base + c <= csize
        cells = {(cl, base + i) for i in range(c)}
        assert not cells & taken
        taken |= cells
    assert plan.ctas == sum(sizes)
    assert {cl for cl, _b in plan.slots} == set(range(plan.clusters))


def test_mixed3_packs_into_two_clusters():
    shapes = [(32, 130, 4, CAP), (64, 258, 4, CAP), (256, 514, 4, CAP)]
    plan = rgk.plan_members(shapes)
    sizes = [p.cluster for p in plan.plans]
    assert sizes == [2, 4, 16]
    assert plan.clusters == 2 and plan.ctas == 22
    # the 16-CTA member alone, the 4- and 2-CTA members share a cluster
    assert plan.slots == ((1, 4), (1, 0), (0, 0))
    _check_packing(plan, sizes)
    # the launch's geometry is the unpacked one's
    unpacked = rgk.plan_members(shapes, packed=False)
    assert unpacked.run == plan.run and unpacked.plans == plan.plans
    assert unpacked.clusters == 3
    assert unpacked.slots == ((0, 0), (1, 0), (2, 0))
    # one cluster a member: every member holds all 16 CTAs of its own
    assert unpacked.spans == (16, 16, 16) and unpacked.ctas == 48
    assert plan.spans == (2, 4, 16)


def test_mixed8_packs_into_two_clusters():
    shapes = [(256, 514, 4, CAP)] + [(32, 130, 4, CAP)] * 7
    plan = rgk.plan_members(shapes)
    sizes = [p.cluster for p in plan.plans]
    assert sizes == [16] + [2] * 7
    assert plan.clusters == 2 and plan.ctas == 30
    assert plan.slots == ((0, 0),) + tuple((1, 2 * i) for i in range(7))
    _check_packing(plan, sizes)
    unpacked = rgk.plan_members(shapes, packed=False)
    assert (unpacked.clusters, unpacked.ctas) == (8, 128)


def test_eight_north_star_members_take_eight_clusters():
    plan = rgk.plan_members([(256, 514, 4, CAP)] * 8)
    assert plan.run == rk.plan_run(256, 514, 4)
    assert plan.clusters == 8 and plan.ctas == 128
    assert plan.slots == tuple((g, 0) for g in range(8))


def test_one_shape_is_a_cluster_a_member():
    """The frontier gang's case: members of one shape fill a cluster
    each, as before the packing."""
    for G, R, Wd in [(2, 16, 18), (4, 64, 258), (8, 32, 130)]:
        plan = rgk.plan_ragged(G, R, Wd, 4, 512)
        assert plan.clusters == G
        assert plan.slots == tuple((g, 0) for g in range(G))


@pytest.mark.parametrize("seed", range(6))
def test_pack_members_first_fit_decreasing(seed):
    rng = np.random.default_rng(seed)
    sizes = [int(x) for x in 2 ** rng.integers(0, 5, size=rng.integers(
        1, 9))]
    csize = max(sizes)
    slots, clusters = rgk.pack_members(sizes, csize)
    used = [0] * clusters
    for (cl, base), c in zip(slots, sizes):
        assert base + c <= csize
        used[cl] += c
    # powers of two packed largest first fill every cluster but the last
    assert all(u == csize for u in used[:-1])
    assert clusters == -(-sum(sizes) // csize)
    with pytest.raises(ValueError):
        rgk.pack_members([4, 8], 4)


def test_descriptor_carries_the_place():
    names = [n for n, _t in rgk._Member._fields_]
    assert names[-3:] == ["cluster", "base", "ctas"]
    assert ctypes.sizeof(rgk._Member) == 18 * 8 + 22 * 4


# ---------------------------------------------------------------------
# a packed group through the plain gang, and JAX's _j_run_ragged


@pytest.fixture(scope="module")
def jax_ragged():
    return BandArena(ArenaConfig())._build_kernel()


def _store(n, E, seed, length=160):
    truth, reads = generate_test(4, length, n, 0.02, seed=seed)
    cfg = (CdwfaConfigBuilder().backend("torch").device("cpu")
           .initial_band(E).min_count(3).build())
    sc = TorchScorer(reads, cfg)
    h = sc.root(np.ones(sc.num_reads, dtype=bool))
    prefix = 6 + seed % 5
    for k in range(prefix):
        sc.push(h, truth[: k + 1])
    return sc, sc._slot_of[h], prefix, truth


def _members():
    """Four stores: R 64 / W 34 (4 CTAs), R 32 / W 18 (2), R 16 / W 34
    and R 16 / W 18 (1 each): 128 pool rows, two packed clusters."""
    out = []
    for n, E, seed, kw in [(64, 16, 41, dict(ms=30)),
                           (32, 8, 42, dict(ms=25, first=True)),
                           (16, 16, 43, dict(ms=40)),
                           (9, 8, 44, dict(ms=35, first=True))]:
        sc, slot, prefix, truth = _store(n, E, seed)
        fs = sc.sym_id[truth[prefix]] if kw.get("first") else -1
        out.append((sc, slot, rgk.Member(
            sc._state, slot, sc._reads, sc._rlen, prefix, BIG, BIG, 0,
            kw["ms"], fs, 3, False, sc._wc, sc._et, sc.num_symbols)))
    return out


def _copy(m):
    return m._replace(state={k: v.clone() for k, v in m.state.items()})


def _jax_pool(members):
    """``tests/test_torch_ragged.py``'s pool: member g on its own rows of
    a P-row pool at width W, a narrower member's rows strided ``wrow``."""
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
    rows, row0 = [], 0
    for g, (sc, slot, m) in enumerate(members):
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
        jp[g] = (1, m.me_budget, m.other_cost, m.other_len, m.min_count,
                 int(m.l2), m.max_steps, m.first_sym, m.wc, int(m.et))
        rows.append((rs, w))
        row0 += R
    assert row0 == P
    return (reads, rlen, D, e, rmin, er, off, act, seg, wrow, cons, clen,
            jp), rows


def test_packed_plain_gang_equals_each_member_alone_and_jax(jax_ragged):
    members = _members()
    ms = [m for _sc, _s, m in members]
    plan = rgk.plan_members([m.shape() for m in ms])
    assert [p.cluster for p in plan.plans] == [4, 2, 1, 1]
    assert plan.clusters == 2
    group = [_copy(m) for m in ms]
    outs, dep = rgk.run_members_plain(group, in_place=True)
    assert dep is None
    pool, rows = _jax_pool(members)
    want = jax_ragged(*pool, A=A, cols=1)
    (jD, je, jrmin, jer, jcons, jclen, jsteps, jcode) = (
        np.asarray(x) for x in want[:8])
    codes = set()
    for g, (m, got_m, out) in enumerate(zip(ms, group, outs)):
        alone = _copy(m)
        out1, _ = rgk.run_members_plain([alone], in_place=True)
        assert torch.equal(out, out1[0]), g
        for k in m.state:
            assert torch.equal(got_m.state[k], alone.state[k]), (g, k)
        R, Wm, Am, _C = m.shape()
        res = rk.unpack(out.numpy(), R, Am, m.max_steps)
        rs, w = rows[g]
        assert (res.steps, res.code) == (int(jsteps[g]), int(jcode[g]))
        st, slot = got_m.state, m.slot
        np.testing.assert_array_equal(st["D"][slot].numpy(), jD[rs, :w])
        for name, arr in (("e", je), ("rmin", jrmin), ("er", jer)):
            np.testing.assert_array_equal(st[name][slot].numpy(), arr[rs])
        n = int(st["clen"][slot])
        assert n == int(jclen[g])
        np.testing.assert_array_equal(st["cons"][slot, :n].numpy(),
                                      jcons[g, :n])
        codes.add(res.code)
    assert len(codes) >= 1
