"""The redesigned kernels on a card, without JAX: the fused branch step
of a read-sharded store (``csrc/branch_step.cu`` over several shards'
stores in one launch), the packed gang (``csrc/run_ragged.cu`` with
members sharing a cluster), and the shard instances of the run, dual-run
and arena kernels (``csrc/run_extend.cu``, ``csrc/run_extend_dual.cu``,
``csrc/arena.cu`` over four shards of one card in one launch).  Every
test is ``cuda``-marked and skips on a host without a card;
``chip_smoke.py``'s ``mesh_kernel``, ``mesh_main``, ``gang_kernel`` and
``serve_kernel`` hold the same kernels at the tracked shapes.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import arena_kernel as ak
from waffle_con_tpu_torch.ops import branch_kernel as bk
from waffle_con_tpu_torch.ops import ragged_kernel as rgk
from waffle_con_tpu_torch.ops import run_dual_kernel as rdk
from waffle_con_tpu_torch.ops import run_kernel as rk
from waffle_con_tpu_torch.ops import sharded_scorer as ss
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import corrupt, generate_test

BIG = 2**31 - 1


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")


def _copy(st):
    return {k: v.clone() for k, v in st.items()}


def _store(reads, E, device):
    cfg = (CdwfaConfigBuilder().backend("torch").device(device)
           .initial_band(E).min_count(3).build())
    return TorchScorer(reads, cfg)


@pytest.mark.cuda
def test_fused_branch_step_matches_its_twin_on_card():
    """Four shards' stores of one geometry: root, a copy, pushes (one
    past the band at E = 8, where no shard commits), stats and finalize,
    each one fused launch, bitwise against the twins."""
    _card()
    truth, reads = generate_test(4, 60, 15, 0.02, seed=21)
    rng = np.random.default_rng(21)
    reads = list(reads) + [bytes(b"ACGT"[int(i)]
                                 for i in rng.integers(0, 4, 60))]
    cfg = (CdwfaConfigBuilder().backend("torch").device("cuda")
           .initial_band(8).min_count(3).build())
    shards = ss.ShardedScorer(reads, cfg, ["cuda:0"] * 4).shards
    states = [sh._state for sh in shards]
    rd = [sh._reads for sh in shards]
    rl = [sh._rlen for sh in shards]
    plain = [_copy(s) for s in states]
    bufs = bk.BranchBuffers()
    act = np.ones(4 * shards[0]._R, dtype=bool)
    launches = bk.branch_cuda.launches
    bk.root_shards_cuda(states, 0, act, rl, bufs)
    bk.root_shards_plain(plain, 0, act, rl)
    bk.advance_shards_cuda(states, [[0], [1], [-1]], rd, rl, -2, False, 4,
                           with_stats=False, bufs=bufs)
    bk.advance_shards_plain(plain, [[0], [1], [-1]], rd, rl, -2, False, 4,
                            with_stats=False)
    overflowed = False
    for j in range(40):
        sym = int(shards[0].sym_id[truth[j]])
        rows = [[0, 1], [0, 1], [sym, sym]]
        got = bk.advance_shards_cuda(states, rows, rd, rl, -2, False, 4,
                                     bufs=bufs)
        want = bk.advance_shards_plain(plain, rows, rd, rl, -2, False, 4)
        for name in bk.BranchOut._fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                          np.asarray(getattr(want, name)))
        for s, p in zip(states, plain):
            for k in s:
                assert torch.equal(s[k], p[k]), (j, k)
        if got.overflow:
            overflowed = True
            break
    assert overflowed
    got = bk.stats_shards_cuda(states, [0, 1], rd, rl, 4, bufs)
    want = bk.stats_shards_plain(plain, [0, 1], rd, rl, 4)
    for name in bk.BranchOut._fields:
        np.testing.assert_array_equal(np.asarray(getattr(got, name)),
                                      np.asarray(getattr(want, name)))
    fin, ovf = bk.finalize_shards_cuda(states, [0], rd, rl, bufs)
    fin_p, ovf_p = bk.finalize_shards_plain(plain, [0])
    np.testing.assert_array_equal(fin, fin_p)
    np.testing.assert_array_equal(ovf, ovf_p)
    # one launch a call, every call fused over the four shards
    calls = bk.branch_cuda.fused_shards.get(4, 0)
    assert calls >= 5 and bk.branch_cuda.launches - launches >= calls


@pytest.mark.cuda
def test_packed_gang_matches_plain_and_unpacked_on_card():
    """Members of four stores (4, 2, 1 and 1 CTAs) packed into two
    clusters, bitwise against the plain gang and the unpacked launch."""
    _card()
    members = []
    for n, E, seed in [(64, 16, 41), (32, 8, 42), (16, 16, 43), (9, 8, 44)]:
        truth, reads = generate_test(4, 160, n, 0.02, seed=seed)
        sc = _store(reads, E, "cuda")
        h = sc.root(np.ones(sc.num_reads, dtype=bool))
        for k in range(8):
            sc.push(h, truth[: k + 1])
        members.append(rgk.Member(
            sc._state, sc._slot_of[h], sc._reads, sc._rlen, 8, BIG, BIG, 0,
            30, -1, 3, False, sc._wc, sc._et, sc.num_symbols))
    plan = rgk.plan_members([m.shape() for m in members])
    assert plan.clusters == 2
    runs = {}
    for name in ("packed", "unpacked", "plain"):
        group = [m._replace(state=_copy(m.state)) for m in members]
        if name == "plain":
            outs, _ = rgk.run_members_plain(group, True)
        else:
            outs, _ = rgk.run_members_cuda(
                group, True, plan=rgk.plan_members(
                    [m.shape() for m in members], packed=name == "packed"))
        runs[name] = (outs, group)
    for name in ("packed", "unpacked"):
        for a, b in zip(runs[name][0], runs["plain"][0]):
            assert torch.equal(a, b), name
        for x, y in zip(runs[name][1], runs["plain"][1]):
            for k in x.state:
                assert torch.equal(x.state[k], y.state[k]), (name, k)


def _plain_hooks(sc):
    """``sc``'s three launches routed to the shard instances' plain
    versions (on the card's tensors)."""
    sc._run_launch = lambda slot, args: rk.run_extend_shards_plain(
        sc._store()[0], slot, *sc._store()[1:], args)
    sc._dual_launch = lambda s1, s2, mc, imb, args: (
        rdk.run_extend_dual_shards_plain(sc._store()[0], s1, s2,
                                         *sc._store()[1:], mc, imb, args))
    sc._arena_launch = lambda *a: ak.arena_shards_plain(*sc._store(), *a)
    return sc


def _drive(sc, truth, h2):
    """Runs, a dual run and two arena calls on one store: what each
    returned, as plain data."""
    out = []
    h = sc.root(np.ones(sc.num_reads, dtype=bool))
    res = sc.run_extend(h, b"", BIG, BIG, 0, 3, False, 250)
    out.append(res[:3])
    cons = res[2]
    ha, hb = sc.clone(h), sc.clone(h)
    sc.push(ha, truth[: len(cons) + 1])
    sc.push(hb, h2[: len(cons) + 1])
    res = sc.run_extend_dual(ha, hb, truth[: len(cons) + 1],
                             h2[: len(cons) + 1], BIG, BIG, 0, 3, 5, 2,
                             False, False, 60)
    out.append(res[:4] + tuple(np.asarray(x).tolist() for x in res[6:8]))
    lw = 1024
    for specs in ([(h, None, len(cons), 0)],
                  [(ha, hb, len(truth[: len(cons) + 1]),
                    len(h2[: len(cons) + 1]))]):
        lc = np.zeros((2, lw), np.int32)
        far = max(max(x[2], x[3]) for x in specs)
        tr = np.array([[0, 0, far, 0], [0, 0, far, 0]], np.int32)
        res = sc.run_arena(
            specs, BIG, 3, 20, 0, False, False, BIG, 0, 1000, 1000, 60,
            1000, lc, np.zeros((2, lw), np.int32), tr, create_mode=2,
            mc_tab=np.full(sc.num_reads + 1, 3, np.int32),
            imb_tab=np.zeros(lw, np.int32))
        out.append((res[0], res[1], res[2], res[5]))
    return out


@pytest.mark.cuda
def test_run_shard_instances_match_their_plain_versions_on_card():
    """Two stores of four shards on ``cuda:0``, driven through the same
    calls: one launches each shard instance (one launch a call for the
    four shards), the other runs the plain versions on the card's
    tensors.  Every output and every shard's store equal, bitwise; the
    band of E = 8 overflows on the way."""
    _card()
    truth, reads1 = generate_test(4, 200, 6, 0.01, seed=1)
    h2 = bytearray(truth)
    h2[66] = (h2[66] + 1) % 4
    h2 = bytes(h2)
    reads = list(reads1) + [corrupt(h2, 0.01, np.random.default_rng(50 + i))
                            for i in range(6)]
    reads += [reads1[0][:30] + reads1[0][42:]]
    cfg = (CdwfaConfigBuilder().backend("torch").device("cuda")
           .initial_band(8).min_count(3).build())
    fused = ss.ShardedScorer(reads, cfg, ["cuda:0"] * 4)
    plain = _plain_hooks(ss.ShardedScorer(reads, cfg, ["cuda:0"] * 4))
    assert fused.placement == "fused"
    before = (rk.run_extend_shards_cuda.launches,
              rdk.run_extend_dual_shards_cuda.launches,
              ak.arena_shards_cuda.launches)
    got = _drive(fused, truth, h2)
    launched = (rk.run_extend_shards_cuda.launches - before[0],
                rdk.run_extend_dual_shards_cuda.launches - before[1],
                ak.arena_shards_cuda.launches - before[2])
    assert launched == (1, 1, 2)
    assert got == _drive(plain, truth, h2)
    assert fused._E == plain._E
    for a, b in zip(fused.shards, plain.shards):
        for k in a._state:
            assert torch.equal(a._state[k], b._state[k]), k
