"""The two redesigned kernels on a card, without JAX: the fused branch
step of a read-sharded store (``csrc/branch_step.cu`` over several
shards' stores in one launch) and the packed gang (``csrc/run_ragged.cu``
with members sharing a cluster).  Both tests are ``cuda``-marked and skip
on a host without a card; ``chip_smoke.py``'s ``mesh_kernel``,
``mesh_main``, ``gang_kernel`` and ``serve_kernel`` hold the same kernels
at the tracked shapes.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import branch_kernel as bk
from waffle_con_tpu_torch.ops import ragged_kernel as rgk
from waffle_con_tpu_torch.ops import sharded_scorer as ss
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer
from waffle_con_tpu_torch.utils.example_gen import generate_test

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
