"""The gang launch across stores (``ops/ragged_kernel.py``,
``csrc/run_ragged.cu``), without JAX: the serving pool's members come
from different branch stores at different ``R``, ``W``, ``C``, ``L``,
``A`` and search constants.

* ``plan_members``: one shape is ``plan_run``'s geometry; mixed shapes
  take the largest cluster and CTA, each member keeping its own split.
* On the CPU: members of four stores in one plain gang equal each
  member's solo ``run_extend_plain`` from the same state.
* On a card only (``cuda``): the kernel over the same members bitwise
  against the plain gang.  This file imports no JAX, so the card's run
  needs none.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu_torch import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import ragged_kernel as rgk
from waffle_con_tpu_torch.ops import run_kernel as rk
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

pytestmark = pytest.mark.serve

BIG = 10**9


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mutated_reads(n, lo, hi, seed):
    r = np.random.default_rng(seed)
    base = r.integers(0, 4, size=int(r.integers(lo, hi))).astype(np.uint8)
    reads = []
    for _ in range(n):
        b = base.copy()
        m = r.random(len(b)) < 0.03
        b[m] = r.integers(0, 4, int(m.sum())).astype(np.uint8)
        reads.append(bytes(b))
    return reads


def test_plan_members_geometry():
    one = rgk.plan_members([(256, 514, 4, 16384)] * 3)
    assert one.run == rk.plan_run(256, 514, 4)
    shapes = [(32, 130, 4, 2048), (64, 258, 4, 8192), (256, 514, 5, 16384)]
    mixed = rgk.plan_members(shapes)
    plans = [rk.plan_run(R, W, A) for R, W, A, _C in shapes]
    assert mixed.plans == tuple(plans)
    assert mixed.run.cluster == max(p.cluster for p in plans) == 16
    assert mixed.run.threads == max(p.threads for p in plans)
    nw = mixed.run.threads // 32
    assert mixed.run.smem_bytes == max(
        rk._smem_bytes(p.reads_per_cta, nw, W, A, p.band == "smem")
        for p, (_R, W, A, _C) in zip(plans, shapes))
    wide = rgk.plan_members([(16, 18, 4, 512), (1024, 514, 4, 2048)])
    assert wide.run.band == "mixed"
    for bad in ([], [(16, 18, 4, 512)] * 9, [(16, 18, 4, 1)]):
        with pytest.raises(ValueError):
            rgk.plan_members(bad)


def _store_members(device):
    """Four stores of different R, W, A and constants, each with a branch
    a few symbols in: gang members for ``run_members``."""
    specs = [
        (_mutated_reads(5, 80, 120, 21), dict(initial_band=8), 6, {}),
        (_mutated_reads(33, 150, 200, 22), dict(initial_band=24), 10,
         dict(l2=True)),
        ([r.replace(b"\x02", b"*", 3) for r in _mutated_reads(
            9, 60, 90, 23)], dict(initial_band=12, wildcard=ord("*")), 4, {}),
        (_mutated_reads(7, 90, 110, 24),
         dict(initial_band=16, allow_early_termination=True), 8,
         dict(first=True)),
    ]
    members = []
    for reads, kw, prefix, over in specs:
        cfg = CdwfaConfigBuilder().backend("torch").device(device)
        for k, v in kw.items():
            cfg = getattr(cfg, k)(v)
        sc = TorchScorer(reads, cfg.min_count(2).build())
        h = sc.root(np.ones(sc.num_reads, bool))
        cons = reads[0][:prefix]
        for k in range(prefix):
            sc.push(h, cons[: k + 1])
        fs = sc.sym_id[reads[0][prefix]] if over.get("first") else -1
        members.append(rgk.Member(
            sc._state, sc._slot_of[h], sc._reads, sc._rlen, prefix, BIG,
            BIG, 0, 40, fs, 2, over.get("l2", False), sc._wc, sc._et,
            sc.num_symbols))
    return members


def test_run_members_in_place_equals_solo_runs():
    """On the CPU: members of four stores in one plain gang equal each
    member's solo ``run_extend_plain`` from the same state (records off),
    outputs and slot rows."""
    members = _store_members("cpu")
    copies = [{k: v.clone() for k, v in m.state.items()} for m in members]
    outs, dep = rgk.run_members([m._replace(state=c) for m, c in
                                 zip(members, copies)], in_place=True)
    assert dep is None
    for m, c, out in zip(members, copies, outs):
        st = {k: v.clone() for k, v in m.state.items()}
        args = rk.RunArgs(m.me_budget, m.other_cost, m.other_len,
                          m.min_count, m.l2, m.max_steps, m.first_sym, False,
                          m.wc, m.et, m.a_real)
        want, _rs, _rf = rk.run_extend_plain(st, m.slot, m.reads, m.rlen,
                                             args)
        assert torch.equal(out, want)
        for k in st:
            assert torch.equal(c[k], st[k]), k


@pytest.mark.cuda
def test_run_members_kernel_matches_plain_on_card():
    """On a card: the gang kernel over members of four different stores
    (different R, W, A, L, C, L2, wildcard, early termination, a forced
    first symbol) bitwise against the plain gang, outputs and slots."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    members = _store_members("cuda")
    ka = [{k: v.clone() for k, v in m.state.items()} for m in members]
    pa = [{k: v.clone() for k, v in m.state.items()} for m in members]
    before = rgk.run_ragged_cuda.launches
    ok, _ = rgk.run_members_cuda([m._replace(state=c) for m, c in
                                  zip(members, ka)], True)
    op, _ = rgk.run_members_plain([m._replace(state=c) for m, c in
                                   zip(members, pa)], True)
    assert rgk.run_ragged_cuda.launches == before + 1
    for a, b in zip(ok, op):
        assert torch.equal(a, b)
    for x, y in zip(ka, pa):
        for k in x:
            assert torch.equal(x[k], y[k]), k
