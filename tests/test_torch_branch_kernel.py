"""The branch store's life-cycle calls against the JAX package's.

The plain twins of ``waffle_con_tpu_torch/ops/branch_kernel.py``
(``root_plain``, ``advance_plain``, ``stats_plain``, ``finalize_plain``,
``deactivate_plain``) against ``waffle_con_tpu.ops.jax_scorer``'s
``_j_root``, ``_j_clone_batch``, ``_j_push_batch``,
``_j_clone_push_batch``, ``_j_stats``, ``_j_finalize`` and
``_j_deactivate_batch`` on seeded stores: copy-only rows, in-place rows,
clones pushed, a batch whose rows write the slots other rows read, a row
that overflows the band at E=8 (the whole batch uncommitted), the
wildcard, early termination on and off, A=4 and A=256, W=18 and W=514.
Every store field, every stats field and the overflow flag must be equal
exactly, dtypes included.  Then ``TorchScorer`` on the CPU against
``JaxScorer`` through root, clone_push (one child in place, its siblings
cloned from the same slot), push, band growth, deactivate, stats and
finalize; and the launch planner ``plan_branch`` on every shape the
store can hold.  The CUDA kernel ``csrc/branch_step.cu`` is held to the
twins by ``test_kernel_matches_twins_on_card`` where a card is present,
and on the card by ``chip_smoke.py``'s ``branch_kernel`` phase.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import (
    JaxScorer,
    _j_clone_batch,
    _j_clone_push_batch,
    _j_deactivate_batch,
    _j_finalize,
    _j_push_batch,
    _j_root,
    _j_stats,
)
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import branch_kernel as bk
from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.ops.state_io import FIELDS, state_from_numpy
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer, replay_rows

#: (W, A) of the stores; the wildcard is the alphabet's last id
GEOMETRIES = [(18, 4), (514, 4), (18, 256)]
B, R, L, C = 8, 16, 256, 512
#: slot 3 holds a consensus of random symbols: at E=8 its reads'
#: distances are past the band, so pushing it overflows
GARBAGE = 3


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(W, A, seed=5):
    """A seeded store: R reads of one truth over ``A`` symbols at 2 %
    substitutions and indels (every 23rd symbol of read 0 the wildcard id
    ``A - 1``), slots 0-2 holding prefixes of the truth and of a variant
    at mixed lengths with late anchors and inactive reads, slot 3 a
    random consensus, slots 4-7 stale.  Bands and folds come from the
    column replay (``replay_rows``).  Returns numpy fields, reads and
    lengths."""
    rng = np.random.default_rng(seed + W + A)
    truth = rng.integers(0, A - 1, 220)
    reads = []
    for _ in range(R):
        r = []
        for s in truth:
            u = rng.random()
            if u < 0.005:
                continue
            r.append(int(rng.integers(0, A - 1)) if u < 0.015 else int(s))
            if u > 0.995:
                r.append(int(rng.integers(0, A - 1)))
        reads.append(r[:int(rng.integers(150, 200))])
    reads[0][::23] = [A - 1] * len(reads[0][::23])
    off = np.zeros((B, R), dtype=np.int32)
    for r in (4, 9):
        off[:, r] = int(rng.integers(5, 30))
        reads[r] = reads[r][off[0, r]:]
    rd = np.full((R, L), -1, dtype=np.int16)
    for i, r in enumerate(reads):
        rd[i, :len(r)] = r
    rlen = np.array([len(r) for r in reads], dtype=np.int32)
    act = rng.random((B, R)) < 0.85
    act[:, 0] = True
    cons = np.zeros((B, C), dtype=np.int32)
    cons[0, :220] = truth
    cons[1, :220] = truth
    cons[1, 40:220:50] = (truth[40::50] + 1) % (A - 1)
    cons[1, 25:220:60] = A - 1
    cons[2, :220] = truth
    cons[GARBAGE, :60] = rng.integers(0, A, 60)
    cons[4:] = rng.integers(0, A, (B - 4, C))
    clen = np.array([90, 75, 40, 30, 12, 0, 33, 7], dtype=np.int32)
    E = (W - 2) // 2
    t = {k: torch.from_numpy(v) for k, v in
         dict(off=off, act=act, cons=cons, clen=clen).items()}
    D, e, rmin, er = replay_rows(t["off"], t["act"], t["cons"], t["clen"],
                                 torch.from_numpy(rd),
                                 torch.from_numpy(rlen), A - 1, False, E, W)
    st = dict(D=D.numpy(), e=e.numpy(), rmin=rmin.numpy(), er=er.numpy(),
              off=off, act=act, cons=cons, clen=clen)
    return st, rd, rlen


_STORES = {}


def store(W, A):
    if (W, A) not in _STORES:
        _STORES[(W, A)] = _store(W, A)
    st, rd, rlen = _STORES[(W, A)]
    return {k: v.copy() for k, v in st.items()}, rd, rlen


def _jax_state(st):
    return {k: jnp.asarray(v) for k, v in st.items()}


def _assert_store(got, want, what):
    for name, dt in FIELDS.items():
        g = got[name].numpy()
        w = np.asarray(want[name])
        assert g.dtype == w.dtype == dt, (what, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def _assert_stats(out, want, what, n=None):
    """``out`` (a ``BranchOut``) against JAX's ``(eds, occ, split,
    reached[, fin, fin_ok])`` rows (the first ``n``)."""
    names = ("eds", "occ", "split", "reached", "fin", "fin_ok")
    for name, w in zip(names, want):
        g = getattr(out, name)
        w = np.asarray(w)[:n]
        assert g.dtype == w.dtype, (what, name, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def _sym(A, k):
    return (3 * k + 1) % A


#: rows (src, dst, sym) of each case; None: the symbol of _sym
CASES = {
    # copies into stale slots (clone_batch)
    "copy": [(0, 4, -1), (1, 5, -1), (2, 6, -1)],
    # pushes in place (push_batch)
    "in_place": [(0, 0, None), (1, 1, None), (2, 2, None)],
    # clones pushed, beside a copy
    "clone_push": [(0, 4, None), (0, 5, None), (1, 6, -1)],
    # each row writes the slot the next one reads: gather before scatter
    "cycle": [(0, 1, None), (1, 2, None), (2, 0, -1)],
    # the expansion's shape: the source in place, its siblings cloned
    "expand": [(0, 4, None), (0, 5, -1), (0, 0, None)],
    # slot 3 overflows at E=8: nothing of the batch commits
    "overflow": [(0, 4, None), (GARBAGE, GARBAGE, None), (1, 1, None)],
}


def _rows(case, A):
    return np.array([(s, d, _sym(A, k) if y is None else y)
                     for k, (s, d, y) in enumerate(CASES[case])],
                    dtype=np.int32).T


@pytest.mark.parametrize("wild", [False, True], ids=["nowc", "wc"])
@pytest.mark.parametrize("et", [False, True], ids=["no_et", "et"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("W,A", GEOMETRIES, ids=lambda x: str(x))
def test_advance_matches_jax(W, A, case, et, wild):
    st, rd, rlen = store(W, A)
    wc = A - 1 if wild else -2
    rows = _rows(case, A)
    want_st, want_stats, want_ovf = jax.device_get(_j_clone_push_batch(
        _jax_state(st), rd, rlen, rows, wc, et, A))
    t = state_from_numpy(st, "cpu")
    out = bk.advance_plain(t, rows, torch.from_numpy(rd),
                           torch.from_numpy(rlen), wc, et, A)
    assert out.overflow == bool(want_ovf)
    assert out.overflow == (case == "overflow" and W == 18)
    _assert_stats(out, want_stats, case)
    _assert_store(t, want_st, case)
    if out.overflow:
        _assert_store(t, st, "uncommitted")
    # the cases' own JAX functions give the same store and stats
    if (rows[2] < 0).all():
        t2 = state_from_numpy(st, "cpu")
        assert bk.advance_plain(t2, rows, torch.from_numpy(rd),
                                torch.from_numpy(rlen), wc, et, A,
                                with_stats=False) is None
        _assert_store(t2, jax.device_get(_j_clone_batch(
            _jax_state(st), rows[:2])), "clone_batch")
    if (rows[0] == rows[1]).all():
        got_st, got_stats, got_ovf = jax.device_get(_j_push_batch(
            _jax_state(st), rd, rlen, rows[[0, 2]], wc, et, A))
        assert bool(got_ovf) == out.overflow
        _assert_stats(out, got_stats, "push_batch")
        _assert_store(t, got_st, "push_batch")


@pytest.mark.parametrize("W,A", GEOMETRIES, ids=lambda x: str(x))
def test_root_stats_finalize_deactivate_match_jax(W, A):
    st, rd, rlen = store(W, A)
    t = state_from_numpy(st, "cpu")
    trd, trl = torch.from_numpy(rd), torch.from_numpy(rlen)
    # stats and finalize of every slot as it stands
    for slot in range(B):
        want = jax.device_get(_j_stats(_jax_state(st), rd, rlen,
                                       np.int32(slot), A))
        _assert_stats(bk.stats_plain(t, [slot], trd, trl, A),
                      [np.asarray(x)[None] for x in want], f"stats {slot}")
        fin, ovf = bk.finalize_plain(t, [slot])
        wfin, wovf = jax.device_get(_j_finalize(_jax_state(st), slot))
        np.testing.assert_array_equal(fin[0], wfin)
        assert fin.dtype == wfin.dtype and bool(ovf[0]) == bool(wovf)
    # slot 3's distances are past the band at E=8 only
    assert bool(bk.finalize_plain(t, [GARBAGE])[1][0]) == (W == 18)
    # a batch of slots at once is the slots one by one
    many = bk.stats_plain(t, [2, 0, 6], trd, trl, A)
    for i, slot in enumerate((2, 0, 6)):
        one = bk.stats_plain(t, [slot], trd, trl, A)
        for name in ("eds", "occ", "split", "reached", "fin", "fin_ok"):
            np.testing.assert_array_equal(getattr(many, name)[i],
                                          getattr(one, name)[0])
    # a root over a stale slot, some reads inactive
    act = np.ones(R, dtype=bool)
    act[[3, 11]] = False
    want_st, want_stats = jax.device_get(_j_root(
        _jax_state(st), rd, rlen, np.int32(6), act, A))
    bk.root_plain(t, 6, torch.from_numpy(act), trl)
    _assert_store(t, want_st, "root")
    _assert_stats(bk.stats_plain(t, [6], trd, trl, A),
                  [np.asarray(x)[None] for x in want_stats], "root stats")
    # deactivations, a repeated pair included
    pairs = np.array([[0, 6, 1, 0], [2, 5, 0, 2]], dtype=np.int32)
    cur = {k: v.numpy() for k, v in t.items()}
    want = jax.device_get(_j_deactivate_batch(_jax_state(cur), pairs))
    bk.deactivate_plain(t, pairs)
    _assert_store(t, want, "deactivate")


def test_rows_are_checked():
    st, rd, rlen = store(18, 4)
    t = state_from_numpy(st, "cpu")
    trd, trl = torch.from_numpy(rd), torch.from_numpy(rlen)
    for rows, match in (
            ([[0, 1], [4, 4], [1, 2]], "duplicate destination"),
            ([[0], [B], [1]], "outside"),
            ([[0, 1]], r"need \[3, n\]")):
        with pytest.raises(ValueError, match=match):
            bk.advance_plain(t, rows, trd, trl, -2, False, 4)
    with pytest.raises(ValueError, match="cannot push"):
        bk.advance_plain(t, [[0], [4], [1]], trd, trl, -2, False, 4,
                         with_stats=False)


@pytest.mark.parametrize("n,R_,W,A", [
    (1, 256, 514, 4),          # the single north star's restore
    (92, 64, 258, 4),          # the dual restore's largest batch
    (12, 256, 258, 256),       # plan_gate's dual draw
    (3, 16, 2050, 8),
    (1, 256, 139266, 4),       # col_replay's widest row
    (2, 1024, 278530, 256),    # past it, on a large store
    (70000, 16, 18, 4),        # more rows than the commit's grid
    (1, 1, 4, 1),
])
def test_plan_branch_takes_every_shape(n, R_, W, A):
    plan = bk.plan_branch(n, R_, W, A, H100_SMS, 2)
    assert plan.name in bk.PLANS
    assert plan.warps * plan.blocks >= n * R_
    assert (plan.blocks - 1) * plan.warps < n * R_
    assert plan.head_words == 4 * n * R_ + n + 1
    assert plan.out_words == plan.head_words + n * R_ * A
    assert plan.blocks < 2**31
    if plan.name == "slab":
        assert 1 <= plan.commit_blocks <= bk.COMMIT_CTAS
        assert plan.commit_rows == min(n * R_, bk.COMMIT_ROWS)
        assert plan.kernels == 2 and plan.cells == 0
    else:
        assert 32 * plan.cells >= W and plan.cells in bk.CELLS
        assert plan.commit and plan.kernels == 1
        assert plan.smem == bk.one_launch_smem(plan.cells, A)
        assert plan.smem == 4 * bk.ONE_WARPS * (32 * plan.cells + A)
        assert plan.smem <= bk.ONE_SMEM_MAX


@pytest.mark.parametrize("shape", [(0, 16, 18, 4), (1, 16, 17, 4),
                                   (1, 16, 2, 4), (1, 16, 18, 0)])
def test_plan_branch_refuses_only_malformed_shapes(shape):
    with pytest.raises(ValueError):
        bk.plan_branch(*shape, H100_SMS, 2)


#: SMs of an H100 SXM
H100_SMS = 132
#: (n, R, W, A, per_sm, commit) -> (plan, cells) of the planner
PLAN_CHOICES = {
    # the single north star's restore push, copy, stats and finalize
    "north_star_push": ((1, 256, 514, 4, 2, True), ("one_launch", 17)),
    "north_star_stats": ((3, 256, 514, 4, 2, False), ("one_launch", 17)),
    "north_star_finalize": ((2, 256, 514, 1, 2, False), ("one_launch", 17)),
    "north_star_expand": ((3, 256, 514, 4, 2, True), ("one_launch", 17)),
    # the dual restore's largest batch: 5,888 warps on 368 CTAs
    "dual_restore_92_two_per_sm": ((92, 64, 258, 4, 2, True), ("slab", 0)),
    "dual_restore_92_three_per_sm": ((92, 64, 258, 4, 3, True),
                                     ("one_launch", 9)),
    "priority_push": ((4, 32, 130, 4, 2, True), ("one_launch", 5)),
    "plan_gate_A256": ((12, 256, 258, 256, 2, True), ("one_launch", 9)),
    # the widest band in registers, and the next one
    "W544": ((1, 16, 544, 4, 2, True), ("one_launch", 17)),
    "W546": ((1, 16, 546, 4, 2, True), ("slab", 0)),
    "W546_stats": ((1, 16, 546, 4, 2, False), ("slab", 0)),
    "W2050": ((3, 16, 2050, 4, 2, True), ("slab", 0)),
    "W139266": ((2, 16, 139266, 4, 2, True), ("slab", 0)),
    # one CTA an SM: every warp resident (132 CTAs of 16 warps), and one
    # warp more
    "one_per_sm_full": ((2112, 1, 18, 4, 1, True), ("one_launch", 1)),
    "one_per_sm_plus_one_warp": ((2113, 1, 18, 4, 1, True), ("slab", 0)),
    # every warp resident (132 x 2 CTAs of 16 warps), and one warp past
    "resident": ((4224, 1, 34, 4, 2, True), ("one_launch", 2)),
    "one_warp_past_residency": ((4225, 1, 34, 4, 2, True), ("slab", 0)),
    # stats take no barrier, so residency does not bound them
    "stats_past_residency": ((4225, 1, 34, 4, 2, False), ("one_launch", 2)),
    # the kernel fits no SM, or its band and histogram rows no CTA
    # (16 warps x (96 + A) words <= 232,448 bytes at W=66)
    "no_residency": ((1, 16, 66, 4, 0, True), ("slab", 0)),
    "A3536": ((1, 16, 66, 3536, 2, True), ("one_launch", 3)),
    "A3537": ((1, 16, 66, 3537, 2, True), ("slab", 0)),
}


@pytest.mark.parametrize("case", list(PLAN_CHOICES))
def test_plan_branch_choice(case):
    (n, R_, W, A, per_sm, commit), want = PLAN_CHOICES[case]
    plan = bk.plan_branch(n, R_, W, A, H100_SMS, per_sm, commit)
    assert (plan.name, plan.cells) == want and plan.commit == commit
    if plan.name == "one_launch" and commit:
        # the grid barrier needs every CTA resident
        assert plan.blocks <= H100_SMS * per_sm
    assert (plan.commit_rows > 0) == (plan.name == "slab" and commit)
    # the one-launch plan stages a copy's consensus; stats need nothing
    words = bk.scratch_words(plan, n, R_, W, 512)
    if plan.name == "slab":
        assert words == (bk.slab_words(n, R_, W, 512) if commit else 0)
    else:
        assert words == (n * 512 if commit else 0)


@pytest.mark.parametrize("need,cap", [(1, 256), (256, 256), (257, 512),
                                      (5000, 8192)])
def test_buffers_grow_to_a_power_of_two(need, cap):
    bufs = bk.BranchBuffers()
    bufs.on(torch.device("cpu"))
    assert bufs.scratch(0) is None
    addr = bufs.scratch(need)
    assert bufs._scratch.numel() == cap
    # a call that fits keeps the buffer, a larger one grows it
    assert bufs.scratch(need) == addr and bufs.scratch(cap) == addr
    bufs.scratch(cap + 1)
    assert bufs._scratch.numel() == 2 * cap
    out, out_host, flag = bufs.output(need)
    # the device output keeps one more word: the overflow flag, its last
    assert bufs._out.numel() >= need + 1 and not bufs._out.any()
    assert flag == out + 4 * (bufs._out.numel() - 1)
    assert bufs._out_host.numel() == bufs._out.numel()
    assert not bufs._out_host.any()
    assert out_host == bufs._out_host.data_ptr()
    words = np.arange(need, dtype=np.int32)
    dev_addr, host_addr = bufs.stage(words)
    assert host_addr == bufs._rows_host.data_ptr()
    assert dev_addr == bufs._rows.data_ptr()
    np.testing.assert_array_equal(bufs._rows_host[:need].numpy(), words)
    assert bufs._rows.numel() == bufs._rows_host.numel() == cap
    assert bufs.stage(words[:1])[1] == host_addr


def test_buffers_wait_before_restaging(monkeypatch):
    """After a call that returned without waiting (a copy, a root, a
    deactivation), the pinned rows are written again only after a wait on
    the store's event: its upload may still be reading them."""
    synced = []

    def bind(name, argtypes):
        assert name == "branch_event_sync"
        return lambda event: synced.append(event) or 0

    monkeypatch.setattr(bk.rpk, "_bind", bind)
    bufs = bk.BranchBuffers()
    bufs.on(torch.device("cpu"))
    bufs.stage(np.arange(6, dtype=np.int32))
    assert synced == []
    bufs._event, bufs.pending = 1234, True
    bufs.stage(np.arange(3, dtype=np.int32))
    assert synced == [1234] and not bufs.pending
    bufs.stage(np.arange(3, dtype=np.int32))
    assert synced == [1234]


@pytest.mark.parametrize("pending", [True, False], ids=["pending", "idle"])
def test_buffers_reset_waits_when_pending(monkeypatch, pending):
    """Dropping the buffers (a reset, a collected store's event) waits for
    the last call that returned without waiting: its upload may still read
    the pinned rows, which the host allocator could hand out again."""
    calls = []

    def bind(name, argtypes):
        def fn(*args):
            if name == "branch_event":
                args[0]._obj.value = 1234  # the new event's address
            else:
                calls.append((name,) + args)
            return 0
        return fn

    monkeypatch.setattr(bk.rpk, "_bind", bind)
    bufs = bk.BranchBuffers()
    bufs.on(torch.device("cpu"))
    bufs.stage(np.arange(6, dtype=np.int32))
    event = bufs.event()
    assert event == 1234
    bufs.pending = pending
    calls.clear()
    bufs.reset()
    want = [("branch_event_sync", event)] if pending else []
    # the event is freed only after its work has finished
    want += [("branch_event_sync", event), ("branch_event_free", event)]
    assert calls == want
    assert not bufs.pending and bufs._rows_host is None
    assert bufs._event is None
    # calls given no buffers share the module's, so none is dropped early
    assert bk.shared_buffers() is bk.shared_buffers()


def test_buffers_bind_once_a_geometry_and_reset_on_growth(monkeypatch):
    """The store is checked once a geometry; each reallocation of the
    store (band, slot and consensus growth) drops the buffers."""
    checked = []

    def check(state, reads, rlen):
        checked.append(state["D"].shape)
        return (torch.device("cpu"),) + tuple(state["D"].shape)

    monkeypatch.setattr(bk, "_check_store", check)
    reads = [b"ACGTACGTAC" * 3, b"ACGTTCGTAC" * 3]
    sc = TorchScorer(reads, CdwfaConfigBuilder().backend("torch")
                     .device("cpu").build())
    bufs = sc._bk
    c = bufs.bind(sc._state, sc._reads, sc._rlen)
    assert bufs.bind(sc._state, sc._reads, sc._rlen) is c
    assert bufs.checks == 1 and len(checked) == 1
    assert (c.B, c.R, c.W, c.C, c.L) == (sc._B, sc._R, sc._W, sc._C, sc._L)
    assert c.D == sc._state["D"].data_ptr()
    monkeypatch.setattr(bk, "_occupancy", lambda dev, cells, smem: (132, 2))
    assert bufs.plan(1, 4, True).cells == bk.one_launch_cells(sc._W)
    for grow in (sc._grow_e, sc._grow_slots, sc._grow_cons):
        bufs.scratch(1000)
        grow()
        assert bufs.call is None and bufs._scratch is None
        assert bufs.epoch == bk.EPOCH0
        c = bufs.bind(sc._state, sc._reads, sc._rlen)
        assert (c.B, c.W, c.C) == (sc._B, sc._W, sc._C)
        # a plan of the old geometry is not kept
        assert bufs.plan(1, 4, True).cells == bk.one_launch_cells(sc._W)
    assert bufs.checks == 1 and len(checked) == 4
    # buffers shared by two stores plan each at its own width
    other = {k: v.clone() for k, v in sc._state.items()}
    other["D"] = torch.zeros((sc._B, sc._R, 18), dtype=torch.int32)
    bufs.bind(other, sc._reads, sc._rlen)
    assert bufs.plan(1, 4, True).cells == 1
    bufs.bind(sc._state, sc._reads, sc._rlen)
    assert bufs.plan(1, 4, True).cells == bk.one_launch_cells(sc._W)


@pytest.mark.parametrize("votes", [True, False], ids=["votes", "head"])
def test_unpack_over_the_persistent_buffer(votes):
    """A call's output sits at the start of a larger buffer that holds
    older calls' words: only flags with this call's epoch are set."""
    n, R_, A = 3, 4, 5
    nR = n * R_
    epoch = bk.EPOCH0 + 7
    words = 4 * nR + n + 1 + (nR * A if votes else 0)
    host = np.full(words + 100, epoch - 1, dtype=np.int32)
    host[:4 * nR] = np.arange(4 * nR) % 2
    host[4 * nR:4 * nR + n + 1] = [epoch - 3, epoch, 0, epoch - 1]
    out = bk.unpack(host[:words], n, R_, A, votes, epoch)
    assert out.fin_ok.tolist() == [True, False, True]
    assert not out.overflow
    assert out.reached.dtype == bool and out.reached.sum() == nR // 2
    assert np.shares_memory(out.eds, host) and np.shares_memory(out.fin, host)
    assert (out.occ is None) == (not votes)
    host[4 * nR + n] = epoch
    assert bk.unpack(host[:words], n, R_, A, votes, epoch).overflow
    assert not bk.unpack(host[:words], n, R_, A, votes, epoch + 1).overflow


def test_cuda_wrappers_never_fall_back(monkeypatch):
    """The CUDA entries refuse tensors off the card, the dispatch refuses
    other devices, and a launch the kernel refuses raises without being
    counted, on either plan."""
    st, rd, rlen = store(18, 4)
    t = state_from_numpy(st, "cpu")
    trd, trl = torch.from_numpy(rd), torch.from_numpy(rlen)
    with pytest.raises(ValueError, match="CUDA device"):
        bk.advance_cuda(t, _rows("in_place", 4), trd, trl, -2, False, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        bk.advance_cuda(t, _rows("copy", 4), trd, trl, -2, False, 4,
                        with_stats=False)
    with pytest.raises(ValueError, match="CUDA device"):
        bk.stats_cuda(t, [0], trd, trl, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        bk.finalize_cuda(t, [0], trd, trl)
    with pytest.raises(ValueError, match="CUDA device"):
        bk.root_cuda(t, 0, np.ones(R, dtype=bool), trl)
    with pytest.raises(ValueError, match="CUDA device"):
        bk.deactivate_cuda(t, [[0], [1]])
    meta = {k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="device type 'meta'"):
        bk.stats(meta, [0], trd, trl, 4)

    class Refusing:
        def __getattr__(self, name):
            fn = lambda *args: -1  # noqa: E731
            fn.argtypes = None
            return fn

    monkeypatch.setattr(cuda_build, "library", lambda: Refusing())
    before = bk.branch_cuda.launches
    entries = dict(bk.branch_cuda.entries)
    with pytest.raises(RuntimeError, match="plan does not match"):
        bk.branch_cuda("advance", "rows")
    for plan in (bk.plan_branch(1, 256, 514, 4, H100_SMS, 2),
                 bk.plan_branch(3, 256, 514, 4, H100_SMS, 2),
                 bk.plan_branch(92, 64, 258, 4, H100_SMS, 2),
                 bk.plan_branch(2, 16, 139266, 4, H100_SMS, 2, False)):
        with pytest.raises(RuntimeError, match="plan does not match"):
            bk.branch_cuda("advance", "rows", plan=plan)
    assert bk.branch_cuda.launches == before
    assert bk.branch_cuda.entries == entries


def test_unpack_reads_the_kernel_layout():
    n, R_, A = 2, 3, 5
    nR = n * R_
    epoch = bk.EPOCH0 + 1
    host = np.arange(4 * nR + n + 1 + nR * A, dtype=np.int32)
    host[4 * nR:4 * nR + n + 1] = [0, epoch, epoch]
    out = bk.unpack(host, n, R_, A, True, epoch)
    np.testing.assert_array_equal(out.eds, np.arange(nR).reshape(n, R_))
    np.testing.assert_array_equal(out.split[1], [9, 10, 11])
    np.testing.assert_array_equal(out.fin[0], [18, 19, 20])
    assert out.fin_ok.tolist() == [True, False] and out.overflow
    assert out.occ.shape == (n, R_, A) and out.occ[0, 0, 0] == 4 * nR + n + 1
    head = bk.unpack(host[:4 * nR + n + 1], n, R_, A, False, epoch)
    assert head.occ is None and head.split is None


def _scorers(reads, band=None, wildcard=None):
    jb = JaxConfigBuilder().backend("jax").min_count(2)
    tb = CdwfaConfigBuilder().backend("torch").device("cpu").min_count(2)
    if band is not None:
        jb, tb = jb.initial_band(band), tb.initial_band(band)
    if wildcard is not None:
        jb, tb = jb.wildcard(wildcard), tb.wildcard(wildcard)
    return [JaxScorer(reads, jb.build()), TorchScorer(reads, tb.build())]


def _stats_list(s):
    return (s.eds.tolist(), s.occ.tolist(), s.split.tolist(),
            s.reached.tolist(), None if s.fin is None else s.fin.tolist())


def _store_np(sc):
    if isinstance(sc, JaxScorer):
        return {k: np.asarray(v) for k, v in jax.device_get(sc._state).items()}
    return {k: v.numpy() for k, v in sc._state.items()}


@pytest.mark.parametrize("alphabet", [4, 256])
def test_scorer_sequence_matches_jax(alphabet):
    """root -> clone_push (in place plus clones of the same slot) ->
    push (the band grows at E=8) -> deactivate -> stats -> finalize, on
    both scorers: every result and the whole store equal."""
    rng = np.random.default_rng(alphabet)
    symbols = np.arange(alphabet, dtype=np.uint8) if alphabet == 256 else (
        np.frombuffer(b"ACGT", dtype=np.uint8))
    truth = symbols[rng.integers(0, len(symbols), 120)]
    reads = []
    for k in range(8):
        r = truth.copy()
        hit = rng.random(len(r)) < 0.03
        r[hit] = symbols[rng.integers(0, len(symbols), hit.sum())]
        reads.append(bytes(r[:110 + k]))
    reads[7] = bytes(symbols[rng.integers(0, len(symbols), 100)])
    truth = bytes(truth)
    seen = []
    for sc in _scorers(reads, wildcard=int(symbols[-1])):
        log = []
        act = np.ones(len(reads), dtype=bool)
        act[2] = False
        root = sc.root(act)
        log.append(_stats_list(sc.stats(root, b"")))
        alt = bytes([truth[0] ^ 1 if alphabet == 256 else b"C"[0]])
        out = sc.clone_push_many([(root, alt, False), (root, None, False),
                                  (root, truth[:1], True)])
        log.append([None if s is None else _stats_list(s) for _h, s in out])
        (c1, _), (c0, _), (h, _) = out
        for k in range(1, 40):
            log.append([_stats_list(s) for s in sc.push_many(
                [(h, truth[:k + 1]), (c1, alt + truth[1:k + 1])])])
        sc.deactivate_many([(h, 1), (c1, 3), (h, 4)])
        log.append(_stats_list(sc.stats(h, truth[:40])))
        log.append(_stats_list(sc.stats(c0, b"")))
        log.append(sc.finalized_eds(h, truth[:40]).tolist())
        log.append(sc.finalized_eds(c1, alt + truth[1:40]).tolist())
        log.append(sc.counters["grow_e_events"])
        store_np = _store_np(sc)
        log.append([store_np[k][sc._slot_of[x]].tolist()
                    for x in (root, c0, c1) for k in FIELDS])
        seen.append(log)
    assert seen[0][-2] > 0, "the band never grew"
    assert seen[0] == seen[1]


@pytest.mark.cuda
def test_kernel_matches_twins_on_card(monkeypatch):
    """Every entry of ``csrc/branch_step.cu`` against its twin on the
    card, on the stores above, on both plans (the one-launch plan where
    the planner takes it, then the slab plan, forced): each advance case,
    stats, finalize, root and deactivate, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU form")
    before = bk.branch_cuda.launches
    for cells in (bk.CELLS, ()):
        monkeypatch.setattr(bk, "CELLS", cells)
        plans = dict(bk.branch_cuda.entries)
        _kernel_cases_on_card()
        used = {k for k in bk.PLANS if bk.branch_cuda.entries[k] > plans[k]}
        assert used == ({"one_launch", "slab"} if cells else {"slab"})
    assert bk.branch_cuda.launches > before


def _kernel_cases_on_card():
    for W, A in GEOMETRIES:
        st, rd, rlen = store(W, A)
        trd = torch.from_numpy(rd).cuda()
        trl = torch.from_numpy(rlen).cuda()
        bufs = bk.BranchBuffers()
        for case in CASES:
            rows = _rows(case, A)
            tk, tp = state_from_numpy(st, "cuda"), state_from_numpy(st, "cuda")
            ok = bk.advance_cuda(tk, rows, trd, trl, A - 1, True, A,
                                 bufs=bufs)
            op = bk.advance_plain(tp, rows, trd, trl, A - 1, True, A)
            for name in bk.BranchOut._fields:
                np.testing.assert_array_equal(getattr(ok, name),
                                              getattr(op, name))
            for name in FIELDS:
                assert torch.equal(tk[name], tp[name]), (case, name)
        tk, tp = state_from_numpy(st, "cuda"), state_from_numpy(st, "cuda")
        sk = bk.stats_cuda(tk, list(range(B)), trd, trl, A, bufs=bufs)
        sp = bk.stats_plain(tp, list(range(B)), trd, trl, A)
        for name in bk.BranchOut._fields:
            np.testing.assert_array_equal(getattr(sk, name),
                                          getattr(sp, name))
        fk = bk.finalize_cuda(tk, list(range(B)), trd, trl, bufs=bufs)
        fp = bk.finalize_plain(tp, list(range(B)))
        for a, b in zip(fk, fp):
            np.testing.assert_array_equal(a, b)
        act = np.ones(R, dtype=bool)
        act[5] = False
        bk.root_cuda(tk, 7, act, trl, bufs=bufs)
        bk.root_plain(tp, 7, torch.from_numpy(act).cuda(), trl)
        pairs = np.array([[0, 7], [1, 2]], dtype=np.int32)
        bk.deactivate_cuda(tk, pairs, bufs=bufs)
        bk.deactivate_plain(tp, pairs)
        for name in FIELDS:
            assert torch.equal(tk[name], tp[name]), name
