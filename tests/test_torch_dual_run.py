"""The port's ``TorchScorer.run_extend_dual`` against
``JaxScorer.run_extend_dual``.

On the CPU the port runs its plain PyTorch dual loop
(``waffle_con_tpu_torch.ops.run_dual_kernel.run_extend_dual_plain``); the
JAX side runs the Pallas kernel ``_j_run_dual_pallas`` in interpret mode
(uniform offsets) or the XLA loop ``_j_run_dual`` in gather mode (mixed
offsets).  Steps, stop code, both appended strings, both stats
snapshots, both activity masks, the absorbed records and both branch
slots' state rows must be equal exactly (the DP is integer; vote
decisions are covered by the VOTE_EPS contract).
"""

import jax
import numpy as np
import pytest

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu.utils.example_gen import corrupt, generate_test
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import run_dual_kernel
from waffle_con_tpu_torch.ops.state_io import state_from_numpy, state_to_numpy
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer


def _configs(min_count, et, wildcard=None, initial_band=None):
    jb = JaxConfigBuilder().min_count(min_count).allow_early_termination(et)
    tb = CdwfaConfigBuilder().min_count(min_count).allow_early_termination(et)
    jb = jb.backend("jax")
    tb = tb.backend("torch").device("cpu")
    if wildcard is not None:
        jb, tb = jb.wildcard(wildcard), tb.wildcard(wildcard)
    if initial_band is not None:
        jb, tb = jb.initial_band(initial_band), tb.initial_band(initial_band)
    return jb.build(), tb.build()


def _dual_reads(seed, err, snps=((40, 1), (90, 2))):
    """tests/test_pallas_run.py's ``_dual_once`` reads: 6 reads of one
    haplotype, 6 of a second that differs at ``snps``."""
    rng = np.random.default_rng(seed)
    t1, reads1 = generate_test(4, 140, 6, err, seed=seed)
    t2 = bytearray(t1)
    for pos, shift in snps:
        t2[pos] = (t2[pos] + shift) % 4
    reads2 = [corrupt(bytes(t2), err, rng) for _ in range(6)]
    return t1, bytes(t2), list(reads1) + reads2


def _dump(out):
    (steps, code, app1, app2, st1, st2, act1, act2, records) = out
    dump = lambda st: (  # noqa: E731
        st.eds.tolist(), st.occ.tolist(), st.split.tolist(),
        np.asarray(st.reached, dtype=bool).tolist(),
    )
    recs = [
        (s, f1.tolist(), f2.tolist(), np.asarray(a1, bool).tolist(),
         np.asarray(a2, bool).tolist())
        for s, f1, f2, a1, a2 in records
    ]
    return (steps, code, app1, app2, dump(st1), dump(st2),
            np.asarray(act1, bool).tolist(), np.asarray(act2, bool).tolist(),
            recs)


def _slot_rows(state, slot):
    clen = int(state["clen"][slot])
    rows = {k: np.asarray(state[k][slot])
            for k in ("D", "e", "rmin", "er", "act")}
    rows["clen"] = clen
    rows["cons"] = np.asarray(state["cons"][slot][:clen])
    return rows


def _assert_rows_equal(a, b):
    assert a["clen"] == b["clen"]
    for k in ("D", "e", "rmin", "er", "act", "cons"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _run_both(reads, *, min_count=3, et=False, wildcard=None,
              initial_band=None, mode="interpret", prefix1=b"", prefix2=b"",
              late=(), inactive1=(), inactive2=(), **run):
    """Root two slots (reads in ``late`` and ``inactive1`` inactive on
    slot 1, ``inactive2`` on slot 2), push each slot's prefix, activate
    the late reads on slot 1, then one ``run_extend_dual`` on each
    scorer.  Returns (jax result, torch result, jax slot rows, torch slot
    rows)."""
    jcfg, tcfg = _configs(min_count, et, wildcard, initial_band)
    js = JaxScorer(reads, jcfg)
    js._pallas_mode = mode
    ts = TorchScorer(reads, tcfg)
    run = dict(dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
                    min_count=min_count, ed_delta=5, imb_min=2, l2=False,
                    weighted=False), **run)
    outs, rows = [], []
    for sc in (js, ts):
        act1 = np.ones(len(reads), dtype=bool)
        act1[[r for r, _o in late] + list(inactive1)] = False
        act2 = np.ones(len(reads), dtype=bool)
        act2[list(inactive2)] = False
        ha = sc.root(act1)
        hb = sc.root(act2)
        for h, prefix in ((ha, prefix1), (hb, prefix2)):
            for k in range(len(prefix)):
                sc.push(h, prefix[: k + 1])
        for r, o in late:
            sc.activate(ha, r, o, prefix1)
        outs.append(_dump(sc.run_extend_dual(ha, hb, prefix1, prefix2, **run)))
        state = (jax.device_get(sc._state) if sc is js
                 else state_to_numpy(sc._state))
        rows.append([_slot_rows(state, sc._slot_of[h]) for h in (ha, hb)])
    took_pallas = js.counters.get("run_dual_pallas_calls", 0)
    assert (took_pallas >= 1) == (mode == "interpret" and not late)
    return outs[0], outs[1], rows[0], rows[1]


def _check(j, t, jr, tr):
    assert j == t
    for a, b in zip(jr, tr):
        _assert_rows_equal(a, b)


#: the five dual cases of tests/test_pallas_run.py
DUAL_CASES = [
    dict(seed=41, err=0.0, et=False, l2=False, weighted=False, ms=120),
    dict(seed=42, err=0.02, et=False, l2=False, weighted=False, ms=120),
    dict(seed=43, err=0.02, et=True, l2=False, weighted=True, ms=120),
    dict(seed=44, err=0.03, et=False, l2=True, weighted=False, ms=100,
         delta=2),
    dict(seed=45, err=0.0, et=True, l2=False, weighted=False, ms=160),
]


@pytest.mark.parametrize("case", DUAL_CASES, ids=lambda c: f"seed{c['seed']}")
def test_run_extend_dual_matches_pallas(case):
    _t1, _t2, reads = _dual_reads(case["seed"], case["err"])
    _check(*_run_both(
        reads, et=case["et"], l2=case["l2"], weighted=case["weighted"],
        max_steps=case["ms"], ed_delta=case.get("delta", 5),
    ))


@pytest.mark.parametrize("lock", ["lock1", "lock2"])
def test_run_extend_dual_locked_side(lock):
    """One side locked (the other at least as long): the locked side is
    frozen, casts no vote and commits no symbol, but its distances still
    count in the node cost and the pruning."""
    t1, t2, reads = _dual_reads(46, 0.02)
    long_, short = (t2[:12], t1[:8]) if lock == "lock1" else (t1[:8], t2[:12])
    p1, p2 = (short, long_) if lock == "lock1" else (long_, short)
    j, t, jr, tr = _run_both(reads, prefix1=p1, prefix2=p2, max_steps=80,
                             **{lock: True})
    _check(j, t, jr, tr)
    assert t[0] > 0
    assert (t[2] if lock == "lock1" else t[3]) == b""


def test_run_extend_dual_dynamic_tables():
    """``mc_dyn`` with non-constant ``mc_tab`` / ``imb_tab`` (the
    ``min_af != 0`` arithmetic)."""
    _t1, _t2, reads = _dual_reads(47, 0.01)
    n = len(reads)
    mc_tab = np.array([max(2, -(-n // 4) if k > 8 else 2) for k in range(n + 1)],
                      dtype=np.int32)
    imb_tab = np.array([2, 2, 3, 3, 3, 4], dtype=np.int32)
    _check(*_run_both(reads, max_steps=120, mc_tab=mc_tab, imb_tab=imb_tab,
                      mc_dyn=True, rec_min=4))


def test_run_extend_dual_imbalance_stop():
    """A committed step leaves a side with fewer active reads than the
    imbalance floor: code 6, the step committed."""
    t1, t2, reads = _dual_reads(48, 0.0)
    j, t, jr, tr = _run_both(reads, prefix1=t1[:45], prefix2=t2[:45],
                             max_steps=150, ed_delta=0, imb_min=7)
    _check(j, t, jr, tr)
    assert t[1] == 6
    assert t[0] >= 1


def test_run_extend_dual_records_absorbed():
    """Side 1 locked at the end of its reads, side 2 extending to the end
    of its own (in band): every step passes a reached state, whose record
    both absorb alike, until side 2 finishes."""
    t1, t2, reads = _dual_reads(52, 0.0)
    reads = [r[:100] if k < 6 else r[:106] for k, r in enumerate(reads)]
    j, t, jr, tr = _run_both(
        reads, prefix1=t1[:100], prefix2=t2[:100], max_steps=200,
        lock1=True, inactive1=range(6, 12), inactive2=range(6),
    )
    _check(j, t, jr, tr)
    assert len(t[8]) == t[0] == 6


def test_run_extend_dual_band_overflow():
    """A random read on a tiny band: both stop with code 5, grow the band
    and replay to identical rows."""
    _t1, _t2, reads = _dual_reads(49, 0.0)
    rng = np.random.default_rng(3)
    reads[0] = bytes(rng.integers(0, 4, size=len(reads[0])).astype(np.uint8))
    j, t, jr, tr = _run_both(reads, max_steps=120, initial_band=2,
                             ed_delta=200)
    _check(j, t, jr, tr)
    assert t[1] == 5


def test_run_extend_dual_mixed_offsets_match_xla_loop():
    """Late-activated reads put slot 1 at mixed offsets: the JAX side
    takes the XLA gather loop ``_j_run_dual`` (``uniform=False``), the
    port the same kernel as always."""
    t1, _t2, reads = _dual_reads(50, 0.02)
    j, t, jr, tr = _run_both(reads, mode="off", prefix1=t1[:30],
                             prefix2=t1[:30], late=((3, 6), (8, 11)),
                             max_steps=100)
    _check(j, t, jr, tr)
    assert t[0] > 0


def test_run_extend_dual_from_carried_state():
    """The JAX branch store after a split, fetched to numpy, becomes the
    port's store through ``state_from_numpy``; the next dual run then
    matches on both sides, both slots' rows included."""
    t1, t2, reads = _dual_reads(51, 0.02)
    jcfg, tcfg = _configs(3, False)
    js = JaxScorer(reads, jcfg)
    js._pallas_mode = "interpret"
    ha = js.root(np.ones(len(reads), dtype=bool))
    hb = js.root(np.ones(len(reads), dtype=bool))
    for k in range(42):
        js.push(ha, t1[: k + 1])
        js.push(hb, t2[: k + 1])
    ts = TorchScorer(reads, tcfg)
    ts._state = state_from_numpy(jax.device_get(js._state), "cpu")
    ts._B, ts._C, ts._E = js._B, js._C, js._E
    ts._slot_of = dict(js._slot_of)
    ts._free = list(js._free)
    ts._next_handle = js._next_handle
    ts._off_host = js._off_host.copy()
    ts._act_host = js._act_host.copy()
    run = dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
               min_count=3, ed_delta=5, imb_min=2, l2=False, weighted=False,
               max_steps=80)
    j = _dump(js.run_extend_dual(ha, hb, t1[:42], t2[:42], **run))
    t = _dump(ts.run_extend_dual(ha, hb, t1[:42], t2[:42], **run))
    assert j == t
    assert j[0] > 0
    jst, tst = jax.device_get(js._state), state_to_numpy(ts._state)
    for h in (ha, hb):
        _assert_rows_equal(_slot_rows(jst, js._slot_of[h]),
                           _slot_rows(tst, ts._slot_of[h]))
    np.testing.assert_array_equal(ts._act_host, js._act_host)


def test_cpu_tensors_take_the_plain_dual_loop():
    """On the CPU the dispatch runs the plain loop and never the kernel
    wrapper (whose counter only moves when it launches)."""
    _t1, _t2, reads = _dual_reads(41, 0.0)
    ts = TorchScorer(reads, _configs(3, False)[1])
    ha = ts.root(np.ones(len(reads), dtype=bool))
    hb = ts.root(np.ones(len(reads), dtype=bool))
    before = (run_dual_kernel.run_extend_dual_plain.calls,
              run_dual_kernel.run_extend_dual_cuda.launches)
    ts.run_extend_dual(ha, hb, b"", b"", 2**31 - 1, 2**31 - 1, 0, 3, 5, 2,
                       False, False, 20)
    assert run_dual_kernel.run_extend_dual_plain.calls == before[0] + 1
    assert run_dual_kernel.run_extend_dual_cuda.launches == before[1]
    with pytest.raises(ValueError):
        run_dual_kernel.run_extend_dual_cuda(ts._state, 0, 1, ts._reads,
                                             ts._rlen, None, None, None)
