"""The port's ``TorchScorer.run_extend`` against ``JaxScorer.run_extend``.

On the CPU the port runs its plain PyTorch run loop
(``waffle_con_tpu_torch.ops.run_kernel.run_extend_plain``); the JAX side
runs the Pallas kernel ``_j_run_pallas`` in interpret mode (uniform
offsets) or the XLA loop ``_j_run`` (mixed offsets).  Steps, stop code,
appended bytes, the stats snapshot, the absorbed records and the branch
slot's state rows must be equal exactly.
"""

import jax
import numpy as np
import pytest

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer
from waffle_con_tpu.utils.example_gen import generate_test
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import run_kernel
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


def _dump(out):
    steps, code, appended, stats, records = out
    return (
        steps, code, appended, stats.eds.tolist(), stats.occ.tolist(),
        stats.split.tolist(), stats.reached.tolist(),
        None if stats.fin is None else stats.fin.tolist(),
        [(s, f.tolist()) for s, f in records],
    )


def _slot_rows(state, slot):
    clen = int(state["clen"][slot])
    rows = {k: np.asarray(state[k][slot]) for k in ("D", "e", "rmin", "er")}
    rows["clen"] = clen
    rows["cons"] = np.asarray(state["cons"][slot][:clen])
    return rows


def _assert_rows_equal(a, b):
    assert a["clen"] == b["clen"]
    for k in ("D", "e", "rmin", "er", "cons"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _run_both(reads, *, min_count=3, et=False, wildcard=None,
              initial_band=None, mode="interpret", late=(), prefix=b"",
              **run):
    """Root (reads in ``late`` inactive), push ``prefix``, activate the
    late reads at their offsets, then one ``run_extend`` on each scorer.
    Returns (jax result, torch result, jax slot rows, torch slot rows)."""
    jcfg, tcfg = _configs(min_count, et, wildcard, initial_band)
    js = JaxScorer(reads, jcfg)
    js._pallas_mode = mode
    ts = TorchScorer(reads, tcfg)
    run = dict(dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
                    min_count=min_count, l2=False), **run)
    outs, rows = [], []
    for sc in (js, ts):
        act = np.ones(len(reads), dtype=bool)
        for r, _o in late:
            act[r] = False
        h = sc.root(act)
        for k in range(len(prefix)):
            sc.push(h, prefix[: k + 1])
        for r, o in late:
            sc.activate(h, r, o, prefix)
        outs.append(_dump(sc.run_extend(h, prefix, **run)))
        state = (jax.device_get(sc._state) if sc is js
                 else state_to_numpy(sc._state))
        rows.append(_slot_rows(state, sc._slot_of[h]))
    took_pallas = js.counters.get("run_pallas_calls", 0)
    assert (took_pallas >= 1) == (mode == "interpret" and not late)
    return outs[0], outs[1], rows[0], rows[1]


#: the six cases of tests/test_pallas_run.py
CASES = [
    dict(seed=1, err=0.0, et=False, l2=False, ms=60),
    dict(seed=2, err=0.03, et=False, l2=False, ms=150),
    dict(seed=3, err=0.03, et=True, l2=False, ms=150),
    dict(seed=4, err=0.05, et=True, l2=True, ms=120),
    dict(seed=6, err=0.02, et=False, l2=False, ms=40, force=2),
    dict(seed=7, err=0.0, et=False, l2=False, ms=30, me_budget=20),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"seed{c['seed']}")
def test_run_extend_matches_pallas(case):
    _truth, reads = generate_test(4, 120, 10, case["err"], seed=case["seed"])
    j, t, jr, tr = _run_both(
        reads, et=case["et"], l2=case["l2"], max_steps=case["ms"],
        first_sym=case.get("force", -1),
        me_budget=case.get("me_budget", 2**31 - 1),
    )
    assert j == t
    _assert_rows_equal(jr, tr)


def test_run_extend_records_absorbed():
    """Reads cut short by 0-3 symbols: the run passes reached read ends
    and absorbs their records exactly like the Pallas kernel."""
    _truth, reads = generate_test(4, 120, 10, 0.0, seed=11)
    reads = [r[: len(r) - (k % 4)] for k, r in enumerate(reads)]
    j, t, jr, tr = _run_both(reads, max_steps=200)
    assert j == t
    assert len(t[-1]) >= 1
    _assert_rows_equal(jr, tr)


def test_run_extend_mixed_offsets_match_xla_loop():
    """Late-activated reads put the branch at mixed offsets: the JAX side
    takes the XLA gather loop ``_j_run``, the port the same run loop."""
    truth, reads = generate_test(4, 150, 12, 0.02, seed=9)
    j, t, jr, tr = _run_both(
        reads, mode="off", prefix=truth[:30], late=((3, 6), (7, 11)),
        max_steps=100,
    )
    assert j == t
    assert j[0] > 0
    _assert_rows_equal(jr, tr)


def test_run_extend_band_overflow():
    """A random read drives its edit distance to the band edge: both stop
    with code 5, grow the band and replay to identical rows."""
    _truth, reads = generate_test(4, 120, 10, 0.0, seed=5)
    rng = np.random.default_rng(1)
    reads[0] = bytes(rng.integers(0, 4, size=len(reads[0])).astype(np.uint8))
    j, t, jr, tr = _run_both(reads, max_steps=120)
    assert j == t
    assert t[1] == 5
    _assert_rows_equal(jr, tr)


def test_run_extend_from_carried_state():
    """The JAX branch store, fetched to numpy after a few pushes, becomes
    the port's store through ``state_from_numpy``; the next run then
    matches on both sides, slot rows included."""
    truth, reads = generate_test(4, 120, 10, 0.03, seed=12)
    jcfg, tcfg = _configs(3, False)
    js = JaxScorer(reads, jcfg)
    js._pallas_mode = "interpret"
    h = js.root(np.ones(len(reads), dtype=bool))
    for k in range(25):
        js.push(h, truth[: k + 1])
    ts = TorchScorer(reads, tcfg)
    ts._state = state_from_numpy(jax.device_get(js._state), "cpu")
    ts._B, ts._C, ts._E = js._B, js._C, js._E
    ts._slot_of = dict(js._slot_of)
    ts._free = list(js._free)
    ts._next_handle = js._next_handle
    ts._off_host = js._off_host.copy()
    ts._act_host = js._act_host.copy()
    run = dict(me_budget=2**31 - 1, other_cost=2**31 - 1, other_len=0,
               min_count=3, l2=False, max_steps=80)
    j = _dump(js.run_extend(h, truth[:25], **run))
    t = _dump(ts.run_extend(h, truth[:25], **run))
    assert j == t
    assert j[0] > 0
    _assert_rows_equal(_slot_rows(jax.device_get(js._state), js._slot_of[h]),
                       _slot_rows(state_to_numpy(ts._state), ts._slot_of[h]))


def test_cpu_tensors_take_the_plain_loop():
    """On the CPU the dispatch runs the plain loop and never the kernel
    wrapper (whose counter only moves when it launches)."""
    _truth, reads = generate_test(4, 60, 6, 0.0, seed=3)
    ts = TorchScorer(reads, _configs(2, False)[1])
    h = ts.root(np.ones(len(reads), dtype=bool))
    before = (run_kernel.run_extend_plain.calls,
              run_kernel.run_extend_cuda.launches)
    ts.run_extend(h, b"", 2**31 - 1, 2**31 - 1, 0, 2, False, 20)
    assert run_kernel.run_extend_plain.calls == before[0] + 1
    assert run_kernel.run_extend_cuda.launches == before[1]
    with pytest.raises(ValueError):
        run_kernel.run_extend_cuda(ts._state, 0, ts._reads, ts._rlen, None)
