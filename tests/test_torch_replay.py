"""The port's column replay against the JAX package's.

``replay_rows`` (the plain twin of ``csrc/col_replay.cu``) against
``waffle_con_tpu.ops.jax_scorer._j_replay`` over a whole branch store,
and the activation twin ``activate_row_plain`` against ``_j_activate``,
an overflow included; then ``TorchScorer`` against ``JaxScorer`` call by
call through roots, pushes, activations at several offsets and a forced
band growth.  Every output and every slot row must be equal exactly.
The launch planner ``plan_replay`` is checked here; the CUDA kernel
itself is held to the twin on the card (``chip_smoke.py``'s
``replay_kernel``), and its arithmetic to the twin here by the model in
``test_torch_late_kernel_models.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_scorer import _rows
from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer, _j_activate, _j_replay
from waffle_con_tpu.utils.example_gen import generate_test
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import replay_kernel
from waffle_con_tpu_torch.ops.state_io import state_from_numpy
from waffle_con_tpu_torch.ops.torch_scorer import INF, replay_rows

#: dense id of the wildcard in the draws below (symbols are 0-3)
WC = 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _store(seed, W, B=4, R=16, length=240):
    """A branch store's replay inputs: reads of one truth at 3 % (every
    5th symbol of read 0 the wildcard), slots 0 and 1 holding the truth
    and a variant of it (wildcards in slot 1), slot 2 free (stale rows,
    no consensus) and slot 3 short; mixed anchors (late reads cut at
    theirs, one anchored past its slot's end) and inactive rows."""
    rng = np.random.default_rng(seed)
    truth, reads = generate_test(4, length, R, 0.03, seed=seed)
    reads = [bytearray(r) for r in reads]
    reads[0][::5] = bytes([WC]) * len(reads[0][::5])
    off = np.zeros((B, R), dtype=np.int32)
    for r in (3, 7, 11):
        o = int(rng.integers(20, 120))
        reads[r] = reads[r][o:]
        off[:, r] = o
    off[3, 13] = 200
    act = rng.random((B, R)) < 0.8
    act[:, 0] = True
    L = 256
    rd = np.full((R, L), -1, dtype=np.int16)
    for i, r in enumerate(reads):
        rd[i, :len(r)] = np.frombuffer(bytes(r), dtype=np.uint8)
    rlen = np.array([len(r) for r in reads], dtype=np.int32)
    cons = np.zeros((B, 512), dtype=np.int32)
    t = np.frombuffer(truth, dtype=np.uint8).astype(np.int32)
    cons[0, :length] = t
    cons[1, :length] = t
    cons[1, 30:length:40] = (t[30::40] + 1) % 4
    cons[1, 17:length:50] = WC
    cons[3, :length] = t
    clen = np.array([length, length - 10, 0, 150], dtype=np.int32)
    return dict(off=off, act=act, cons=cons, clen=clen), rd, rlen


@pytest.mark.parametrize("et", [False, True], ids=["no_et", "et"])
@pytest.mark.parametrize("W", [18, 34, 130])
def test_replay_rows_matches_jax(W, et):
    st, rd, rlen = _store(W, W)
    E = (W - 2) // 2
    want = jax.device_get(_j_replay(
        st["off"], st["act"], st["cons"], st["clen"], rd, rlen, WC, et, W))
    t = {k: torch.from_numpy(v) for k, v in st.items()}
    got = replay_rows(t["off"], t["act"], t["cons"], t["clen"],
                      torch.from_numpy(rd), torch.from_numpy(rlen), WC, et,
                      E, W)
    for name, g, w in zip(("D", "e", "rmin", "er"), got, want):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    # the rows that stepped reached the band's interior, the others kept
    # the fresh column
    assert (got[1].numpy()[st["act"] & (st["clen"][:, None] > st["off"])]
            > 0).any()
    assert (got[0].numpy()[~st["act"]] == INF).all()


def _full_state(seed, W):
    """A whole store (band and folds from a replay) for activation."""
    st, rd, rlen = _store(seed, W)
    D, e, rmin, er = jax.device_get(_j_replay(
        st["off"], st["act"], st["cons"], st["clen"], rd, rlen, WC, False,
        W))
    st.update(D=D, e=e, rmin=rmin, er=er)
    return {k: np.asarray(v) for k, v in st.items()}, rd, rlen


@pytest.mark.parametrize("W,slot,read,offset,overflow", [
    (34, 0, 3, None, False),   # a late read from its anchor
    (34, 1, 7, None, False),   # the variant, wildcards in the consensus
    (130, 0, 11, None, False),
    (34, 3, 9, 150, False),    # offset == clen: zero columns
    (34, 3, 9, 170, False),    # offset past clen
    (18, 1, 6, 10, True),      # E=8 over 220 columns of a variant: overflow
])
def test_activate_twin_matches_jax(W, slot, read, offset, overflow):
    st, rd, rlen = _full_state(40 + W, W)
    if offset is None:
        offset = int(st["off"][slot, read])
    state_j = {k: jnp.asarray(v) for k, v in st.items()}
    out_j, ovf_j = _j_activate(
        state_j, rd, rlen, np.asarray([slot, read, offset], np.int32), WC,
        False)
    out_j = jax.device_get(out_j)
    state_t = state_from_numpy(st, "cpu")
    ovf_t = replay_kernel.activate_row_plain(
        state_t, slot, read, offset, torch.from_numpy(rd),
        torch.from_numpy(rlen), WC, False)
    assert ovf_t == bool(ovf_j) == overflow
    for name in st:
        np.testing.assert_array_equal(state_t[name].numpy(),
                                      np.asarray(out_j[name]), err_msg=name)
        if overflow:
            np.testing.assert_array_equal(state_t[name].numpy(), st[name],
                                          err_msg=name)


def test_branch_store_activation_and_growth_match_jax():
    """Root, pushes, activations at several offsets (one at the branch's
    length), band growth forced and from overflow, and pushes after it:
    both stores' slot rows equal after every call, and so are the growth
    and activation counters."""
    truth, reads = generate_test(4, 160, 8, 0.03, seed=51)
    reads = list(reads)
    late = {2: 12, 5: 30, 6: 45}
    for r, o in late.items():
        reads[r] = reads[r][o:]
    scorers = [
        JaxScorer(reads, JaxConfigBuilder().backend("jax").min_count(2)
                  .build()),
        replay_kernel_scorer(reads),
    ]
    seen = []
    plain = replay_kernel.replay_rows_plain.calls
    for sc in scorers:
        log = []
        act = np.ones(len(reads), dtype=bool)
        act[list(late)] = False
        h = sc.root(act)
        (c, _), = sc.clone_push_many([(h, truth[:1], False)])
        log.append(_rows(sc, [h, c]))
        for k in range(1, 60):
            sc.push_many([(c, truth[: k + 1])])
            if k in (12, 30):
                sc.activate(c, {12: 2, 30: 5}[k], late[{12: 2, 30: 5}[k]],
                            truth[: k + 1])
            if k == 40:
                sc._grow_e()
            log.append(_rows(sc, [h, c]))
        sc.activate(c, 6, 60, truth[:60])
        log.append(_rows(sc, [h, c]))
        for k in range(60, 120):
            sc.push_many([(c, truth[: k + 1])])
            log.append(_rows(sc, [h, c]))
        log.append({k: sc.counters.get(k, 0) for k in (
            "activate_calls", "grow_e_events", "replayed_cols")})
        seen.append(log)
    assert seen[0] == seen[1]
    assert seen[1][-1]["grow_e_events"] >= 2
    assert replay_kernel.replay_rows_plain.calls > plain


def replay_kernel_scorer(reads):
    from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer

    return TorchScorer(reads, CdwfaConfigBuilder().backend("torch")
                       .device("cpu").min_count(2).build())


@pytest.mark.parametrize("rows,W", [
    (1, 18), (4096, 34), (1056, 34), (1057, 66), (1, 80), (1, 82),
    (4096, 258), (1, 544), (1, 546),
    (1, 2050), (1024, 2050), (3, 4608), (3, 4610), (1, 8704), (1, 8706),
    (7, 29056), (4, 29058), (4096, 32770), (2, 65538), (1, 139264),
    (2, 139266)])
def test_replay_plan(rows, W):
    """Each lane holds a run of cells in registers.  A row takes a warp
    up to W = 544 (warps spread over at least the card's SMs, up to 8 a
    CTA, however many rows), up to 16 warps of one CTA up to W = 8704, a
    cluster of up to 16 such CTAs up to W = 139264 (W = 16386 and 32770,
    E = 8192 and 16384, among them), and only wider rows take the
    device-memory last resort."""
    plan = replay_kernel.plan_replay(rows, W)
    cells = replay_kernel.REPLAY_CELLS
    sms = replay_kernel.SMS
    if W > 139264:
        assert plan.placement == "global"
        assert plan.cells == 0 and plan.smem_bytes == 0
        assert plan.warps == min(8, rows)
        assert plan.blocks == -(-rows // plan.warps)
        return
    assert plan.cells in cells
    if W <= 544:
        assert plan.placement == "warp" and 32 * plan.cells >= W
        smaller = [c for c in cells if c < plan.cells]
        assert not smaller or 32 * smaller[-1] < W
        assert plan.row_warps == plan.ctas == 1 and plan.smem_bytes == 0
        assert plan.warps == min(8, max(1, -(-rows // sms)))
        assert plan.blocks == -(-rows // plan.warps)
        return
    assert plan.warps == plan.row_warps <= 16
    assert plan.cells == (9 if W <= 4608 else 17)
    assert plan.smem_bytes == 2 * 16 * plan.row_warps * plan.ctas
    assert plan.blocks == rows * plan.ctas
    span = 32 * plan.cells
    if W <= 8704:
        assert plan.placement == "cta" and plan.ctas == 1
        assert span * plan.row_warps >= W > span * (plan.row_warps - 1)
    else:
        assert plan.placement == "cluster"
        assert plan.ctas == -(-W // (span * 16)) and 2 <= plan.ctas <= 16
        assert plan.row_warps == -(-(-(-W // span)) // plan.ctas)
        assert span * plan.row_warps * plan.ctas >= W


@pytest.mark.parametrize("rows,W", [(0, 18), (4, 17), (4, 2)])
def test_replay_plan_refuses(rows, W):
    with pytest.raises(ValueError):
        replay_kernel.plan_replay(rows, W)


def test_replay_kernel_refuses_cpu_tensors():
    """The kernel's wrappers never fall back to the twin."""
    st, rd, rlen = _full_state(60, 34)
    state = state_from_numpy(st, "cpu")
    reads, rl = torch.from_numpy(rd), torch.from_numpy(rlen)
    with pytest.raises(ValueError):
        replay_kernel.replay_rows_cuda(
            state["off"], state["act"], state["cons"], state["clen"], reads,
            rl, WC, False, 16, 34)
    with pytest.raises(ValueError):
        replay_kernel.activate_row_cuda(state, 0, 3, 10, reads, rl, WC,
                                        False)
    with pytest.raises(ValueError):
        replay_kernel.replay_rows(
            state["off"].to("meta"), state["act"], state["cons"],
            state["clen"], reads, rl, WC, False, 16, 34)
