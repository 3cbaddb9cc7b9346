"""The port's activation-offset scan against the JAX package's.

``offset_scan`` (the plain twin of ``csrc/offset_scan.cu``) against
``waffle_con_tpu.ops.jax_scorer._j_offset_scan`` on seeded numpy draws,
with exact integer equality; then ``TorchScorer.best_activation_offset``
against ``JaxScorer.best_activation_offset`` on both sides of the host
fallback rule, on a repeat consensus where positions tie, and with the
wildcard, and through a ``SubsetScorer`` view.  The CUDA kernel itself is
held to the twin on the card (``chip_smoke.py``'s ``replay_kernel``), and
its bit-vector recurrence to the twin here by the model in
``test_torch_late_kernel_models.py``.
"""

import numpy as np
import pytest
import torch

from waffle_con_tpu.config import CdwfaConfigBuilder as JaxConfigBuilder
from waffle_con_tpu.ops.jax_scorer import JaxScorer, _j_offset_scan
from waffle_con_tpu_torch.config import CdwfaConfigBuilder
from waffle_con_tpu_torch.ops import replay_kernel
from waffle_con_tpu_torch.ops.scorer import SubsetScorer
from waffle_con_tpu_torch.ops.torch_scorer import TorchScorer, offset_scan


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's small CPU tensors (the test
    workers share the host's cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw(seed, P, M, m, real, wild):
    """A window of ``real`` symbols (0-3) padded with -2 and a head of
    ``m`` symbols padded with -3, the head copied from the window at one
    position with a few edits; ``wild`` names the side(s) that get the
    wildcard id 4."""
    rng = np.random.default_rng(seed)
    win = np.full(P + 2 * M, -2, dtype=np.int32)
    win[:real] = rng.integers(0, 4, real)
    heads = np.full((2, M), -3, dtype=np.int32)
    for b in range(2):
        at = int(rng.integers(0, max(1, real - m)))
        seg = win[at:at + m]
        heads[b, :len(seg)] = seg
        heads[b, len(seg):m] = rng.integers(0, 4, m - len(seg))
        flip = rng.choice(m, size=max(1, m // 8), replace=False)
        heads[b, flip] = rng.integers(0, 4, len(flip))
    if "head" in wild:
        heads[:, rng.choice(m, size=max(1, m // 10), replace=False)] = 4
    if "window" in wild:
        win[rng.choice(real, size=max(1, real // 10), replace=False)] = 4
    return win, heads


@pytest.mark.parametrize("wild", ["", "head", "window", "head+window"])
@pytest.mark.parametrize("P,M", [(1, 8), (8, 8), (64, 64), (32, 128),
                                 (2, 2048)])
def test_offset_scan_matches_jax(P, M, wild):
    """Every score equal, with a compare length below M, a window that
    runs into its padding, and the wildcard on either side or both."""
    m = M - M // 4 - 1
    real = max(1, P + 2 * M - M // 2 - 3)
    wc = 4 if wild else -2
    win, heads = _draw(P * 1000 + M + len(wild), P, M, m, real, wild)
    want = np.asarray(_j_offset_scan(win, heads, np.int32(m), wc, P, M))
    got = offset_scan(torch.from_numpy(win), torch.from_numpy(heads), m, wc,
                      P, M).numpy()
    assert got.dtype == np.int32 and got.shape == (2, P)
    np.testing.assert_array_equal(got, want)


def _pair(reads, **cfg):
    jb = JaxConfigBuilder().backend("jax")
    tb = CdwfaConfigBuilder().backend("torch").device("cpu")
    for k, v in cfg.items():
        jb, tb = getattr(jb, k)(v), getattr(tb, k)(v)
    return JaxScorer(reads, jb.build()), TorchScorer(reads, tb.build())


def _offsets(pair, cases, wildcard=None):
    """Each scorer's offset for every ``(consensus, read, window,
    compare length)``, and its ``offset_scan_calls``."""
    out = []
    for sc in pair:
        got = [sc.best_activation_offset(cons, i, ow, ocl, wildcard)
               for cons, i, ow, ocl in cases]
        out.append((got, sc.counters.get("offset_scan_calls", 0)))
    return out


def test_best_activation_offset_fallback_rule():
    """Both sides of ``n_pos <= 1 or cmp_len * n_pos < 512``: 511 and
    512, and windows of 0 and 1 positions; equal offsets and equal scan
    counts (the device scan runs only where JAX's does)."""
    rng = np.random.default_rng(3)
    cons = bytes(rng.integers(0, 4, 900).astype(np.uint8))
    reads = [cons[300:], cons[500:] + b"\x01\x02", cons[:700], cons[100:]]
    cases = [
        (cons[:380], 0, 73, 7),    # 7 * 73 = 511: host loop
        (cons[:380], 0, 64, 8),    # 8 * 64 = 512: device scan
        (cons[:560], 1, 73, 7),
        (cons[:560], 1, 64, 8),
        (cons[:6], 0, 50, 50),     # con_len <= cmp_len: 0 positions
        (cons[:800], 2, 1, 600),   # 1 position, 600 >= 512: host loop
        (cons[:800], 3, 2, 600),   # 2 positions: device scan
        (cons[:160], 3, 50, 50),   # the defaults: device scan
    ]
    before = replay_kernel.offset_scan_plain.calls
    (want, n_j), (got, n_t) = _offsets(_pair(reads), cases)
    assert got == want
    assert n_t == n_j == 4
    assert replay_kernel.offset_scan_plain.calls - before == 4


def test_best_activation_offset_ties_and_wildcard():
    """A repeat consensus (``ACGT`` x k): every in-phase position scores
    alike, so the midpoint incumbent and the first-best rule decide; then
    the same with the wildcard in the reads and the consensus."""
    rep = b"ACGT" * 60
    reads = [rep, rep[2:], rep[1:] + b"A", b"CGTACG" + rep]
    cases = [(rep[:k], i, ow, ocl)
             for k in (120, 161, 233) for i in range(4)
             for ow, ocl in ((50, 50), (40, 16), (200, 20))]
    (want, n_j), (got, n_t) = _offsets(_pair(reads), cases)
    assert got == want and n_t == n_j > 0
    starred = [rep[:40] + b"*" + rep[41:], rep[2:77] + b"**" + rep[79:],
               rep[1:], b"CG*ACG" + rep]
    cons = rep[:100] + b"*" + rep[101:200]
    cases = [(cons, i, ow, ocl) for i in range(4)
             for ow, ocl in ((50, 50), (64, 30))]
    pair = _pair(starred, wildcard=ord("*"))
    (want, n_j), (got, n_t) = _offsets(pair, cases, ord("*"))
    assert got == want and n_t == n_j > 0


def test_subset_view_maps_the_read_index():
    """A ``SubsetScorer`` view gives the base's offset at the mapped
    index, and its scans are the base's."""
    rng = np.random.default_rng(5)
    cons = bytes(rng.integers(0, 4, 600).astype(np.uint8))
    reads = [cons, cons[120:], cons[40:], cons[250:], cons[333:]]
    base = TorchScorer(
        reads, CdwfaConfigBuilder().backend("torch").device("cpu").build())
    view = SubsetScorer(base, [1, 3, 4])
    for local, full in ((0, 1), (1, 3), (2, 4)):
        got = view.best_activation_offset(cons[:450], local, 50, 50, None)
        want = base.best_activation_offset(cons[:450], full, 50, 50, None)
        assert got == want
    assert base.counters["offset_scan_calls"] == 6
    assert view.counters is base.counters


@pytest.mark.parametrize("B,P,M,m", [
    (1, 1, 8, 5), (1, 64, 64, 50), (1, 64, 64, 64), (1, 64, 128, 65),
    (2, 128, 256, 200), (1, 4, 1024, 1000), (1, 2, 2048, 1500),
    (1, 8, 4096, 2047), (1, 8, 4096, 2048), (1, 8, 4096, 2049),
    (1, 8, 8192, 8000), (1, 1, 16384, 300), (1, 8, 32768, 50),
    (3, 4, 32768, 20000), (1, 8, 8, 0)])
def test_scan_plan(B, P, M, m):
    """Up to m = 2048 a position takes the least power-of-two group of
    lanes with 64 head rows a lane (one thread for m <= 64), its column in
    registers and Peq in shared memory, CTAs of up to 256 threads; longer
    heads take one warp a position (up to 8 a CTA), the column in shared
    memory beside Peq while both fit, else Peq in device memory.  No
    placement keeps a column in device memory."""
    plan = replay_kernel.plan_offset_scan(B, P, M, m)
    limit = replay_kernel.SMEM_LIMIT
    rows = replay_kernel.PEQ_ROWS
    assert plan.threads % 32 == 0 and 32 <= plan.threads <= 256
    assert plan.smem_bytes <= limit
    if m <= 2048:
        g = plan.group
        assert g >= 1 and g & (g - 1) == 0 and 64 * g >= m
        assert g == 1 or 32 * g < m
        assert plan.column == "registers" and plan.table == "smem"
        assert plan.nwp == g and plan.smem_bytes == 8 * rows * g
        assert plan.threads == min(256, max(32, P * g))
        per = plan.threads // g
        assert plan.blocks == B * -(-P // per)
    else:
        assert plan.group == 0 and plan.column == "smem"
        words = -(-m // 64)
        assert plan.nwp == 32 * -(-words // 32)
        warps = plan.threads // 32
        assert 1 <= warps <= min(8, P) and plan.blocks == B * (P // warps)
        cols = 16 * plan.nwp * warps
        table = 8 * rows * plan.nwp
        if plan.table == "smem":
            assert plan.smem_bytes == table + cols
            assert warps == min(8, P) or table + 2 * cols > limit
        else:
            assert plan.table == "global" and plan.smem_bytes == cols
            assert table + 16 * plan.nwp > limit
            assert warps == min(8, P) or 2 * cols > limit


@pytest.mark.parametrize("B,P,M,m", [(0, 8, 8, 4), (1, 3, 8, 4),
                                     (1, 8, 6, 4), (1, 8, 8, 9),
                                     (1, 8, 8, -1), (1, 8, 2**20, 2**20)])
def test_scan_plan_refuses(B, P, M, m):
    """Shapes outside the contract, and a head too long for even one
    warp's column in shared memory."""
    with pytest.raises(ValueError):
        replay_kernel.plan_offset_scan(B, P, M, m)


def test_scan_kernel_refuses_cpu_tensors():
    """The kernel's wrapper never falls back to the twin."""
    win = torch.zeros(8 + 16, dtype=torch.int32)
    heads = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        replay_kernel.offset_scan_cuda(win, heads, 5, -2, 8, 8, 4)


@pytest.mark.parametrize("num_symbols", [257, 1000])
def test_scan_kernel_refuses_a_wide_alphabet(num_symbols):
    """The kernel's match table has a row for each id below 256, so the
    wrapper refuses a wider alphabet, whose ids would share a row and
    score wrongly, before it looks at the tensors."""
    win = torch.zeros(8 + 16, dtype=torch.int32)
    heads = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError, match="alphabet of"):
        replay_kernel.offset_scan_cuda(win, heads, 5, -2, 8, 8, num_symbols)
