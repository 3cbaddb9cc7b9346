"""Late reads and band growth behind ``TorchScorer``: the activation-offset
scan and the column replay.

Two kernels, each in the style of :mod:`~waffle_con_tpu_torch.ops.run_kernel`:

* the offset scan (``csrc/offset_scan.cu``), which scores every window
  position of a late read's start in one launch, a bit-parallel
  edit-distance scan (Myers' bit vectors) — ``waffle_con_tpu``'s
  ``_j_offset_scan`` (``ops/jax_scorer.py``).  Plain twin:
  :func:`~waffle_con_tpu_torch.ops.torch_scorer.offset_scan`.
* the column replay (``csrc/col_replay.cu``), which rebuilds band rows
  from their anchors by replaying each slot's consensus, each row's cells
  in registers of a warp, a CTA or a thread-block cluster
  (:func:`plan_replay`).  It serves band growth (every row into fresh
  tensors at the new width, ``_j_replay``) and activation (one row
  caught up over the branch's consensus and committed in place unless
  it overflows the band, ``_j_activate``).  Plain twin:
  :func:`~waffle_con_tpu_torch.ops.torch_scorer.replay_rows`.

Dispatch follows the run kernels: tensors on the CPU take the plain
twin, tensors on a CUDA device launch the kernel or raise.  The kernels
count their launches (``offset_scan_cuda.launches``,
``replay_rows_cuda.launches``: both modes of the replay), the twins their
calls (``offset_scan_plain.calls``, ``replay_rows_plain.calls``).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.ops import torch_scorer as ts
from waffle_con_tpu_torch.runtime import faults

#: shared memory a CTA may use on an H100 (227 KB, the opt-in maximum)
SMEM_LIMIT = 232448
#: streaming multiprocessors of an H100 SXM
SMS = 132
#: rows of Peq, the offset scan's match table: ids 0-255 and one for
#: every other symbol
PEQ_ROWS = 257
#: the offset scan's longest head whose column sits in registers, one
#: 64-bit word a lane of a warp
SCAN_REG_ROWS = 2048
#: cells per lane of the column replay's register runs, one kernel
#: instance each
REPLAY_CELLS = (1, 2, 3, 5, 9, 17)
#: warps of a CTA on one row of the column replay, and CTAs of one row
ROW_WARPS = 16
MAX_CLUSTER = 16


class ScanPlan(NamedTuple):
    """Launch geometry of one offset scan."""

    #: lanes per window position, one 64-bit word of the column each, in
    #: registers; 0: one warp per position, the column in shared memory
    group: int
    #: threads of a CTA
    threads: int
    #: CTAs: ``B`` times a head's positions over a CTA's
    blocks: int
    #: 64-bit words of one row of the match table Peq
    nwp: int
    #: dynamic shared memory of a CTA (Peq where it is on chip, then for
    #: ``group`` 0 two words a row a position), bytes
    smem_bytes: int
    #: where Peq lives: ``"smem"`` or (long heads) ``"global"``, one
    #: table a CTA
    table: str

    @property
    def column(self) -> str:
        """Where the columns live: registers or smem."""
        return "registers" if self.group else "smem"


def plan_offset_scan(B: int, P: int, M: int, m: int) -> ScanPlan:
    """The offset scan's launch geometry for ``B`` heads, ``P`` window
    positions, heads of ``M`` symbols (``P`` and ``M`` powers of two) and
    the compare length ``m``.  Up to ``m = 2048`` the column sits in
    registers: the least power-of-two group of lanes with 64 rows a lane
    takes a position (one thread for ``m <= 64``), CTAs of up to 256
    threads, Peq in shared memory.  Longer heads take one warp a
    position, up to 8 a CTA, the column in shared memory beside Peq when
    both fit, else Peq in device memory.  Raises ``ValueError`` on any
    other shape."""
    pow2 = lambda n: n >= 1 and n & (n - 1) == 0  # noqa: E731
    if B < 1 or not pow2(P) or not pow2(M) or not 0 <= m <= M:
        raise ValueError(
            f"no offset-scan plan for B={B}, P={P}, M={M}, m={m}")
    words = -(-m // 64)
    if m <= SCAN_REG_ROWS:
        group = 1
        while 64 * group < m:
            group *= 2
        threads = min(256, max(32, P * group))
        per = threads // group
        return ScanPlan(group, threads, B * -(-P // per), group,
                        8 * PEQ_ROWS * group, "smem")
    nwp = 32 * -(-words // 32)
    table = 8 * PEQ_ROWS * nwp
    for where, fixed in (("smem", table), ("global", 0)):
        warps = min(8, P)
        while warps and fixed + 16 * nwp * warps > SMEM_LIMIT:
            warps //= 2
        if warps:
            return ScanPlan(0, 32 * warps, B * (P // warps), nwp,
                            fixed + 16 * nwp * warps, where)
    raise ValueError(f"no offset-scan plan for m={m}: too long a head")


class ReplayPlan(NamedTuple):
    """Launch geometry of one column-replay launch."""

    #: cells of a row each lane holds in registers; 0 for the
    #: device-memory last resort (one warp a row, columns in device
    #: memory)
    cells: int
    #: warps a row takes in a CTA
    row_warps: int
    #: CTAs a row takes: a thread-block cluster when more than one
    ctas: int
    #: warps of a CTA
    warps: int
    #: CTAs of the launch
    blocks: int
    #: dynamic shared memory of a CTA (two 16-byte records a warp of a
    #: multi-warp row), bytes
    smem_bytes: int

    @property
    def placement(self) -> str:
        """``"warp"`` (a row on one warp), ``"cta"``,
        ``"cluster"`` or ``"global"``."""
        if not self.cells:
            return "global"
        if self.ctas > 1:
            return "cluster"
        return "cta" if self.row_warps > 1 else "warp"


def plan_replay(rows: int, W: int) -> ReplayPlan:
    """The column replay's launch geometry for ``rows`` rows of ``W``
    band cells, each lane a run of ``cells`` cells in registers.  A row
    takes a warp up to W = 544 (at most 17 cells a lane), warps spread
    over up to 8 a CTA and at least ``SMS`` CTAs.  Wider rows take up to
    16 warps of one CTA (9 cells a lane up to W = 4608, then 17: W <=
    8704), then a cluster of up to 16 such CTAs (W <= 139,264), one row a
    CTA or a cluster.  Wider rows fall back to the device-memory last
    resort, 8 rows a CTA.  Raises ``ValueError`` on an empty launch or an
    odd or too narrow band."""
    if rows < 1 or W < 4 or W % 2:
        raise ValueError(f"no replay plan for rows={rows}, W={W}")
    cells = next((c for c in REPLAY_CELLS if 32 * c >= W), None)
    if cells:
        warps = min(8, max(1, -(-rows // SMS)))
        return ReplayPlan(cells, 1, 1, warps, -(-rows // warps), 0)
    cells = 9 if W <= 32 * ROW_WARPS * 9 else REPLAY_CELLS[-1]
    need = -(-W // (32 * cells))  # warps
    ctas = -(-need // ROW_WARPS)
    if ctas > MAX_CLUSTER:
        warps = min(8, rows)
        return ReplayPlan(0, 1, 1, warps, -(-rows // warps), 0)
    warps = -(-need // ctas)
    return ReplayPlan(cells, warps, ctas, warps, rows * ctas,
                      2 * 16 * warps * ctas)


# ---------------------------------------------------------------------
# plain twins (tensors on the CPU)


def offset_scan_plain(cons_win, heads, m: int, wc: int, P: int, M: int):
    """:func:`~waffle_con_tpu_torch.ops.torch_scorer.offset_scan`,
    counted in ``offset_scan_plain.calls``."""
    offset_scan_plain.calls += 1
    return ts.offset_scan(cons_win, heads, m, wc, P, M)


offset_scan_plain.calls = 0


def replay_rows_plain(off, act, cons, clen, reads, rlen, wc: int, et: bool,
                      E: int, W: int):
    """:func:`~waffle_con_tpu_torch.ops.torch_scorer.replay_rows`,
    counted in ``replay_rows_plain.calls``."""
    replay_rows_plain.calls += 1
    return ts.replay_rows(off, act, cons, clen, reads, rlen, wc, et, E, W)


replay_rows_plain.calls = 0


def activate_row_plain(state, slot: int, read: int, offset: int, reads, rlen,
                       wc: int, et: bool) -> bool:
    """Row ``(slot, read)`` of the branch store restarted at consensus
    ``offset`` and caught up over the slot's consensus
    (:func:`replay_rows_plain` over that one row), committed with
    ``off = offset`` and ``act`` set unless its edit distance reaches
    the band (``e >= E``).  Returns that overflow flag."""
    W = state["D"].shape[2]
    E = (W - 2) // 2
    dev = state["D"].device
    off1 = torch.full((1, 1), offset, dtype=torch.int32, device=dev)
    act1 = torch.ones((1, 1), dtype=torch.bool, device=dev)
    D, e, rmin, er = replay_rows_plain(
        off1, act1, state["cons"][slot:slot + 1],
        state["clen"][slot:slot + 1], reads[read:read + 1],
        rlen[read:read + 1], wc, et, E, W,
    )
    if int(e[0, 0]) >= E:
        return True
    for name, val in (("D", D[0, 0]), ("e", e[0, 0]), ("rmin", rmin[0, 0]),
                      ("er", er[0, 0])):
        state[name][slot, read] = val
    state["off"][slot, read] = offset
    state["act"][slot, read] = True
    return False


# ---------------------------------------------------------------------
# CUDA kernels: bind, launch (the build lives in ops/cuda_build.py)


def _bind(name, argtypes):
    fn = getattr(cuda_build.library(), name)
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes
    return fn


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _need(t, dtype, dev, name, shape=None):
    if (t.dtype != dtype or t.device != dev or not t.is_contiguous()
            or (shape is not None and tuple(t.shape) != tuple(shape))):
        want = "" if shape is None else f" {list(shape)}"
        raise ValueError(f"{name}: need contiguous {dtype}{want} on {dev}")


def _raise_on(rc: int, what: str, detail: str) -> None:
    if rc != 0:
        why = ("the plan does not match the kernel" if rc == -1
               else f"CUDA error {rc}")
        raise RuntimeError(f"{what} kernel launch failed: {why} ({detail})")


def offset_scan_cuda(cons_win, heads, m: int, wc: int, P: int, M: int,
                     num_symbols: int):
    """Launch ``csrc/offset_scan.cu``: a group of lanes (one thread for
    ``m <= 64``) per (head, window position), the column's bit vectors in
    registers up to ``m = 2048`` and in shared memory beyond
    (:func:`plan_offset_scan`).  Same contract and output as
    :func:`offset_scan_plain` for an alphabet of ``num_symbols`` dense
    ids, the wildcard among them: its match table has a row for each id
    below 256, so a wider alphabet is refused.  Raises on anything the
    kernel does not take and when the launch is refused, never falls
    back.  Each launch adds one to ``offset_scan_cuda.launches``."""
    if not 0 <= num_symbols < PEQ_ROWS:
        raise ValueError(f"offset_scan_cuda: an alphabet of {num_symbols} "
                         f"symbols; the kernel takes up to {PEQ_ROWS - 1}")
    dev = heads.device
    if dev.type != "cuda":
        raise ValueError("offset_scan_cuda needs tensors on a CUDA device")
    B = heads.shape[0]
    _need(cons_win, torch.int32, dev, "cons_win", (P + 2 * M,))
    _need(heads, torch.int32, dev, "heads", (B, M))
    plan = plan_offset_scan(B, P, M, m)
    out = torch.empty((B, P), dtype=torch.int32, device=dev)
    table = (torch.empty((plan.blocks, PEQ_ROWS, plan.nwp),
                         dtype=torch.int64, device=dev)
             if plan.table == "global" else None)
    launch = _bind("offset_scan_launch", [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 10
                   + [ctypes.c_longlong, ctypes.c_void_p])
    rc = launch(_ptr(cons_win), _ptr(heads), _ptr(out), _ptr(table), B, P,
                M, m, wc, num_symbols, plan.group, plan.nwp, plan.threads,
                plan.blocks, plan.smem_bytes, cuda_build.stream_ptr(dev))
    _raise_on(rc, "offset_scan", f"B={B}, P={P}, M={M}, {plan}")
    offset_scan_cuda.launches += 1
    offset_scan_cuda.last_plan = plan
    return out


offset_scan_cuda.launches = 0
offset_scan_cuda.last_plan = None

_REPLAY_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 15
                + [ctypes.c_longlong, ctypes.c_void_p])


def _launch_col_replay(mode: int, st, outs, flag, reads, rlen, slot, read,
                       offset, wc, et, plan):
    """One ``col_replay_launch``: ``mode`` 0 replays every row of ``st``
    into ``outs``, 1 catches row ``(slot, read)`` up in ``st`` itself;
    a ``"global"`` plan gets its columns' device-memory scratch here.
    Counted in ``replay_rows_cuda.launches`` (and, for mode 1, in
    ``replay_rows_cuda.activate_launches``)."""
    B, R, W = outs[0].shape if mode == 0 else st["D"].shape
    C = st["cons"].shape[1]
    scratch = (None if plan.cells else torch.empty(
        (2 if mode else B * R, W), dtype=torch.int32, device=reads.device))
    launch = _bind("col_replay_launch", _REPLAY_ARGS)
    targets = (st["D"], st["e"], st["rmin"], st["er"]) if mode else (None,) * 4
    rc = launch(
        mode, *map(_ptr, targets), _ptr(st["off"]), _ptr(st["act"]),
        _ptr(st["cons"]), _ptr(st["clen"]), _ptr(reads), _ptr(rlen),
        *map(_ptr, outs if outs else (None,) * 4), _ptr(flag), _ptr(scratch),
        B, R, W, C, reads.shape[1], slot, read, offset, wc, int(et),
        plan.cells, plan.row_warps, plan.ctas, plan.warps,
        plan.blocks, plan.smem_bytes,
        cuda_build.stream_ptr(reads.device),
    )
    _raise_on(rc, "col_replay", f"mode={mode}, B={B}, R={R}, W={W}, {plan}")
    replay_rows_cuda.launches += 1
    replay_rows_cuda.activate_launches += mode
    replay_rows_cuda.last_plan = plan


def _check_store(st, reads, rlen, dev, with_band: bool):
    B, R = st["off"].shape
    for name in ("off", "clen", "cons") + (("D", "e", "rmin", "er")
                                           if with_band else ()):
        _need(st[name], torch.int32, dev, name)
    _need(st["act"], torch.bool, dev, "act", (B, R))
    if st["clen"].shape != (B,) or st["cons"].shape[0] != B:
        raise ValueError("clen/cons: need [B] and [B, C]")
    _need(reads, torch.int16, dev, "reads")
    _need(rlen, torch.int32, dev, "rlen", (R,))
    if reads.shape[0] != R:
        raise ValueError("reads: need [R, L]")


def replay_rows_cuda(off, act, cons, clen, reads, rlen, wc: int, et: bool,
                     E: int, W: int):
    """Launch ``csrc/col_replay.cu`` over every ``(slot, read)`` row into
    fresh ``[B, R, W]`` tensors, each row's cells in registers of a warp,
    a CTA or a cluster (:func:`plan_replay`).  Same contract and outputs
    as :func:`replay_rows_plain`; raises on anything the kernel does not
    take, never falls back."""
    dev = off.device
    if dev.type != "cuda":
        raise ValueError("replay_rows_cuda needs tensors on a CUDA device")
    st = dict(off=off, act=act, cons=cons, clen=clen)
    _check_store(st, reads, rlen, dev, with_band=False)
    if W != 2 * E + 2:
        raise ValueError(f"W={W} is not 2E+2 for E={E}")
    B, R = off.shape
    plan = plan_replay(B * R, W)
    D = torch.empty((B, R, W), dtype=torch.int32, device=dev)
    e, rmin, er = (torch.empty((B, R), dtype=torch.int32, device=dev)
                   for _ in range(3))
    _launch_col_replay(0, st, (D, e, rmin, er), None, reads, rlen, 0, 0, 0,
                       wc, et, plan)
    return D, e, rmin, er


replay_rows_cuda.launches = 0
replay_rows_cuda.activate_launches = 0
replay_rows_cuda.last_plan = None


def activate_row_cuda(state, slot: int, read: int, offset: int, reads, rlen,
                      wc: int, et: bool) -> bool:
    """Launch ``csrc/col_replay.cu`` on row ``(slot, read)`` of the branch
    store: the row is restarted at ``offset``, caught up over the slot's
    consensus on the device and committed in place unless it overflows
    the band.  Same contract as :func:`activate_row_plain`; the
    host reads one overflow word."""
    dev = state["D"].device
    if dev.type != "cuda":
        raise ValueError("activate_row_cuda needs tensors on a CUDA device")
    _check_store(state, reads, rlen, dev, with_band=True)
    B, R, W = state["D"].shape
    if not (0 <= slot < B and 0 <= read < R and offset >= 0):
        raise ValueError(f"row ({slot}, {read}) at {offset} out of range")
    flag = torch.empty(1, dtype=torch.int32, device=dev)
    _launch_col_replay(1, state, None, flag, reads, rlen, slot, read, offset,
                       wc, et, plan_replay(1, W))
    return bool(flag.item())


# ---------------------------------------------------------------------
# dispatch


def _kind(t) -> str:
    """``"cuda"`` (launch the kernel) or ``"cpu"`` (the twin); any other
    device raises, and so does an armed ``pallas_compile`` fault."""
    faults.check_kernel("replay")
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no replay kernel for device type {kind!r}")
    return kind


def offset_scan(cons_win, heads, m: int, wc: int, P: int, M: int,
                num_symbols: int):
    """Dispatch rule: CPU tensors take :func:`offset_scan_plain`, CUDA
    tensors launch :func:`offset_scan_cuda` (for an alphabet of
    ``num_symbols`` ids)."""
    if _kind(heads) == "cuda":
        return offset_scan_cuda(cons_win, heads, m, wc, P, M, num_symbols)
    return offset_scan_plain(cons_win, heads, m, wc, P, M)


def replay_rows(off, act, cons, clen, reads, rlen, wc: int, et: bool,
                E: int, W: int):
    """Dispatch rule: CPU tensors take :func:`replay_rows_plain`, CUDA
    tensors launch :func:`replay_rows_cuda`."""
    fn = replay_rows_cuda if _kind(off) == "cuda" else replay_rows_plain
    return fn(off, act, cons, clen, reads, rlen, wc, et, E, W)


def activate_row(state, slot: int, read: int, offset: int, reads, rlen,
                 wc: int, et: bool) -> bool:
    """Dispatch rule: CPU tensors take :func:`activate_row_plain`, CUDA
    tensors launch :func:`activate_row_cuda`."""
    fn = (activate_row_cuda if _kind(state["D"]) == "cuda"
          else activate_row_plain)
    return fn(state, slot, read, offset, reads, rlen, wc, et)
