"""Late reads and band growth behind ``TorchScorer``: the activation-offset
scan and the column replay.

Two kernels, each in the style of :mod:`~waffle_con_tpu_torch.ops.run_kernel`:

* the offset scan (``csrc/offset_scan.cu``), which scores every window
  position of a late read's start in one launch — ``waffle_con_tpu``'s
  ``_j_offset_scan`` (``ops/jax_scorer.py``).  Plain twin:
  :func:`~waffle_con_tpu_torch.ops.torch_scorer.offset_scan`.
* the column replay (``csrc/col_replay.cu``), which rebuilds band rows
  from their anchors by replaying each slot's consensus, one warp per
  ``(slot, read)`` row.  It serves band growth (every row into fresh
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

#: shared memory a CTA may use on an H100 (227 KB, the opt-in maximum)
SMEM_LIMIT = 232448
#: warps (rows, or window positions) of a CTA
MAX_WARPS = 8
#: cells per lane of the offset scan's register column, one kernel
#: instance each: ceil((m + 1) / 32) for compare lengths m < 1,056; longer
#: heads keep the column in memory (plan ``cells`` 0)
SCAN_CELLS = (1, 2, 3, 5, 9, 17, 33)


class ScanPlan(NamedTuple):
    """Launch geometry of one offset scan."""

    #: warps of a CTA, one window position each
    warps: int
    #: CTAs: ``B * P / warps``
    blocks: int
    #: cells of the ``m + 1``-cell column each lane holds in registers,
    #: or 0: the column in shared memory, or in a ``[B * P, m + 1]``
    #: device-memory scratch when ``smem_bytes`` is 0
    cells: int
    #: dynamic shared memory of a CTA (its window segment, its head and,
    #: for ``cells`` 0, one column a warp), bytes; 0 (with ``cells`` 0)
    #: for all of them in device memory
    smem_bytes: int

    @property
    def column(self) -> str:
        """Where the columns live: registers, smem or global."""
        if self.cells:
            return "registers"
        return "smem" if self.smem_bytes else "global"


def plan_offset_scan(B: int, P: int, M: int, m: int) -> ScanPlan:
    """The offset scan's launch geometry for ``B`` heads, ``P`` window
    positions, heads of ``M`` symbols (``P`` and ``M`` powers of two) and
    the compare length ``m``: the column's ``m + 1`` cells in registers
    up to ``m = 1055``, else in shared memory, with the window segment
    and the head in shared memory too and the most warps, up to 8,
    whose shared memory fits a CTA; all of it in device memory when not
    even one warp's does.  Raises ``ValueError`` on any other shape."""
    pow2 = lambda n: n >= 1 and n & (n - 1) == 0  # noqa: E731
    if B < 1 or not pow2(P) or not pow2(M) or not 0 <= m <= M:
        raise ValueError(
            f"no offset-scan plan for B={B}, P={P}, M={M}, m={m}")
    need = -(-(m + 1) // 32)
    cells = next((c for c in SCAN_CELLS if c >= need), 0)
    warps = min(MAX_WARPS, P)
    while warps:
        smem = 4 * (warps - 1 + 3 * M + (0 if cells else warps * (m + 1)))
        if smem <= SMEM_LIMIT:
            return ScanPlan(warps, B * (P // warps), cells, smem)
        warps //= 2
    warps = min(MAX_WARPS, P)
    return ScanPlan(warps, B * (P // warps), 0, 0)


class ReplayPlan(NamedTuple):
    """Launch geometry of one column-replay launch."""

    #: warps of a CTA, one row each
    warps: int
    #: CTAs: ``ceil(rows / warps)``
    blocks: int
    #: dynamic shared memory of a CTA (two band columns a warp), bytes;
    #: 0 for the columns in device memory
    smem_bytes: int
    #: where the columns live: ``"smem"`` or ``"global"``
    band: str


def plan_replay(rows: int, W: int) -> ReplayPlan:
    """The column replay's launch geometry for ``rows`` rows of ``W``
    band cells: up to 8 warps a CTA, as many as hold both columns of
    their rows in shared memory, or 8 warps with the columns in device
    memory when one row's two columns exceed a CTA's shared memory
    (``W > 29056``).  Raises ``ValueError`` on an empty launch or an odd
    or too narrow band."""
    per = 8 * W
    if rows < 1 or W < 4 or W % 2:
        raise ValueError(f"no replay plan for rows={rows}, W={W}")
    if per > SMEM_LIMIT:
        warps = min(MAX_WARPS, rows)
        return ReplayPlan(warps, -(-rows // warps), 0, "global")
    warps = max(1, min(MAX_WARPS, SMEM_LIMIT // per, rows))
    return ReplayPlan(warps, -(-rows // warps), warps * per, "smem")


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


def offset_scan_cuda(cons_win, heads, m: int, wc: int, P: int, M: int):
    """Launch ``csrc/offset_scan.cu``: one warp per (head, window
    position), the column in registers (in shared memory for compare
    lengths of 1,056 and more, in device memory where shared memory does
    not hold the window and the head).  Same contract and output as
    :func:`offset_scan_plain`; raises on anything the kernel does not
    take and when the launch is refused, never falls back.  Each launch
    adds one to ``offset_scan_cuda.launches``."""
    dev = heads.device
    if dev.type != "cuda":
        raise ValueError("offset_scan_cuda needs tensors on a CUDA device")
    B = heads.shape[0]
    _need(cons_win, torch.int32, dev, "cons_win", (P + 2 * M,))
    _need(heads, torch.int32, dev, "heads", (B, M))
    plan = plan_offset_scan(B, P, M, m)
    out = torch.empty((B, P), dtype=torch.int32, device=dev)
    scratch = (torch.empty((B * P, m + 1), dtype=torch.int32, device=dev)
               if plan.column == "global" else None)
    launch = _bind("offset_scan_launch", [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 8 + [ctypes.c_longlong, ctypes.c_void_p])
    rc = launch(_ptr(cons_win), _ptr(heads), _ptr(out), _ptr(scratch), B, P,
                M, m, wc, plan.warps, plan.blocks, plan.cells,
                plan.smem_bytes, cuda_build.stream_ptr(dev))
    _raise_on(rc, "offset_scan", f"B={B}, P={P}, M={M}, {plan}")
    offset_scan_cuda.launches += 1
    offset_scan_cuda.last_plan = plan
    return out


offset_scan_cuda.launches = 0
offset_scan_cuda.last_plan = None

_REPLAY_ARGS = ([ctypes.c_int] + [ctypes.c_void_p] * 16 + [ctypes.c_int] * 12
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
    scratch = (None if plan.smem_bytes else torch.empty(
        (2 if mode else B * R, W), dtype=torch.int32, device=reads.device))
    launch = _bind("col_replay_launch", _REPLAY_ARGS)
    targets = (st["D"], st["e"], st["rmin"], st["er"]) if mode else (None,) * 4
    rc = launch(
        mode, *map(_ptr, targets), _ptr(st["off"]), _ptr(st["act"]),
        _ptr(st["cons"]), _ptr(st["clen"]), _ptr(reads), _ptr(rlen),
        *map(_ptr, outs if outs else (None,) * 4), _ptr(flag), _ptr(scratch),
        B, R, W, C, reads.shape[1], slot, read, offset, wc, int(et),
        plan.warps, plan.blocks, plan.smem_bytes,
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
    fresh ``[B, R, W]`` tensors: one warp per row, its two columns in
    shared memory (in device memory for ``W > 29056``).  Same contract and
    outputs as :func:`replay_rows_plain`; raises on anything the kernel
    does not take, never falls back."""
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
    store: one warp restarts it at ``offset``, catches it up over the
    slot's consensus on the device and commits it in place unless it
    overflows the band.  Same contract as :func:`activate_row_plain`; the
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
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no replay kernel for device type {kind!r}")
    return kind


def offset_scan(cons_win, heads, m: int, wc: int, P: int, M: int):
    """Dispatch rule: CPU tensors take :func:`offset_scan_plain`, CUDA
    tensors launch :func:`offset_scan_cuda`."""
    if _kind(heads) == "cuda":
        return offset_scan_cuda(cons_win, heads, m, wc, P, M)
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
