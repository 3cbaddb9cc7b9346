"""The branch store's life-cycle calls behind ``TorchScorer``: root, copy,
advance, stats, finalize and deactivate.

``waffle_con_tpu``'s ``JaxScorer`` runs them as seven jitted XLA
functions (``ops/jax_scorer.py``): ``_j_root``, ``_j_clone_batch``,
``_j_deactivate_batch``, ``_j_push_batch``, ``_j_clone_push_batch``,
``_j_stats`` and ``_j_finalize``.  Here they are one hand-written CUDA
source, ``csrc/branch_step.cu``, in the style of
:mod:`~waffle_con_tpu_torch.ops.replay_kernel`:

* plain twins built from ``torch_scorer``'s column primitives
  (:func:`root_plain`, :func:`advance_plain`, :func:`stats_plain`,
  :func:`finalize_plain`, :func:`deactivate_plain`), each counted in its
  ``.calls``;
* :func:`plan_branch`, the launch plan of a call, picked before the
  launch from the shape and the card's occupancy: ``one_launch`` (one
  launch a batch, each band row in registers, a grid barrier before the
  commit) where the band fits a warp's registers and every warp of the
  batch is resident, else ``slab`` (the band in device memory, a commit
  launch), which takes every shape the store can hold;
* :class:`BranchBuffers`, a store's persistent device and pinned host
  buffers (the rows, the packed output, the scratch), its checked
  geometry and its call record, grown as needed (a call given none uses
  the module's own);
* the CUDA wrappers (``*_cuda``), every launch through
  :func:`branch_cuda`, counted in ``branch_cuda.launches`` (kernels
  launched) and in ``branch_cuda.entries`` (by call and by plan);
* the dispatch (:func:`root`, :func:`advance`, :func:`stats`,
  :func:`finalize`, :func:`deactivate`): tensors on the CPU take the twin,
  tensors on a CUDA device launch the kernel or raise;
* the fused calls of a read-sharded store (:func:`root_shards`,
  :func:`advance_shards`, :func:`stats_shards`, :func:`finalize_shards`):
  up to :data:`MAX_SHARDS` shards of one geometry on one card in one
  call, their warps one grid, one overflow word for all of them (the
  step is all or nothing across the shards inside the kernel), the
  output over their reads in shard order; the twins
  (:func:`advance_shards_plain`, ...) are each shard's twin under the
  same rule.

An advance takes rows ``(src, dst, sym)``: ``sym == -1`` copies slot
``src`` into ``dst`` (``_j_clone_batch``), ``src == dst`` pushes in place
(``_j_push_batch``), anything else clones and pushes
(``_j_clone_push_batch``).  Every src row is read before any dst row is
written, and the batch commits nothing when any pushed read's edit
distance reaches the band (``e >= E``): the caller grows the band and
retries.  Results come back to the host as :class:`BranchOut` numpy
arrays.  On ``cuda`` the packed output lands in the store's pinned
buffer (written there by the one-launch kernel, or in one copy from the
slab plan's device output), and the arrays are views of it, valid until
the next call on those buffers (``TorchScorer`` converts them at once).
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import NamedTuple, Optional

import numpy as np
import torch

from waffle_con_tpu_torch.ops import replay_kernel as rpk
from waffle_con_tpu_torch.ops import torch_scorer as ts
from waffle_con_tpu_torch.runtime import faults

#: cells a lane of the one-launch kernel holds, by kernel instance (a
#: band takes the smallest with ``32 * cells >= W``)
CELLS = (1, 2, 3, 5, 9, 17)
#: warps of a CTA of the one-launch kernel, one (row, read) each
ONE_WARPS = 16
#: most shared memory of a one-launch CTA (its warps' band rows and
#: histogram rows; past 48 KB with the kernel's opt-in)
ONE_SMEM_MAX = 232448
#: warps of a CTA of the slab plan's rows launch and of root
ROW_WARPS = 8
#: threads of a CTA of the commit and deactivate launches
COPY_THREADS = 256
#: most CTAs of the commit on one (row, read) pair
COMMIT_CTAS = 264
#: most pairs of the commit's grid (its y dimension); pairs past it loop
COMMIT_ROWS = 65535
#: the first call's epoch: a flag of the packed output is set when it
#: holds its call's epoch, which is above every other output value (at
#: most ``torch_scorer.INF``), so no launch clears the flags
EPOCH0 = 2 * ts.INF
#: the plans' names, as ``branch_cuda.entries`` counts them
PLANS = ("one_launch", "slab")
#: read shards of one fused call at most (``csrc/branch_step.cu``'s
#: ``kMaxShards``: the shards' stores ride in the launch's parameter)
MAX_SHARDS = 16


class BranchOut(NamedTuple):
    """Stats of a batch of ``n`` rows over ``R`` reads and ``A`` symbols,
    each at its row's length after the call (the twin of ``_j_push_batch``'s
    ``stats`` and ``overflow``)."""

    #: ``[n, R]`` int32 edit distance (0 on inactive reads)
    eds: np.ndarray
    #: ``[n, R, A]`` int32 tip votes (``None`` without the histogram)
    occ: Optional[np.ndarray]
    #: ``[n, R]`` int32 tips a read (``None`` without the histogram)
    split: Optional[np.ndarray]
    #: ``[n, R]`` bool: the read's wavefront touched its end
    reached: np.ndarray
    #: ``[n, R]`` int32 finalized distances (``max(e, rmin)``, capped)
    fin: np.ndarray
    #: ``[n]`` bool: every active read's finalized distance is in the band
    fin_ok: np.ndarray
    #: whether any pushed read overflowed the band (nothing committed)
    overflow: bool


class BranchPlan(NamedTuple):
    """Launch plan of one call of ``csrc/branch_step.cu``."""

    #: ``"one_launch"`` or ``"slab"``
    name: str
    #: the call writes the store back (an advance or a copy; False for
    #: stats and finalize): on one_launch a cooperative launch, its grid
    #: barrier before the commit
    commit: bool
    #: band cells a lane holds (one_launch; 0 on the slab plan)
    cells: int
    #: warps of a CTA, one (row, read) each, and CTAs
    warps: int
    blocks: int
    #: bytes of shared memory a CTA (one_launch's band and histogram
    #: rows, :func:`one_launch_smem`)
    smem: int
    #: CTAs of the slab plan's commit on one pair, and pairs of its grid
    #: (0: no commit launch)
    commit_blocks: int
    commit_rows: int
    #: words of the packed output without and with the ``occ`` plane
    head_words: int
    out_words: int

    @property
    def kernels(self) -> int:
        """Kernels a call on this plan launches."""
        return 2 if self.commit_rows else 1


def one_launch_cells(W: int) -> int:
    """Cells a lane of the one-launch kernel holds for a band of ``W``
    cells (0: wider than a warp's registers take)."""
    return next((c for c in CELLS if 32 * c >= W), 0)


def one_launch_smem(cells: int, A: int) -> int:
    """Bytes of shared memory of a one-launch CTA: each warp's band row
    (``32 * cells`` words) and histogram row (``A`` words)."""
    return 4 * ONE_WARPS * (32 * cells + A)


def plan_branch(n: int, R: int, W: int, A: int, sms: int, per_sm: int,
                commit: bool = True) -> BranchPlan:
    """The launch plan of a call on ``n`` rows of ``R`` reads, ``W`` band
    cells and ``A`` histogram symbols (1 without the histogram), on a card
    of ``sms`` SMs that hold ``per_sm`` one-launch CTAs each at once
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``); ``commit`` False
    for stats and finalize, which write nothing back.

    ``one_launch`` where the band fits a warp's registers (``W <= 32 *
    CELLS[-1]`` = 544) and a CTA's band and histogram rows fit
    ``ONE_SMEM_MAX``: a warp a (row, read), ``ONE_WARPS`` a CTA; an
    advance or a copy takes it only when every CTA is resident (``sms *
    per_sm``), as its grid barrier needs.  Anything else takes ``slab``,
    which takes every shape the store can hold.  Raises ``ValueError``
    only on an empty batch or a band that is not ``2E + 2`` cells."""
    if n < 1 or R < 1 or A < 1 or W < 4 or W % 2:
        raise ValueError(f"no branch plan for n={n}, R={R}, W={W}, A={A}")
    nR = n * R
    head = 4 * nR + n + 1
    out = head + nR * A
    cells = one_launch_cells(W)
    smem = one_launch_smem(cells, A)
    blocks = -(-nR // ONE_WARPS)
    if (cells and smem <= ONE_SMEM_MAX
            and (not commit or blocks <= sms * per_sm)):
        return BranchPlan("one_launch", commit, cells, ONE_WARPS, blocks,
                          smem, 0, 0, head, out)
    copy_ctas = max(1, min(COMMIT_CTAS, -(-W // (4 * COPY_THREADS))))
    return BranchPlan(
        "slab", commit, 0, ROW_WARPS, -(-nR // ROW_WARPS), 0,
        copy_ctas if commit else 0, min(nR, COMMIT_ROWS) if commit else 0,
        head, out)


def slab_words(n: int, R: int, W: int, C: int, shards: int = 1) -> int:
    """int32 words of the slab plan's scratch for an advance of ``R``
    reads (over ``shards`` shards): the new band, the five per-read
    fields (``e``, ``rmin``, ``er``, ``off``, ``act``), and the consensus
    and the length of every row of every shard."""
    return n * R * W + 5 * n * R + shards * (n * C + n)


def scratch_words(plan: BranchPlan, n: int, R: int, W: int, C: int,
                  shards: int = 1) -> int:
    """int32 words of a call's scratch: the slab plan's advance slab, or
    the one-launch plan's staged consensus rows of its copies (``[shards,
    n, C]``); none for stats and finalize."""
    if plan.name == "slab":
        return slab_words(n, R, W, C, shards) if plan.commit_rows else 0
    return shards * n * C if plan.commit else 0


def unpack(host: np.ndarray, n: int, R: int, A: int, votes: bool,
           epoch: int) -> BranchOut:
    """A packed output (``csrc/branch_step.cu``'s layout: ``eds``,
    ``split``, ``reached``, ``fin`` ``[n, R]`` each, the rows' ``fin``
    overflow flags ``[n]``, the batch's overflow word, then ``occ [n, R,
    A]``) as a :class:`BranchOut` of views of ``host``; a flag is set
    when it holds the call's ``epoch``."""
    nR = n * R
    field = lambda i: host[i * nR:(i + 1) * nR].reshape(n, R)  # noqa: E731
    flags = host[4 * nR:4 * nR + n + 1]
    occ = host[4 * nR + n + 1:4 * nR + n + 1 + nR * A]
    return BranchOut(
        eds=field(0), occ=occ.reshape(n, R, A) if votes else None,
        split=field(1) if votes else None, reached=field(2) != 0,
        fin=field(3), fin_ok=flags[:n] != epoch,
        overflow=bool(flags[n] == epoch),
    )


def _rows_np(rows) -> np.ndarray:
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    if rows.ndim != 2 or rows.shape[0] != 3 or rows.shape[1] < 1:
        raise ValueError(f"rows: need [3, n] (src, dst, sym), not "
                         f"{rows.shape}")
    return rows


def _check_rows(state, rows: np.ndarray, pushes: bool) -> None:
    """Slots inside the store, distinct destinations, and (``pushes``
    False) copy-only rows."""
    B = state["D"].shape[0]
    if rows[:2].min() < 0 or rows[:2].max() >= B:
        raise ValueError(f"rows: slots outside [0, {B})")
    if rows.shape[1] > 1:
        dst = np.sort(rows[1])
        if (dst[1:] == dst[:-1]).any():
            raise ValueError("rows: duplicate destination slots")
    if not pushes and (rows[2] >= 0).any():
        raise ValueError("rows: a copy without stats cannot push")


# ---------------------------------------------------------------------
# plain twins (tensors on the CPU)


def _geometry(state):
    W = state["D"].shape[2]
    return W, (W - 2) // 2


def _host_out(stats, fin, fin_ovf, overflow: bool) -> BranchOut:
    eds, occ, split, reached = (x.cpu().numpy() for x in stats)
    return BranchOut(eds, occ, split, reached, fin.cpu().numpy(),
                     ~fin_ovf.cpu().numpy(), overflow)


def root_plain(state, slot: int, act, rlen) -> None:
    """Root slot ``slot``: ``init_col`` at offset 0 for the reads active
    in ``act`` (``[R]`` bool), consensus length 0 (``_j_root``'s state;
    its stats are :func:`stats_plain`'s)."""
    root_plain.calls += 1
    W, E = _geometry(state)
    off = torch.zeros_like(state["off"][slot])
    D, e, rmin, er = ts.init_col(off, act, rlen, E, W)
    for name, val in (("D", D), ("e", e), ("rmin", rmin), ("er", er),
                      ("off", off), ("act", act)):
        state[name][slot] = val
    state["clen"][slot] = 0


root_plain.calls = 0


def _advance_parts(st, rows: np.ndarray, reads, rlen, wc: int, et: bool,
                   num_symbols: int, with_stats: bool):
    """One store's advance computed and not written: ``(out, overflow,
    commit)``, ``commit()`` writing the rows into their dst slots."""
    dev = st["D"].device
    W, E = _geometry(st)
    C = st["cons"].shape[1]
    r = torch.from_numpy(rows).to(dev)
    si, di, sym = r[0].long(), r[1].long(), r[2]
    push = sym >= 0
    D, e, rmin, er = st["D"][si], st["e"][si], st["rmin"][si], st["er"][si]
    off, act, cons, clen = (st["off"][si], st["act"][si], st["cons"][si],
                            st["clen"][si])
    Dn, en, rminn, ern = ts.col_step(
        D, e, rmin, er, off, act, rlen,
        ts.gather_window(reads, clen, off, E, W), clen + 1,
        sym.clamp(min=0), wc, et, E,
    )
    sel = lambda new, old: torch.where(  # noqa: E731
        push.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)
    Dn, en, rminn, ern = sel(Dn, D), sel(en, e), sel(rminn, rmin), sel(ern, er)
    overflow = bool((push & (act & (en >= E)).any(-1)).any())
    clenn = torch.where(push, clen + 1, clen)
    out = None
    if with_stats:
        stats = ts.stats_core(
            Dn, en, rminn, ern, off, act, rlen,
            ts.gather_window(reads, clenn, off, E, W), clenn, num_symbols, E,
        )
        fin, fin_ovf = ts.finalized(en, rminn, act, E)
        out = _host_out(stats, fin, fin_ovf, overflow)

    def commit():
        at = torch.arange(rows.shape[1], device=dev)
        cpos = clen.clamp(0, C - 1).long()
        cons_n = cons.clone()
        cons_n[at, cpos] = torch.where(push, sym, cons[at, cpos])
        for name, val in (("D", Dn), ("e", en), ("rmin", rminn), ("er", ern),
                          ("off", off), ("act", act), ("cons", cons_n),
                          ("clen", clenn)):
            st[name][di] = val

    return out, overflow, commit


def advance_plain(state, rows, reads, rlen, wc: int, et: bool,
                  num_symbols: int, with_stats: bool = True,
                  force: bool = False):
    """Rows ``(src, dst, sym)`` (``[3, n]``): slot ``src`` advanced by
    ``sym`` (``-1``: copied as it is) into slot ``dst``, every src read
    before any dst written, nothing committed when a pushed read reaches
    the band (unless ``force``: the sharded column step commits whatever
    the overflow says).  Returns the :class:`BranchOut` of the rows at
    their new lengths (``_j_clone_push_batch``'s stats and overflow), or
    ``None`` without ``with_stats`` (a batch of copies,
    ``_j_clone_batch``)."""
    advance_plain.calls += 1
    rows = _rows_np(rows)
    _check_rows(state, rows, with_stats)
    out, overflow, commit = _advance_parts(state, rows, reads, rlen, wc, et,
                                           num_symbols, with_stats)
    if force or not overflow:
        commit()
    return out


advance_plain.calls = 0


def _stats_out(state, slots, reads, rlen, num_symbols: int) -> BranchOut:
    W, E = _geometry(state)
    si = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                         device=state["D"].device)
    D, e, rmin, er, off, act, clen = (
        state[k][si] for k in ("D", "e", "rmin", "er", "off", "act", "clen"))
    stats = ts.stats_core(D, e, rmin, er, off, act, rlen,
                          ts.gather_window(reads, clen, off, E, W), clen,
                          num_symbols, E)
    fin, fin_ovf = ts.finalized(e, rmin, act, E)
    return _host_out(stats, fin, fin_ovf, False)


def stats_plain(state, slots, reads, rlen, num_symbols: int) -> BranchOut:
    """The :class:`BranchOut` of each slot in ``slots`` as it stands
    (``_j_stats``, with the finalized distances bundled); writes
    nothing."""
    stats_plain.calls += 1
    return _stats_out(state, slots, reads, rlen, num_symbols)


stats_plain.calls = 0


def _finalized(state, slots):
    _W, E = _geometry(state)
    si = torch.as_tensor(np.asarray(slots, dtype=np.int64),
                         device=state["D"].device)
    fin, ovf = ts.finalized(state["e"][si], state["rmin"][si],
                            state["act"][si], E)
    return fin.cpu().numpy(), ovf.cpu().numpy()


def finalize_plain(state, slots):
    """``(fin [n, R], ovf [n])`` of each slot in ``slots``: the finalized
    distances and whether any active read's is outside the band
    (``_j_finalize``)."""
    finalize_plain.calls += 1
    return _finalized(state, slots)


finalize_plain.calls = 0


def deactivate_plain(state, pairs) -> None:
    """Clear ``act`` at every ``(slot, read)`` of ``pairs`` (``[2, m]``,
    ``_j_deactivate_batch``)."""
    deactivate_plain.calls += 1
    p = torch.as_tensor(np.asarray(pairs, dtype=np.int64),
                        device=state["act"].device)
    state["act"][p[0], p[1]] = False


deactivate_plain.calls = 0


def merge_outs(outs) -> BranchOut:
    """Several stores' outputs of one call as one, per-read fields in
    read order (store after store), ``fin_ok`` AND-ed, ``overflow``
    OR-ed."""
    if len(outs) == 1:
        return outs[0]
    cat = lambda xs: np.concatenate(xs, axis=1)  # noqa: E731
    votes = outs[0].occ is not None
    return BranchOut(
        eds=cat([o.eds for o in outs]),
        occ=cat([o.occ for o in outs]) if votes else None,
        split=cat([o.split for o in outs]) if votes else None,
        reached=cat([o.reached for o in outs]),
        fin=cat([o.fin for o in outs]),
        fin_ok=np.logical_and.reduce([o.fin_ok for o in outs]),
        overflow=any(o.overflow for o in outs),
    )


def _check_shards(states) -> None:
    if not states:
        raise ValueError("a fused call needs at least one shard")
    D0, c0 = states[0]["D"], states[0]["cons"]
    for st in states[1:]:
        if (st["D"].shape != D0.shape or st["cons"].shape != c0.shape
                or st["D"].device != D0.device):
            raise ValueError("the shards of a fused call need one device "
                             "and one geometry")


def root_shards_plain(states, slot: int, act, rlens) -> None:
    """:func:`root_plain` on every shard: ``act`` is the ``[S x R]`` mask
    of the shards' reads in shard order."""
    root_shards_plain.calls += 1
    _check_shards(states)
    act = torch.as_tensor(np.asarray(act, dtype=bool).reshape(len(states),
                                                              -1))
    for st, a, rl in zip(states, act, rlens):
        W, E = _geometry(st)
        off = torch.zeros_like(st["off"][slot])
        a = a.to(st["act"].device)
        D, e, rmin, er = ts.init_col(off, a, rl, E, W)
        for name, val in (("D", D), ("e", e), ("rmin", rmin), ("er", er),
                          ("off", off), ("act", a)):
            st[name][slot] = val
        st["clen"][slot] = 0


root_shards_plain.calls = 0


def advance_shards_plain(states, rows, reads, rlens, wc: int, et: bool,
                         num_symbols: int, with_stats: bool = True,
                         force: bool = False):
    """The fused step's twin: every shard's :func:`advance_plain` on the
    same rows, under the all-or-nothing rule (no shard commits when a
    pushed read of any shard reaches the band, unless ``force``); the
    shards' outputs merged in read order (:func:`merge_outs`), or
    ``None`` without ``with_stats``."""
    advance_shards_plain.calls += 1
    _check_shards(states)
    rows = _rows_np(rows)
    parts = []
    for st, rd, rl in zip(states, reads, rlens):
        _check_rows(st, rows, with_stats)
        parts.append(_advance_parts(st, rows, rd, rl, wc, et, num_symbols,
                                    with_stats))
    overflow = any(ovf for _o, ovf, _c in parts)
    if force or not overflow:
        for _o, _ovf, commit in parts:
            commit()
    if not with_stats:
        return None
    return merge_outs([o for o, _ovf, _c in parts])


advance_shards_plain.calls = 0


def stats_shards_plain(states, slots, reads, rlens,
                       num_symbols: int) -> BranchOut:
    """Every shard's :func:`stats_plain`, merged in read order."""
    stats_shards_plain.calls += 1
    _check_shards(states)
    return merge_outs([_stats_out(st, slots, rd, rl, num_symbols)
                       for st, rd, rl in zip(states, reads, rlens)])


stats_shards_plain.calls = 0


def finalize_shards_plain(states, slots):
    """Every shard's :func:`finalize_plain`: ``fin`` in read order,
    ``ovf`` OR-ed over the shards."""
    finalize_shards_plain.calls += 1
    _check_shards(states)
    res = [_finalized(st, slots) for st in states]
    return (np.concatenate([f for f, _o in res], axis=1),
            np.logical_or.reduce([o for _f, o in res]))


finalize_shards_plain.calls = 0


def plain_calls() -> int:
    """Calls of every twin of this module since their counts were last
    zeroed."""
    return sum(fn.calls for fn in TWINS)


# ---------------------------------------------------------------------
# CUDA kernels: bind, launch (the build lives in ops/cuda_build.py, the
# binding helpers in ops/replay_kernel.py)

_PTR, _INT = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = {
    "rows": [_PTR],
    "root": [_PTR] * 11 + [_INT] * 6 + [_PTR],
    "root_shards": [_PTR, _INT] + [_PTR] * 3 + [_INT] * 6 + [_PTR],
    "deactivate": [_PTR] * 4 + [_INT] * 4 + [_PTR],
}

#: a store's tensors, in the order of ``csrc/branch_step.cu``'s records
_STORE = ("D", "e", "rmin", "er", "off", "act", "cons", "clen")


class _Call(ctypes.Structure):
    """One call of ``branch_rows_launch``: ``csrc/branch_step.cu``'s
    ``BranchCall``, field for field."""

    _fields_ = [(name, _PTR) for name in (
        "D", "e", "rmin", "er", "off", "act", "cons", "clen", "reads",
        "rlen", "rows", "rows_host", "out", "out_host", "flag", "slab",
        "event", "stream", "part", "shard_ptrs")] + [(name, _INT) for name in (
            "B", "R", "W", "C", "L", "n", "A", "wc", "et", "mode", "votes",
            "epoch", "plan", "cells", "warps", "blocks", "smem",
            "commit_blocks", "commit_rows", "out_words", "force", "shards",
            "defer")]


class _Shard(ctypes.Structure):
    """One read shard of a fused call: ``csrc/branch_step.cu``'s
    ``BranchShard``, field for field."""

    _fields_ = [(name, _PTR) for name in _STORE + ("reads", "rlen")]


def _shard_array(states, reads, rlens):
    """The ``BranchShard`` records of ``states`` (``reads`` may hold
    ``None``: a root reads none)."""
    arr = (_Shard * len(states))()
    for rec, st, rd, rl in zip(arr, states, reads, rlens):
        for name in _STORE:
            setattr(rec, name, st[name].data_ptr())
        rec.reads = None if rd is None else rd.data_ptr()
        rec.rlen = rl.data_ptr()
    return arr


#: the dtype of each field of a store
_DTYPES = dict.fromkeys(_STORE, torch.int32) | {"act": torch.bool}


def shard_records(states, reads, rlens) -> torch.Tensor:
    """The shards' ``BranchShard`` records (``csrc/store_shards.cuh``'s
    ``StoreShard``, the same layout) copied into device memory on their
    card: the table the shard instances of the run, dual-run and arena
    kernels read (their kernel parameter holds only its address).  Raises
    unless the 1 to ``MAX_SHARDS`` shards are contiguous stores of one
    geometry on one CUDA device, each with its ``int16 [Rs, L]`` reads and
    ``int32 [Rs]`` lengths there."""
    _check_shards(states)
    if len(states) > MAX_SHARDS:
        raise ValueError(f"{len(states)} shards: a launch takes at most "
                         f"{MAX_SHARDS}")
    dev = states[0]["D"].device
    if dev.type != "cuda":
        raise ValueError("a shard instance needs its shards on a CUDA device")
    Rs = states[0]["D"].shape[1]
    for st, rd, rl in zip(states, reads, rlens):
        for name, dt in _DTYPES.items():
            t = st[name]
            if t.dtype != dt or t.device != dev or not t.is_contiguous():
                raise ValueError(f"state[{name!r}]: need contiguous {dt} on "
                                 f"{dev}")
        if (rd.dtype != torch.int16 or rd.device != dev or rd.dim() != 2
                or rd.shape[0] != Rs or not rd.is_contiguous()):
            raise ValueError("reads: need contiguous int16 [Rs, L] on the "
                             "shards' device")
        if (rl.dtype != torch.int32 or rl.device != dev or rl.shape != (Rs,)
                or not rl.is_contiguous()):
            raise ValueError("rlen: need int32 [Rs] on the shards' device")
    if len({rd.shape[1] for rd in reads}) != 1:
        raise ValueError("the shards' reads need one length L")
    host = torch.frombuffer(bytearray(_shard_array(states, reads, rlens)),
                            dtype=torch.int64)
    return host.to(dev)


def branch_cuda(entry: str, launcher: str, *args,
                plan: Optional[BranchPlan] = None, shards: int = 0) -> None:
    """Call the C entry ``branch_<launcher>_launch`` of
    ``csrc/branch_step.cu`` with ``args``; raises when it refuses the plan
    or the launch fails, never falls back.  Each call adds the kernels it
    launched to ``branch_cuda.launches`` and one to
    ``branch_cuda.entries[entry]`` and, for a call on ``plan``, to
    ``branch_cuda.entries[plan.name]``; a fused call on ``shards`` read
    shards adds one to ``branch_cuda.entries["fused"]`` and to
    ``branch_cuda.fused_shards[shards]``, and its kernels to
    ``branch_cuda.fused_launches``."""
    name = f"branch_{launcher}_launch"
    rc = rpk._bind(name, _ARGTYPES[launcher])(*args)
    rpk._raise_on(rc, f"branch_step {entry}", name)
    kernels = 1 if plan is None else plan.kernels
    branch_cuda.launches += kernels
    _THREAD.launches = thread_launches() + kernels
    branch_cuda.entries[entry] += 1
    if plan is not None:
        branch_cuda.entries[plan.name] += 1
        branch_cuda.last_plan = plan
    if shards:
        branch_cuda.entries["fused"] += 1
        branch_cuda.fused_shards[shards] = (
            branch_cuda.fused_shards.get(shards, 0) + 1)
        branch_cuda.fused_launches += 1 if plan is None else plan.kernels


branch_cuda.launches = 0
branch_cuda.entries = dict.fromkeys(
    ("root", "copy", "advance", "stats", "finalize", "deactivate") + PLANS
    + ("fused",), 0)
#: fused calls by their number of read shards, and their kernels
branch_cuda.fused_shards = {}
branch_cuda.fused_launches = 0
branch_cuda.last_plan = None

#: this thread's branch-step kernels (the services' dispatcher threads
#: launch at the same time: a count taken around one thread's call reads
#: this, not the process-wide ``branch_cuda.launches``)
_THREAD = threading.local()


def thread_launches() -> int:
    """The branch-step kernels this thread has launched."""
    return getattr(_THREAD, "launches", 0)


def _check_store(state, reads, rlen):
    dev = state["D"].device
    if dev.type != "cuda":
        raise ValueError("branch_step needs tensors on a CUDA device")
    B, R, W = state["D"].shape
    rpk._need(state["D"], torch.int32, dev, "D")
    for name in ("e", "rmin", "er", "off"):
        rpk._need(state[name], torch.int32, dev, name, (B, R))
    rpk._need(state["act"], torch.bool, dev, "act", (B, R))
    rpk._need(state["cons"], torch.int32, dev, "cons")
    rpk._need(state["clen"], torch.int32, dev, "clen", (B,))
    if state["cons"].shape[0] != B:
        raise ValueError("cons: need [B, C]")
    rpk._need(rlen, torch.int32, dev, "rlen", (R,))
    if reads is not None:
        rpk._need(reads, torch.int16, dev, "reads")
        if reads.shape[0] != R:
            raise ValueError("reads: need [R, L]")
    return dev, B, R, W


#: (device index) -> SMs; (device index, cells, smem, shards > 1) ->
#: one-launch CTAs an SM holds at once
_SMS = {}
_PER_SM = {}


def _occupancy(dev, cells: int, smem: int, shards: int = 1):
    """``(sms, per_sm)`` of the card for the one-launch kernel on
    ``cells`` cells a lane and ``smem`` bytes (the committing instance for
    a call on ``shards`` shards, whose CTAs must all be resident), asked
    once a shape."""
    if dev.index not in _SMS:
        _SMS[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    key = (dev.index, cells, smem, shards > 1)
    if key not in _PER_SM:
        per_sm = ctypes.c_int(0)
        fn = rpk._bind("branch_occupancy",
                       [_INT, _INT, _INT, _INT, ctypes.POINTER(_INT)])
        rc = fn(cells, ONE_WARPS, smem, shards, ctypes.byref(per_sm))
        rpk._raise_on(rc, "branch_step occupancy", "branch_occupancy")
        _PER_SM[key] = per_sm.value
    return _SMS[dev.index], _PER_SM[key]


def _grown(t, need: int, device, host: bool = False, zero: bool = False):
    """``t`` when it holds ``need`` int32 words, else a new buffer of the
    next power of two, at least 256: on ``device``, or with ``host`` on
    the host (pinned when ``device`` is a card)."""
    if t is not None and t.numel() >= need:
        return t
    cap = 1 << max(8, (need - 1).bit_length())
    make = torch.zeros if zero else torch.empty
    if host:
        return make(cap, dtype=torch.int32,
                    pin_memory=torch.device(device).type == "cuda")
    return make(cap, dtype=torch.int32, device=device)


def _stream(dev) -> int:
    """PyTorch's current CUDA stream on ``dev``, as an address."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def _wait(event: int) -> None:
    """Wait until the work recorded on ``event`` (a store's last upload)
    has finished."""
    rpk._raise_on(rpk._bind("branch_event_sync", [_PTR])(event),
                  "branch_step event", "branch_event_sync")


def _free_event(event: int) -> None:
    """Free ``event`` once its work has finished: the buffers' pinned
    rows, freed right after, may still feed its upload."""
    _wait(event)
    rpk._bind("branch_event_free", [_PTR])(event)


class BranchBuffers:
    """A branch store's persistent buffers for the CUDA branch step (a
    call given none uses the module's own, :func:`shared_buffers`): the
    rows (device and pinned host), the packed output (device and pinned
    host), the scratch, an event, and the call record with the store's
    pointers and geometry, checked once a geometry.  Grown as a call
    needs; ``reset`` drops them (``TorchScorer`` does when it reallocates
    its store).  The C entry does a call's copies: the rows (a root's or
    a deactivation's input too) are one async copy from the pinned rows,
    which are written again, grown or dropped only after the last call
    that returned without waiting (its event) has finished; the output
    lands in the pinned output, then one wait on the event."""

    def __init__(self) -> None:
        self._event = self._release = None
        self.pending = False
        self.reset()

    def reset(self) -> None:
        self.wait()
        self.call = None
        self.checks = 0
        self._key = None
        self._dev = None
        self._rows = self._rows_host = self._rows_np = None
        self._out = self._out_host = self._out_np = None
        self._scratch = None
        self._shards = None
        self._plans = {}
        self.pending = False
        self.epoch = EPOCH0
        if self._release is not None:
            self._release()
            self._event = self._release = None

    def bind(self, state, reads, rlen) -> _Call:
        """The call record of ``state``: its checks and pointers are made
        again only when a tensor of the store moved or changed shape."""
        return self.bind_shards([state], [reads], [rlen])

    def bind_shards(self, states, reads, rlens) -> _Call:
        """The call record of the read shards ``states`` (one store: a
        list of one), checked to share one card and one geometry: made
        again only when a tensor of a shard moved or changed shape."""
        key = tuple(
            tuple(st[k].data_ptr() for k in _STORE)
            + (st["D"].shape, st["cons"].shape, rd.data_ptr(), rd.shape,
               rl.data_ptr())
            for st, rd, rl in zip(states, reads, rlens))
        if key != self._key:
            if not 1 <= len(states) <= MAX_SHARDS:
                raise ValueError(f"a fused call takes 1-{MAX_SHARDS} "
                                 f"shards, not {len(states)}")
            geo = None
            for st, rd, rl in zip(states, reads, rlens):
                dev, B, R, W = _check_store(st, rd, rl)
                g = (dev, B, R, W, st["cons"].shape[1], rd.shape[1])
                if geo is not None and g != geo:
                    raise ValueError("the shards of a fused call need one "
                                     f"device and one geometry: {g} vs {geo}")
                geo = g
            dev, B, R, W, C, L = geo
            self.on(dev)
            c = _Call()
            st, S = states[0], len(states)
            for name in _STORE:
                setattr(c, name, st[name].data_ptr())
            c.reads, c.rlen = reads[0].data_ptr(), rlens[0].data_ptr()
            self._shards = _shard_array(states, reads, rlens) if S > 1 else None
            c.shard_ptrs = (None if S == 1
                            else ctypes.addressof(self._shards))
            c.shards = S
            c.B, c.R, c.W, c.C, c.L = B, R, W, C, L
            self.call, self._key = c, key
            self._plans = {}
            self.checks += 1
        return self.call

    def device(self):
        return self._dev

    def on(self, dev) -> None:
        """Serve stores on ``dev`` (dropping the buffers of another)."""
        if dev != self._dev:
            self.reset()
            self._dev = dev

    def wait(self) -> None:
        """Wait for the last call that returned without waiting: until
        then its upload may still read the pinned rows."""
        if self.pending:
            _wait(self._event)
            self.pending = False

    def event(self) -> int:
        """The store's CUDA event (made at first use), as an address."""
        if self._event is None:
            ev = ctypes.c_void_p()
            fn = rpk._bind("branch_event", [ctypes.POINTER(_PTR)])
            rpk._raise_on(fn(ctypes.byref(ev)), "branch_step event",
                          "branch_event")
            self._event = ev.value
            # freed by reset, or when the buffers are collected
            self._release = weakref.finalize(self, _free_event, ev.value)
        return self._event

    def stage(self, words: np.ndarray):
        """The int32 ``words`` into the pinned rows, once the last upload
        from them has landed; returns the device and host addresses of
        the rows buffers (the C entry copies)."""
        n = words.size
        self.wait()
        if self._rows is None or self._rows.numel() < n:
            self._rows = _grown(None, n, self._dev)
            self._rows_host = _grown(None, n, self._dev, host=True)
            self._rows_np = self._rows_host.numpy()
        self._rows_np[:n] = words.reshape(-1)
        return self._rows.data_ptr(), self._rows_host.data_ptr()

    def output(self, words: int):
        """The output buffers for ``words`` words, zeroed when they are
        made (so no flag holds an epoch yet): returns the addresses of
        the device output, the pinned host output and the device overflow
        word (the buffer's last word)."""
        if self._out is None or self._out.numel() < words + 1:
            self._out = _grown(None, words + 1, self._dev, zero=True)
            self._out_host = _grown(None, words + 1, self._dev, host=True,
                                    zero=True)
            self._out_np = self._out_host.numpy()
        out = self._out.data_ptr()
        return out, self._out_host.data_ptr(), out + 4 * (
            self._out.numel() - 1)

    def fetched(self, words: int) -> np.ndarray:
        """The pinned output's first ``words`` words (a view)."""
        return self._out_np[:words]

    def scratch(self, words: int) -> Optional[int]:
        if not words:
            return None
        self._scratch = _grown(self._scratch, words, self._dev)
        return self._scratch.data_ptr()

    def next_epoch(self) -> int:
        """A new epoch for a call with stats (the output zeroed when the
        epochs run out of int32)."""
        self.epoch += 1
        if self.epoch >= 2**31 - 1:
            self._out.zero_()
            self._out_host.zero_()
            self.epoch = EPOCH0 + 1
        return self.epoch

    def plan(self, n: int, A: int, commit: bool) -> BranchPlan:
        """:func:`plan_branch` for a call of ``n`` rows on the bound
        store (every (row, shard, read) warp of its shards), with the
        card's SMs and occupancy (kept a shape)."""
        key = (n, A, commit)
        plan = self._plans.get(key)
        if plan is None:
            c = self.call
            cells = one_launch_cells(c.W)
            smem = one_launch_smem(cells, A)
            # a call on several shards runs the kernel's shard instance
            shards = (c.shards,) if c.shards > 1 else ()
            sms, per_sm = (_occupancy(self._dev, cells, smem, *shards)
                           if cells and smem <= ONE_SMEM_MAX else (0, 0))
            plan = plan_branch(n, c.R * c.shards, c.W, A, sms, per_sm,
                               commit)
            if len(self._plans) < 4096:
                self._plans[key] = plan
        return plan


_SHARED = []


def shared_buffers() -> BranchBuffers:
    """The module's :class:`BranchBuffers`, for calls given none (made
    at first use)."""
    if not _SHARED:
        _SHARED.append(BranchBuffers())
    return _SHARED[0]


def _rows_cuda(entry, mode, votes, state, rows, reads, rlen, wc, et,
               num_symbols, with_out, bufs, force=False, part=None):
    bufs = shared_buffers() if bufs is None else bufs
    c = bufs.bind(state, reads, rlen)
    return _launch_rows(entry, mode, votes, bufs, c, rows, wc, et,
                        num_symbols, with_out, force, part)


def _launch_rows(entry, mode, votes, bufs, c, rows, wc, et, num_symbols,
                 with_out, force=False, part=None, defer=False,
                 fused=False):
    """One ``branch_rows_launch`` of the bound call ``c`` (its shards'
    reads ``c.R * c.shards`` in the output).  Returns the unpacked
    output, ``None`` without one, or with ``defer`` a function that
    waits for the output and unpacks it."""
    n = rows.shape[1]
    S = c.shards
    Ro = c.R * S
    A = max(int(num_symbols), 1) if votes else 1
    plan = bufs.plan(n, A, mode == 0)
    words = plan.out_words if votes else plan.head_words
    c.rows, c.rows_host = bufs.stage(rows)
    if with_out:
        c.out, c.out_host, c.flag = bufs.output(words)
        c.epoch = bufs.next_epoch()
    else:
        c.out = c.out_host = c.flag = None
        c.epoch = 0
    c.out_words = words
    c.slab = bufs.scratch(scratch_words(plan, n, Ro, c.W, c.C, S))
    c.event = bufs.event()
    c.stream = _stream(bufs.device())
    c.n, c.A, c.wc, c.et = n, A, wc, int(et)
    c.mode, c.votes = mode, int(votes)
    c.plan = int(plan.name == "one_launch")
    c.cells, c.warps, c.blocks, c.smem = (plan.cells, plan.warps,
                                          plan.blocks, plan.smem)
    c.commit_blocks, c.commit_rows = plan.commit_blocks, plan.commit_rows
    c.force = int(force)
    c.part = None if part is None else part.data_ptr()
    c.defer = int(defer and with_out)
    branch_cuda(entry, "rows", ctypes.byref(c), plan=plan,
                shards=S if fused else 0)
    bufs.pending = not with_out or bool(c.defer)
    if not with_out:
        return None
    epoch = c.epoch

    def collect() -> BranchOut:
        bufs.wait()
        return unpack(bufs.fetched(words), n, Ro, A, votes, epoch)

    return collect if c.defer else collect()


def _act_words(act) -> np.ndarray:
    """A ``[R]`` bool mask as the bytes of int32 words (the root kernel
    reads it as uint8)."""
    a = np.asarray(act, dtype=np.uint8).reshape(-1)
    buf = np.zeros(-(-a.size // 4) * 4, dtype=np.uint8)
    buf[:a.size] = a
    return buf.view(np.int32)


def root_cuda(state, slot: int, act, rlen, bufs=None) -> None:
    """Launch ``branch_root``: :func:`root_plain` on the card; ``act`` is
    a ``[R]`` bool mask (a host array, or a tensor), copied to the card
    through ``bufs``'s rows."""
    dev, B, R, W = _check_store(state, None, rlen)
    if isinstance(act, torch.Tensor):
        act = act.cpu().numpy()
    act = np.asarray(act)
    if act.shape != (R,):
        raise ValueError(f"act: need [{R}]")
    if not 0 <= slot < B:
        raise ValueError(f"slot {slot} outside [0, {B})")
    bufs = shared_buffers() if bufs is None else bufs
    bufs.on(dev)
    act_dev, act_host = bufs.stage(_act_words(act))
    branch_cuda(
        "root", "root", *_store_ptrs(state)[:6],
        *map(rpk._ptr, (state["clen"], rlen)), _PTR(act_dev), _PTR(act_host),
        _PTR(bufs.event()), slot, B, R, W, ROW_WARPS, -(-R // ROW_WARPS),
        _PTR(_stream(dev)),
    )
    bufs.pending = True


def _store_ptrs(st):
    return [rpk._ptr(st[k]) for k in _STORE]


def advance_cuda(state, rows, reads, rlen, wc: int, et: bool,
                 num_symbols: int, with_stats: bool = True, bufs=None,
                 force: bool = False, part=None):
    """One call of ``csrc/branch_step.cu`` on its plan (one launch, or the
    slab plan's rows and commit launches): :func:`advance_plain` on the
    card, its stats fetched in one copy; a batch of copies
    (``with_stats`` False) does not synchronise.  ``force`` commits an
    overflowing batch; ``part`` (an int32 ``[3]`` tensor on the store's
    device, with stats) receives the partials of a read shard's column
    step: the active reads' edit-distance sum, any read reached, any
    pushed read overflowed."""
    rows = _rows_np(rows)
    _check_rows(state, rows, with_stats)
    if part is not None:
        if not with_stats:
            raise ValueError("partials need the stats")
        rpk._need(part, torch.int32, state["D"].device, "part", (3,))
    return _rows_cuda("advance" if with_stats else "copy", 0, with_stats,
                      state, rows, reads, rlen, wc, et, num_symbols,
                      with_stats, bufs, force, part)


def _slot_rows(state, slots) -> np.ndarray:
    s = np.asarray(slots, dtype=np.int32).reshape(-1)
    rows = np.stack([s, s, np.full_like(s, -1)])
    B = state["D"].shape[0]
    if len(s) < 1 or s.min() < 0 or s.max() >= B:
        raise ValueError(f"slots outside [0, {B})")
    return rows


def stats_cuda(state, slots, reads, rlen, num_symbols: int,
               bufs=None) -> BranchOut:
    """The rows kernel in read mode: :func:`stats_plain` on the card."""
    return _rows_cuda("stats", 1, True, state, _slot_rows(state, slots),
                      reads, rlen, -2, False, num_symbols, True, bufs)


def finalize_cuda(state, slots, reads, rlen, bufs=None):
    """The rows kernel in read mode without the histogram:
    :func:`finalize_plain` on the card."""
    out = _rows_cuda("finalize", 1, False, state, _slot_rows(state, slots),
                     reads, rlen, -2, False, 1, True, bufs)
    return out.fin, ~out.fin_ok


def deactivate_cuda(state, pairs, bufs=None) -> None:
    """Launch ``branch_deactivate``: :func:`deactivate_plain` on the
    card, the pairs uploaded through ``bufs``."""
    act = state["act"]
    dev = act.device
    if dev.type != "cuda":
        raise ValueError("branch_step needs tensors on a CUDA device")
    rpk._need(act, torch.bool, dev, "act")
    B, R = act.shape
    p = np.ascontiguousarray(pairs, dtype=np.int32)
    m = p.shape[1] if p.ndim == 2 and p.shape[0] == 2 else 0
    if (m < 1 or p[0].min() < 0 or p[0].max() >= B or p[1].min() < 0
            or p[1].max() >= R):
        raise ValueError(f"pairs: need [2, m] inside [{B}, {R}]")
    bufs = shared_buffers() if bufs is None else bufs
    bufs.on(dev)
    pairs_dev, pairs_host = bufs.stage(p)
    branch_cuda("deactivate", "deactivate", rpk._ptr(act), _PTR(pairs_dev),
                _PTR(pairs_host), _PTR(bufs.event()), m, B, R,
                -(-m // COPY_THREADS), _PTR(_stream(dev)))
    bufs.pending = True


def advance_shards_cuda(states, rows, reads, rlens, wc: int, et: bool,
                        num_symbols: int, with_stats: bool = True,
                        bufs=None, force: bool = False, part=None,
                        defer: bool = False):
    """One fused call of ``csrc/branch_step.cu`` over the read shards
    ``states`` (each with its ``reads`` and ``rlens``, one card, one
    geometry, at most :data:`MAX_SHARDS`): one launch on ``one_launch``
    (two on ``slab``) for every shard, committed in every shard or in
    none (unless ``force``); :func:`advance_shards_plain` on the card.
    ``part`` (int32 ``[3]`` on the card, with stats) receives the call's
    partials; ``defer`` returns a function that waits for the output (so
    launches on several cards are all queued before the first wait)."""
    rows = _rows_np(rows)
    bufs = shared_buffers() if bufs is None else bufs
    c = bufs.bind_shards(states, reads, rlens)  # one geometry: one check
    _check_rows(states[0], rows, with_stats)
    if part is not None:
        if not with_stats:
            raise ValueError("partials need the stats")
        rpk._need(part, torch.int32, states[0]["D"].device, "part", (3,))
    return _launch_rows("advance" if with_stats else "copy", 0, with_stats,
                        bufs, c, rows, wc, et, num_symbols, with_stats,
                        force, part, defer, fused=True)


def stats_shards_cuda(states, slots, reads, rlens, num_symbols: int,
                      bufs=None, defer: bool = False):
    """The fused call in read mode: :func:`stats_shards_plain` on the
    card (``defer`` as :func:`advance_shards_cuda`)."""
    bufs = shared_buffers() if bufs is None else bufs
    c = bufs.bind_shards(states, reads, rlens)
    return _launch_rows("stats", 1, True, bufs, c,
                        _slot_rows(states[0], slots), -2, False, num_symbols,
                        True, defer=defer, fused=True)


def finalize_shards_cuda(states, slots, reads, rlens, bufs=None):
    """The fused call in read mode without the histogram:
    :func:`finalize_shards_plain` on the card."""
    bufs = shared_buffers() if bufs is None else bufs
    c = bufs.bind_shards(states, reads, rlens)
    out = _launch_rows("finalize", 1, False, bufs, c,
                       _slot_rows(states[0], slots), -2, False, 1, True,
                       fused=True)
    return out.fin, ~out.fin_ok


def root_shards_cuda(states, slot: int, act, rlens, bufs=None) -> None:
    """Launch ``branch_root`` once over every shard of ``states``:
    :func:`root_shards_plain` on the card (``act`` the ``[S x R]`` mask
    in shard order)."""
    _check_shards(states)
    if not 1 <= len(states) <= MAX_SHARDS:
        raise ValueError(f"a fused call takes 1-{MAX_SHARDS} shards")
    dev, B, R, W = _check_store(states[0], None, rlens[0])
    for st, rl in zip(states[1:], rlens[1:]):
        _check_store(st, None, rl)
    act = np.asarray(act, dtype=bool).reshape(-1)
    if act.shape != (len(states) * R,):
        raise ValueError(f"act: need [{len(states) * R}]")
    if not 0 <= slot < B:
        raise ValueError(f"slot {slot} outside [0, {B})")
    bufs = shared_buffers() if bufs is None else bufs
    bufs.on(dev)
    act_dev, act_host = bufs.stage(_act_words(act))
    arr = _shard_array(states, [None] * len(states), rlens)
    S = len(states)
    branch_cuda(
        "root", "root_shards", ctypes.byref(arr), S, _PTR(act_dev),
        _PTR(act_host), _PTR(bufs.event()), slot, B, R, W, ROW_WARPS,
        -(-S * R // ROW_WARPS), _PTR(_stream(dev)), shards=S)
    bufs.pending = True


# ---------------------------------------------------------------------
# dispatch


def _on_cuda(t) -> bool:
    """Whether a dispatch launches the kernel (CUDA) or its twin (CPU);
    any other device raises, and so does an armed ``pallas_compile``
    fault (never a quiet switch to the twin)."""
    faults.check_kernel("branch")
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"no branch kernel for device type {kind!r}")
    return kind == "cuda"


def root(state, slot: int, act, rlen, bufs=None) -> None:
    """Dispatch rule: CPU tensors take :func:`root_plain`, CUDA tensors
    launch :func:`root_cuda` (``act`` a host mask or a bool tensor)."""
    if _on_cuda(state["D"]):
        root_cuda(state, slot, act, rlen, bufs)
    else:
        root_plain(state, slot, torch.as_tensor(act, dtype=torch.bool),
                   rlen)


def advance(state, rows, reads, rlen, wc: int, et: bool, num_symbols: int,
            with_stats: bool = True, bufs=None):
    """Dispatch rule: CPU tensors take :func:`advance_plain`, CUDA tensors
    launch :func:`advance_cuda` (through ``bufs``, the store's
    :class:`BranchBuffers`)."""
    if _on_cuda(state["D"]):
        return advance_cuda(state, rows, reads, rlen, wc, et, num_symbols,
                            with_stats, bufs)
    return advance_plain(state, rows, reads, rlen, wc, et, num_symbols,
                         with_stats)


def stats(state, slots, reads, rlen, num_symbols: int,
          bufs=None) -> BranchOut:
    """Dispatch rule: CPU tensors take :func:`stats_plain`, CUDA tensors
    launch :func:`stats_cuda`."""
    if _on_cuda(state["D"]):
        return stats_cuda(state, slots, reads, rlen, num_symbols, bufs)
    return stats_plain(state, slots, reads, rlen, num_symbols)


def finalize(state, slots, reads, rlen, bufs=None):
    """Dispatch rule: CPU tensors take :func:`finalize_plain`, CUDA
    tensors launch :func:`finalize_cuda`."""
    if _on_cuda(state["D"]):
        return finalize_cuda(state, slots, reads, rlen, bufs)
    return finalize_plain(state, slots)


def deactivate(state, pairs, bufs=None) -> None:
    """Dispatch rule: CPU tensors take :func:`deactivate_plain`, CUDA
    tensors launch :func:`deactivate_cuda`."""
    if _on_cuda(state["act"]):
        deactivate_cuda(state, pairs, bufs)
    else:
        deactivate_plain(state, pairs)


def root_shards(states, slot: int, act, rlens, bufs=None) -> None:
    """Dispatch rule: CPU tensors take :func:`root_shards_plain`, CUDA
    tensors launch :func:`root_shards_cuda`."""
    if _on_cuda(states[0]["D"]):
        root_shards_cuda(states, slot, act, rlens, bufs)
    else:
        root_shards_plain(states, slot, act, rlens)


def advance_shards(states, rows, reads, rlens, wc: int, et: bool,
                   num_symbols: int, with_stats: bool = True, bufs=None,
                   force: bool = False, part=None, defer: bool = False):
    """Dispatch rule: CPU tensors take :func:`advance_shards_plain`
    (``part`` is the caller's to fill there), CUDA tensors launch
    :func:`advance_shards_cuda`."""
    if _on_cuda(states[0]["D"]):
        return advance_shards_cuda(states, rows, reads, rlens, wc, et,
                                   num_symbols, with_stats, bufs, force,
                                   part, defer)
    return advance_shards_plain(states, rows, reads, rlens, wc, et,
                                num_symbols, with_stats, force)


def stats_shards(states, slots, reads, rlens, num_symbols: int, bufs=None,
                 defer: bool = False):
    """Dispatch rule: CPU tensors take :func:`stats_shards_plain`, CUDA
    tensors launch :func:`stats_shards_cuda`."""
    if _on_cuda(states[0]["D"]):
        return stats_shards_cuda(states, slots, reads, rlens, num_symbols,
                                 bufs, defer)
    return stats_shards_plain(states, slots, reads, rlens, num_symbols)


def finalize_shards(states, slots, reads, rlens, bufs=None):
    """Dispatch rule: CPU tensors take :func:`finalize_shards_plain`,
    CUDA tensors launch :func:`finalize_shards_cuda`."""
    if _on_cuda(states[0]["D"]):
        return finalize_shards_cuda(states, slots, reads, rlens, bufs)
    return finalize_shards_plain(states, slots)


#: the plain twins, whose calls :func:`plain_calls` sums
TWINS = (root_plain, advance_plain, stats_plain, finalize_plain,
         deactivate_plain, root_shards_plain, advance_shards_plain,
         stats_shards_plain, finalize_shards_plain)
