"""Device branch store over the banded column DP, in PyTorch.

The torch counterpart of ``waffle_con_tpu``'s ``JaxScorer``
(``ops/jax_scorer.py``).  Every read's incremental wavefront is re-derived
from a *banded Levenshtein column*: ``D[b, r, t]`` is the edit distance
between ``cons[off:j]`` and ``read[:i]`` at ``i = j - off - E + t`` for a
band of half-width ``E`` (``W = 2E + 2`` cells), kept for every branch
slot ``b`` and read ``r`` on one torch device, with the per-read running
folds ``e`` (edit distance), ``rmin`` (running minimum over the read-end
row) and ``er`` (the cost latched when the wavefront first touched the
read end).  The equivalence with the DWFA oracle is argued in the JAX
package's module docstring; the parity tests hold this port to it.

The column primitives (:func:`init_col`, :func:`col_step`,
:func:`stats_core`, :func:`finalized`) are plain torch ops over any
number of leading branch dimensions.  The branch life-cycle calls
(root, clone, push, clone_push, stats, finalize, deactivate) go through
:mod:`waffle_con_tpu_torch.ops.branch_kernel`: the CUDA kernels of
``csrc/branch_step.cu`` on a CUDA device (an advance is one launch, or
two on the slab plan, its packed stats landing in the store's persistent
pinned buffers), and plain twins built from those primitives on the
CPU.  The run
loops — the hot path — are the CUDA kernels of
:mod:`waffle_con_tpu_torch.ops.run_kernel` (one branch) and
:mod:`waffle_con_tpu_torch.ops.run_dual_kernel` (the two branches of a
dual node) on a CUDA device, and their plain torch twins on the CPU.
Late reads and band growth (the activation-offset search, activation's
catch-up and the replay of every branch at a grown band) go through
:mod:`waffle_con_tpu_torch.ops.replay_kernel`: CUDA kernels on a CUDA
device, and the plain twins :func:`offset_scan` and :func:`replay_rows`
on the CPU.
The frontier gang (:mod:`waffle_con_tpu_torch.ops.ragged`) runs several
branches' runs in one launch and keeps each result as a deposit that
:meth:`TorchScorer.run_extend` consumes when the branch's own pop makes a
call that validates it.

Each CUDA kernel has a launch planner that refuses shapes it does not
take; :meth:`TorchScorer.run_takes`, :meth:`~TorchScorer.run_dual_takes`
and :meth:`~TorchScorer.arena_takes` give its answer for the store's
current shape (counting each refusal as ``plan_refused_<kernel>``), so
the engines take their exact host path instead of a kernel that would
refuse the launch.  The plain twins take every shape.

Geometry follows ``JaxScorer`` so scorer-level outputs and stop codes
match, not only final sequences: reads padded to a power of two (at
least 16 rows, 256 columns), ``E`` from ``INITIAL_E`` or the next power
of two of ``initial_band``, doubling with a replay of every branch on
band overflow, branch slots and consensus capacity doubling on demand.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.obs import phases as _phases
from waffle_con_tpu_torch.ops import ragged
from waffle_con_tpu_torch.ops.scorer import (
    BranchStats,
    WavefrontScorer,
    find_activation_offset,
)

#: band "infinity" (unreachable cell)
INF = 1 << 20

#: vote-sum comparison margin of the run loop: decisions whose float32
#: margin is under this stop the run and go to the host's exact float64
#: nomination (exact one-hot votes bypass it)
VOTE_EPS = np.float32(1e-2)

#: capacity of the run loop's record-absorption buffers
REC_CAP = 256

#: per-call step cap of the run loop (symbol buffer rows)
RUN_MS_CAP = 32768

#: children one arena split event may create on the device (more stop
#: for host expansion); ``ops/arena_kernel.py`` keeps the same value
CRE_PER_EVENT = 8


def planner_refuses(device, planner, *shape) -> bool:
    """Whether the kernel that runs on ``device`` refuses ``shape``: a
    CUDA kernel refuses what its launch planner raises ``ValueError`` on;
    the plain twins, which run on the CPU, take every shape."""
    if torch.device(device).type != "cuda":
        return False
    try:
        planner(*shape)
    except ValueError:
        return True
    return False


def _next_pow2(n: int, minimum: int = 1) -> int:
    return max(minimum, 1 << max(0, (n - 1).bit_length()))


def _pad_len_table(tab: np.ndarray, need: int) -> np.ndarray:
    """Pad a per-length int table to a power-of-two length >= ``need``
    with its final value (tables are constant past the last activation
    point), as ``JaxScorer`` does, so clipped lookups agree."""
    n = _next_pow2(max(int(need), len(tab), 8))
    out = np.full(n, tab[-1], dtype=np.int32)
    out[: len(tab)] = tab
    return out


# ======================================================================
# column primitives.  Shapes: D [..., R, W]; e/rmin/er/off/act [..., R];
# rlen [R]; a consensus position (j / jnew / clen) and a symbol are
# Python ints or tensors of the leading shape.


def _lead(x, like):
    """A per-branch scalar (int or ``[...]`` tensor) as ``[..., 1, 1]``."""
    x = torch.as_tensor(x, dtype=torch.int32, device=like.device)
    return x.reshape(x.shape + (1, 1))


def _band_pos(j, off, E: int, W: int):
    """``[..., R, W]`` read position of every band cell at column ``j``."""
    t = torch.arange(W, dtype=torch.int32, device=off.device)
    return _lead(j, off) - off[..., None] - E + t


def gather_window(reads, j, off, E: int, W: int):
    """Read symbols ``reads[r, i]`` at the band positions of column
    ``j`` (clamped into the padded read; out-of-range lanes are masked by
    every consumer)."""
    i = _band_pos(j, off, E, W).clamp(0, reads.shape[1] - 1).long()
    rows = torch.arange(reads.shape[0], device=reads.device)[:, None]
    return reads[rows, i]


def init_col(off, act, rlen, E: int, W: int):
    """Fresh DP column at ``j == off`` (nothing of the consensus
    consumed): the cost of read prefix ``i`` is ``i``.  Returns
    ``(D, e, rmin, er)``."""
    t = torch.arange(W, dtype=torch.int32, device=off.device)
    i0 = t - E
    D = torch.where((i0 >= 0) & (i0 <= rlen[:, None]), i0, INF)
    D = torch.where(act[..., None], D, INF).to(torch.int32)
    e = torch.zeros_like(off)
    rmin = torch.where(act & (rlen <= E + 1), rlen, INF).to(torch.int32)
    er = torch.where(rmin <= 0, 0, INF).to(torch.int32)
    return D, e, rmin, er


def col_step(D, e, rmin, er, off, act, rlen, bchar, jnew, sym, wc, et, E):
    """Advance the banded columns from ``jnew - 1`` to ``jnew`` by
    consuming consensus symbol ``sym``; ``bchar`` is the read window of
    column ``jnew - 1`` (:func:`gather_window`).  Inactive reads pass
    through unchanged."""
    W = D.shape[-1]
    t = torch.arange(W, dtype=torch.int32, device=D.device)
    i_new = _band_pos(jnew, off, E, W)
    sub = ((bchar != _lead(sym, D)) & (bchar != wc)).to(torch.int32)
    diag = D + sub
    dele = torch.cat([D[..., 1:], torch.full_like(D[..., :1], INF)], -1) + 1
    base = torch.minimum(diag, dele)
    invalid = (i_new < 0) | (i_new > rlen[:, None])
    base = torch.where(invalid, INF, base)
    # insertion chain within the column: prefix-min of (base - t) + t
    chain = torch.cummin(base - t, dim=-1).values
    Dn = torch.minimum(base, chain + t).clamp(max=INF)

    colmin = Dn.amin(-1)
    rend = torch.where(i_new == rlen[:, None], Dn, INF).amin(-1)
    rmin_n = torch.minimum(rmin, rend)
    e_uncapped = torch.maximum(e, colmin)
    e_capped = torch.where(
        er < INF, e,
        torch.maximum(e, torch.minimum(colmin, torch.maximum(e, rmin_n))),
    )
    e_n = e_capped if et else e_uncapped
    er_n = torch.where(
        er < INF, er,
        torch.where(rmin_n <= e_n, torch.maximum(e, rmin_n), INF),
    )
    return (
        torch.where(act[..., None], Dn, D).to(torch.int32),
        torch.where(act, e_n, e).to(torch.int32),
        torch.where(act, rmin_n, rmin).to(torch.int32),
        torch.where(act, er_n, er).to(torch.int32),
    )


def stats_core(D, e, rmin, er, off, act, rlen, vchar, clen, num_symbols, E):
    """Snapshot of a branch: per-read edit distance, tip votes over the
    dense symbols, reached flags.  ``vchar`` is the read window of column
    ``clen``.  Returns ``(eds, occ [..., R, A], split, reached)``."""
    W = D.shape[-1]
    i = _band_pos(clen, off, E, W)
    tip = (
        act[..., None] & (D <= e[..., None]) & (i >= 0) & (i < rlen[:, None])
    )
    symbols = torch.arange(num_symbols, device=D.device)
    onehot = (vchar[..., None] == symbols) & tip[..., None]
    occ = onehot.sum(-2, dtype=torch.int32)
    split = occ.sum(-1, dtype=torch.int32)
    reached = act & (er < INF) & (e == er)
    eds = torch.where(act, e, 0).to(torch.int32)
    return eds, occ, split, reached


def finalized(e, rmin, act, E: int):
    """Finalized per-read distances (``max(e, rmin)``) and the
    out-of-band flag (per branch)."""
    fin = torch.maximum(e, rmin)
    ovf = (act & (fin >= E)).any(-1)
    return torch.where(act, fin.clamp(max=INF), 0).to(torch.int32), ovf


def offset_scan(cons_win, heads, m: int, wc: int, P: int, M: int):
    """Activation-offset scores of every window position: ``ed[b, p] =
    min_j Lev(heads[b][:m], cons_win[p : p + j])`` for ``p < P``, the
    prefix mode of ``wfa_ed_config(require_both_end=False)`` as one dense
    DP over ``j = 1 .. 2M`` (a longer consensus prefix costs more than
    the empty one).  ``cons_win`` is ``[P + 2M]`` int32 dense ids padded
    with a sentinel, ``heads`` ``[B, M]`` int32 padded with another; the
    sentinels never match, the wildcard ``wc`` (or -2) matches on either
    side.  Returns ``[B, P]`` int32.  The twin of ``waffle_con_tpu``'s
    ``_j_offset_scan``."""
    dev = heads.device
    B = heads.shape[0]
    Wn = cons_win.shape[0]
    i = torch.arange(M + 1, dtype=torch.int32, device=dev)
    pidx = torch.arange(P, dtype=torch.int32, device=dev)
    col = i.expand(B, P, M + 1)
    best = torch.full((B, P), min(3 * M + 5, m), dtype=torch.int32,
                      device=dev)
    head = heads[:, None, :]
    for j in range(1, 2 * M + 1):
        cj = cons_win[(pidx + j - 1).clamp(0, Wn - 1).long()][None, :, None]
        match = head == cj
        if wc >= 0:
            match = match | (head == wc) | (cj == wc)
        tmp = torch.minimum(col[..., :-1] + (~match).to(torch.int32),
                            col[..., 1:] + 1)
        full = torch.cat(
            [torch.full((B, P, 1), j, dtype=torch.int32, device=dev), tmp], -1)
        # insertion chain new[i] = min_{k <= i} full[k] + (i - k)
        col = (torch.cummin(full - i, dim=-1).values + i).to(torch.int32)
        best = torch.minimum(best, col[..., m])
    return best


def replay_rows(off, act, cons, clen, reads, rlen, wc: int, et: bool,
                E: int, W: int):
    """Every ``(slot, read)`` row's band rebuilt at half-width ``E``
    (``W`` cells): ``init_col`` at the row's own ``off``, then one column
    step per consensus symbol ``cons[slot, j]`` for ``off <= j <
    clen[slot]``, on active rows only (inactive rows keep ``init_col``'s
    values).  ``off``/``act`` ``[B, R]``, ``cons`` ``[B, C]``, ``clen``
    ``[B]``, ``reads`` ``[R, L]``, ``rlen`` ``[R]``.  Returns ``(D [B, R,
    W], e, rmin, er)``.  A row depends only on its own column, its read
    and its slot's consensus, so this is both ``waffle_con_tpu``'s
    ``_j_replay`` (every row, after band growth) and ``_j_activate``'s
    catch-up (one row)."""
    D, e, rmin, er = init_col(off, act, rlen, E, W)
    maxlen = int(clen.max())
    # columns before every active row's anchor step nothing
    j0 = int(torch.where(act, off, maxlen).min())
    C = cons.shape[1]
    for j in range(j0, maxlen):
        sym = cons[:, min(j, C - 1)]
        Dn, en, rminn, ern = col_step(
            D, e, rmin, er, off, act, rlen,
            gather_window(reads, j, off, E, W), j + 1, sym, wc, et, E,
        )
        stepm = act & (off <= j) & (j < clen[:, None])
        D = torch.where(stepm[..., None], Dn, D)
        e = torch.where(stepm, en, e)
        rmin = torch.where(stepm, rminn, rmin)
        er = torch.where(stepm, ern, er)
    return D.contiguous(), e, rmin, er


# ======================================================================


class StoreGeometry(NamedTuple):
    """What a read shard's store takes from its sharded store
    (:mod:`waffle_con_tpu_torch.ops.sharded_scorer`) instead of deriving
    it from its own reads, so that every shard of one store steps the
    same columns: its device, its rows (the padded reads over the shard
    count, no floor), the read buffer's and the consensus buffer's
    lengths, and the symbol table of all the reads."""

    device: torch.device
    rows: int
    length: int
    cons: int
    symtab: np.ndarray


class TorchScorer(WavefrontScorer):
    """Branch store on one torch device.

    Handles are host-side ids mapped to device slots.  Every call keeps
    its geometry rules and its outputs identical to ``JaxScorer``'s, so
    the search it drives is byte-identical.
    """

    INITIAL_E = 8
    INITIAL_SLOTS = 16
    MIN_R = 16
    MIN_L = 256
    MIN_C = 512

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig,
                 geometry: Optional[StoreGeometry] = None) -> None:
        super().__init__(reads, config)
        dev = torch.device(config.device if geometry is None
                           else geometry.device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but no CUDA device is "
                "available (pass device='cpu' to run on the CPU)"
            )
        self.device = dev
        n = len(self.reads)
        max_len = max((len(r) for r in self.reads), default=1)
        #: the longest read (the serving pool's eligibility reads it)
        self._max_rlen = max_len
        # inside a served job the consensus axis (and, with mixed widths
        # off, the band) rises to the serving pool's floor, so a job's
        # run calls pass the pool's capacity gate
        hint = ragged.geometry_hint() if geometry is None else None
        if geometry is None:
            self._R = max(_next_pow2(max(n, 1)), self.MIN_R)
            self._L = max(_next_pow2(max(max_len, 1)), self.MIN_L)
            self._C = max(_next_pow2(max_len + 64), self.MIN_C)
            if hint is not None:
                self._C = max(self._C, hint.cons)
        else:
            self.symtab = geometry.symtab
            self.sym_id = {int(s): i for i, s in enumerate(self.symtab)}
            self._R, self._L, self._C = (geometry.rows, geometry.length,
                                         geometry.cons)
        reads_arr = np.full((self._R, self._L), -1, dtype=np.int16)
        rlen = np.zeros(self._R, dtype=np.int32)
        for i, r in enumerate(self.reads):
            reads_arr[i, : len(r)] = [self.sym_id[b] for b in r]
            rlen[i] = len(r)
        self._reads = torch.from_numpy(reads_arr).to(dev)
        self._rlen = torch.from_numpy(rlen).to(dev)
        self._wc = (
            self.sym_id.get(config.wildcard, -2)
            if config.wildcard is not None else -2
        )
        self._et = bool(config.allow_early_termination)
        if config.initial_band is not None:
            self._E = _next_pow2(int(config.initial_band), self.INITIAL_E)
        else:
            self._E = self.INITIAL_E
        if hint is not None:
            self._E = max(self._E, hint.band)
        self._B = self.INITIAL_SLOTS
        self._state = self._blank_state()
        #: the CUDA branch step's persistent buffers for this store
        self._bk = branch_kernel.BranchBuffers()
        #: host mirrors of the per-slot offset/active state
        self._off_host = np.zeros((self._B, self._R), dtype=np.int32)
        self._act_host = np.zeros((self._B, self._R), dtype=bool)
        self._free: List[int] = list(range(self._B))
        self._next_handle = 0
        self._slot_of = {}
        #: the frontier gang's deposits (``ops/ragged.py``), made lazily
        self._frontier_gang = None
        self.counters = {
            "push_calls": 0,
            "run_calls": 0,
            "run_steps": 0,
            "arena_calls": 0,
            "run_dual_calls": 0,
            "run_dual_steps": 0,
            "stats_calls": 0,
            "clone_calls": 0,
            "clone_push_calls": 0,
            "activate_calls": 0,
            "finalize_calls": 0,
            "grow_e_events": 0,
            "replayed_cols": 0,
            "offset_scan_calls": 0,
        }

    # -- geometry ------------------------------------------------------

    @property
    def _W(self) -> int:
        return 2 * self._E + 2

    def _blank_state(self):
        B, R, W, C = self._B, self._R, self._W, self._C
        dev = self.device
        i32 = torch.int32
        return {
            "D": torch.full((B, R, W), INF, dtype=i32, device=dev),
            "e": torch.zeros((B, R), dtype=i32, device=dev),
            "rmin": torch.full((B, R), INF, dtype=i32, device=dev),
            "er": torch.full((B, R), INF, dtype=i32, device=dev),
            "off": torch.zeros((B, R), dtype=i32, device=dev),
            "act": torch.zeros((B, R), dtype=torch.bool, device=dev),
            "cons": torch.zeros((B, C), dtype=i32, device=dev),
            "clen": torch.zeros((B,), dtype=i32, device=dev),
        }

    def _grow_e(self) -> None:
        """Double the band half-width and rebuild every branch's band at
        the new width by replaying its recorded consensus from each
        read's anchor (a band is a window, so it cannot be re-padded in
        place): one column-replay launch over the (slot, read) rows of
        every allocated slot on a CUDA device."""
        from waffle_con_tpu_torch.ops import replay_kernel

        self._spec_drop()
        self._bk.reset()
        self._E *= 2
        # a serving-pool member is re-centred in the pool: its residency
        # survives while the new width fits the pool's
        ragged.recenter_scorer(self)
        st = self._state
        self.counters["grow_e_events"] += 1
        self.counters["replayed_cols"] += int(st["clen"].max())
        # only the slots holding a branch are replayed; the others (free
        # slots, the arena's scratch) restart blank at the new width:
        # every allocation writes a slot's rows before anything reads them
        fresh = self._blank_state()
        used = self._rows(sorted(self._slot_of.values()))
        if len(used):
            D, e, rmin, er = replay_kernel.replay_rows(
                st["off"][used], st["act"][used], st["cons"][used],
                st["clen"][used], self._reads, self._rlen, self._wc,
                self._et, self._E, self._W,
            )
            for name, val in (("D", D), ("e", e), ("rmin", rmin),
                              ("er", er)):
                fresh[name][used] = val
        st.update(D=fresh["D"], e=fresh["e"], rmin=fresh["rmin"],
                  er=fresh["er"])

    def _grow_slots(self) -> None:
        self._bk.reset()
        old_b = self._B
        self._B *= 2
        pad = self._B - old_b
        for name, arr in self._state.items():
            fill = INF if name in ("D", "rmin", "er") else 0
            extra = torch.full(
                (pad,) + tuple(arr.shape[1:]), fill, dtype=arr.dtype,
                device=arr.device,
            )
            self._state[name] = torch.cat([arr, extra])
        self._free.extend(range(old_b, self._B))
        grow = lambda m, fill: np.concatenate(  # noqa: E731
            [m, np.full((pad, self._R), fill, m.dtype)]
        )
        self._off_host = grow(self._off_host, 0)
        self._act_host = grow(self._act_host, False)

    def _grow_cons(self) -> None:
        self._spec_drop()
        self._bk.reset()
        cons = self._state["cons"]
        self._C *= 2
        pad = torch.zeros(
            (cons.shape[0], self._C - cons.shape[1]), dtype=cons.dtype,
            device=cons.device,
        )
        self._state["cons"] = torch.cat([cons, pad], dim=1)

    def _alloc(self) -> Tuple[int, int]:
        if not self._free:
            self._grow_slots()
        slot = self._free.pop()
        handle = self._next_handle
        self._next_handle += 1
        self._slot_of[handle] = slot
        return handle, slot

    def live_handles(self) -> int:
        """Branch handles allocated and not yet freed (the arena's
        scratch slots are slots without handles, so they never count)."""
        return len(self._slot_of)

    def _rows(self, slots: List[int]):
        return torch.as_tensor(slots, dtype=torch.long, device=self.device)

    # -- interface -----------------------------------------------------

    def _root_slot(self, act_np: np.ndarray) -> Tuple[int, int]:
        """A slot allocated for a root over the ``[R]`` mask ``act_np``,
        its host mirrors set: ``(handle, slot)``.  The root launch is the
        caller's (``root``, or a sharded store's one call for its
        shards)."""
        handle, slot = self._alloc()
        self._off_host[slot] = 0
        self._act_host[slot] = act_np
        return handle, slot

    def _copy_slots(self, hs: List[int]):
        """Slots allocated for copies of the branches ``hs``, their host
        mirrors copied, counted as one clone call: ``(handles, srcs,
        dsts)``.  The copy launch is the caller's."""
        self.counters["clone_calls"] += 1
        srcs = [self._slot_of[h] for h in hs]
        alloc = [self._alloc() for _ in hs]
        dsts = [a[1] for a in alloc]
        self._off_host[dsts] = self._off_host[srcs]
        self._act_host[dsts] = self._act_host[srcs]
        return [a[0] for a in alloc], srcs, dsts

    def _push_slot(self, src_h: int, in_place: bool) -> Tuple[int, int, int]:
        """The slot a clone-push of ``src_h`` writes (its own when
        ``in_place``, else a new one), its host mirrors copied: ``(handle,
        src, dst)``.  The launch is the caller's."""
        src = self._slot_of[src_h]
        if in_place:
            self._spec_drop(src_h)
            handle, dst = src_h, src
        else:
            handle, dst = self._alloc()
        self._off_host[dst] = self._off_host[src]
        self._act_host[dst] = self._act_host[src]
        return handle, src, dst

    def root(self, active: np.ndarray) -> int:
        act_np = np.zeros(self._R, dtype=bool)
        act_np[: len(active)] = active
        handle, slot = self._root_slot(act_np)
        branch_kernel.root(self._state, slot, act_np, self._rlen,
                           bufs=self._bk)
        return handle

    def clone(self, h: int) -> int:
        return self.clone_many([h])[0]

    def clone_many(self, hs: List[int]) -> List[int]:
        """One batched row copy for a list of branch clones."""
        if not hs:
            return []
        handles, srcs, dsts = self._copy_slots(hs)
        branch_kernel.advance(
            self._state, [srcs, dsts, [-1] * len(hs)], self._reads,
            self._rlen, self._wc, self._et, self.num_symbols,
            with_stats=False, bufs=self._bk,
        )
        return handles

    def free(self, h: int) -> None:
        self._spec_drop(h)
        slot = self._slot_of.pop(h, None)
        if slot is not None:
            self._free.append(slot)

    def push(self, h: int, consensus: bytes) -> BranchStats:
        return self.push_many([(h, consensus)])[0]

    def push_many(self, specs: List[Tuple[int, bytes]]) -> List[BranchStats]:
        """Advance every listed branch by its appended symbol in one
        batched step; nothing commits on band overflow (the band grows
        and the step is retried)."""
        if not specs:
            return []
        self.counters["push_calls"] += 1
        for h, _c in specs:
            self._spec_drop(h)
        for _, consensus in specs:
            while len(consensus) >= self._C - 1:
                self._grow_cons()
        slots = [self._slot_of[h] for h, _ in specs]
        if len(set(slots)) != len(slots):
            raise ValueError("push_many: duplicate branch handles in batch")
        syms = [self.sym_id[consensus[-1]] for _, consensus in specs]
        rows = [(s, s, y) for s, y in zip(slots, syms)]
        return self._advance_rows(rows)

    def clone_push_many(self, specs):
        """Fused expansion: ``specs`` is a list of ``(src_handle,
        consensus_or_None, in_place)`` — clone ``src`` (or reuse its slot
        when ``in_place``) and, when a consensus is given, advance the
        copy by its last symbol.  Returns ``[(handle, stats_or_None),
        ...]`` in spec order."""
        if not specs:
            return []
        self.counters["clone_push_calls"] += 1
        for _src, consensus, _inp in specs:
            if consensus is not None:
                while len(consensus) >= self._C - 1:
                    self._grow_cons()
        rows = []
        handles = []
        for src_h, consensus, in_place in specs:
            handle, src, dst = self._push_slot(src_h, in_place)
            handles.append(handle)
            sym = -1 if consensus is None else self.sym_id[consensus[-1]]
            rows.append((src, dst, sym))
        if len({d for _, d, _ in rows}) != len(rows):
            raise ValueError("clone_push_many: duplicate destination slots")
        stats = self._advance_rows(rows)
        return [
            (h, stats[i] if specs[i][1] is not None else None)
            for i, h in enumerate(handles)
        ]

    def _advance_rows(self, rows) -> List[BranchStats]:
        """Copy slot ``src`` to slot ``dst`` advanced by ``sym`` (``-1``:
        copy only) for every ``(src, dst, sym)`` in one branch-step call;
        commits nothing while any advanced read overflows the band (grows
        it and retries).  Returns the per-row stats with the finalized
        distances bundled."""
        packed = np.ascontiguousarray(np.array(rows, dtype=np.int32).T)
        while True:
            out = branch_kernel.advance(
                self._state, packed, self._reads, self._rlen, self._wc,
                self._et, self.num_symbols, bufs=self._bk,
            )
            if not out.overflow:
                return self._stats_batch(out)
            self._grow_e()

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        self.counters["stats_calls"] += 1
        out = branch_kernel.stats(self._state, [self._slot_of[h]],
                                  self._reads, self._rlen, self.num_symbols,
                                  bufs=self._bk)
        return self._stats_np(out.eds[0], out.occ[0], out.split[0],
                              out.reached[0])

    def best_activation_offset(
        self,
        consensus: bytes,
        seq_index: int,
        offset_window: int,
        offset_compare_length: int,
        wildcard,
    ) -> int:
        """Device-batched activation-offset search (one offset scan
        scoring the whole window) with the host loop's exact
        first-best/midpoint-incumbent tie semantics; tiny problems fall
        back to the host WFA loop."""
        from waffle_con_tpu_torch.ops import replay_kernel

        seq = self.reads[seq_index]
        cmp_len = min(offset_compare_length, len(seq))
        con_len = len(consensus)
        start = max(0, con_len - (offset_window + cmp_len))
        end = max(0, con_len - cmp_len)
        n_pos = end - start
        if n_pos <= 1 or cmp_len * n_pos < 512:
            return find_activation_offset(
                consensus, seq, offset_window, offset_compare_length,
                wildcard,
            )
        M = _next_pow2(cmp_len)
        P = _next_pow2(n_pos)
        # window (sentinel -2) and head (sentinel -3) in one upload
        buf = np.full(P + 3 * M, -2, dtype=np.int32)
        tail = consensus[start : min(con_len, start + P + 2 * M)]
        buf[: len(tail)] = [self.sym_id[b] for b in tail]
        buf[P + 2 * M :] = -3
        buf[P + 2 * M : P + 2 * M + cmp_len] = [
            self.sym_id[b] for b in seq[:cmp_len]
        ]
        self.counters["offset_scan_calls"] += 1
        dev = torch.from_numpy(buf).to(self.device)
        eds = replay_kernel.offset_scan(
            dev[: P + 2 * M], dev[P + 2 * M :].view(1, M), cmp_len, self._wc,
            P, M, self.num_symbols,
        )[0].cpu().numpy()
        best_offset = max(0, con_len - (cmp_len + offset_window // 2))
        min_ed = int(eds[best_offset - start])
        for p in range(n_pos):
            if int(eds[p]) < min_ed:
                min_ed = int(eds[p])
                best_offset = start + p
        return best_offset

    def activate(
        self, h: int, read_index: int, offset: int, consensus: bytes
    ) -> None:
        """Track ``read_index`` from consensus offset ``offset``: a fresh
        column at ``j == offset``, caught up through the branch's recorded
        consensus in one column-replay launch on a CUDA device (band
        overflow commits nothing, grows the band and retries)."""
        from waffle_con_tpu_torch.ops import replay_kernel

        self.counters["activate_calls"] += 1
        self._spec_drop(h)
        slot = self._slot_of[h]
        self._off_host[slot, read_index] = offset
        self._act_host[slot, read_index] = True
        while replay_kernel.activate_row(
            self._state, slot, read_index, offset, self._reads, self._rlen,
            self._wc, self._et,
        ):
            self._grow_e()

    def deactivate(self, h: int, read_index: int) -> None:
        self.deactivate_many([(h, read_index)])

    def deactivate_many(self, pairs) -> None:
        if not pairs:
            return
        for h, _r in pairs:
            self._spec_drop(h)
        slots = [self._slot_of[h] for h, _ in pairs]
        ridx = [r for _, r in pairs]
        self._act_host[slots, ridx] = False
        branch_kernel.deactivate(self._state, [slots, ridx], bufs=self._bk)

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        self.counters["finalize_calls"] += 1
        slot = self._slot_of[h]
        while True:
            fin, ovf = branch_kernel.finalize(self._state, [slot],
                                              self._reads, self._rlen,
                                              bufs=self._bk)
            if not ovf[0]:
                return fin[0, : self.num_reads].astype(np.int64)
            self._grow_e()

    def _fit_steps(self, longest: int, max_steps: int) -> int:
        """Grow the consensus buffer for a run of ``max_steps`` from a
        consensus of ``longest`` symbols and return the step count the
        run may take: the symbol-buffer bucket and step cap of the fused
        run (the JAX package's pallas geometry rule, kept so capacities
        match)."""
        while longest + max_steps + 2 >= self._C:
            self._grow_cons()
        ms = _next_pow2(min(max_steps, RUN_MS_CAP - 2) + 2, 256)
        while longest + ms + 2 >= self._C:
            self._grow_cons()
        return min(max_steps, ms - 2)

    def run_args(
        self,
        consensus_len: int,
        me_budget: int,
        other_cost: int,
        other_len: int,
        min_count: int,
        l2: bool,
        max_steps: int,
        first_sym: int = -1,
        allow_records: bool = True,
    ):
        """The :class:`~waffle_con_tpu_torch.ops.run_kernel.RunArgs` of a
        :meth:`run_extend` call from a consensus of ``consensus_len``
        symbols (the consensus buffer grown to fit)."""
        from waffle_con_tpu_torch.ops import run_kernel

        return run_kernel.RunArgs(
            me_budget=min(int(me_budget), 2**31 - 1),
            other_cost=min(int(other_cost), 2**31 - 1),
            other_len=int(other_len),
            min_count=int(min_count),
            l2=bool(l2),
            max_steps=int(self._fit_steps(consensus_len, max_steps)),
            first_sym=int(first_sym),
            allow_records=bool(allow_records),
            wc=self._wc,
            et=self._et,
            a_real=self.num_symbols,
        )

    def dual_run_args(
        self,
        longest: int,
        me_budget: int,
        other_cost: int,
        other_len: int,
        min_count: int,
        ed_delta: int,
        imb_min: int,
        l2: bool,
        weighted: bool,
        max_steps: int,
        lock1: bool = False,
        lock2: bool = False,
        allow_records: bool = True,
        rec_min: int | None = None,
        mc_tab: np.ndarray | None = None,
        imb_tab: np.ndarray | None = None,
        mc_dyn: bool = False,
    ):
        """``(DualRunArgs, mc_tab, imb_tab)`` of a :meth:`run_extend_dual`
        call whose longer consensus has ``longest`` symbols: the consensus
        buffer grown to fit, the default tables, and both tables padded
        as ``JaxScorer`` pads them, on the store's device."""
        from waffle_con_tpu_torch.ops import run_dual_kernel

        if mc_tab is None:
            mc_tab = np.full(self._R + 1, min_count, dtype=np.int32)
        mc_tab = _pad_len_table(mc_tab, self._R + 1)
        if imb_tab is None:
            imb_tab = np.full(8, imb_min, dtype=np.int32)
        imb_tab = _pad_len_table(imb_tab, longest + max_steps + 2)
        args = run_dual_kernel.DualRunArgs(
            me_budget=min(int(me_budget), 2**31 - 1),
            other_cost=min(int(other_cost), 2**31 - 1),
            other_len=int(other_len),
            delta=int(ed_delta),
            l2=bool(l2),
            weighted=bool(weighted),
            max_steps=int(self._fit_steps(longest, max_steps)),
            lock1=bool(lock1),
            lock2=bool(lock2),
            allow_records=bool(allow_records),
            rec_min=int(min_count if rec_min is None else rec_min),
            mc_dyn=bool(mc_dyn),
            wc=self._wc,
            et=self._et,
            a_real=self.num_symbols,
        )
        tab = lambda t: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(t, dtype=np.int32)
        ).to(self.device)
        return args, tab(mc_tab), tab(imb_tab)

    def run_extend(
        self,
        h: int,
        consensus: bytes,
        me_budget: int,
        other_cost: int,
        other_len: int,
        min_count: int,
        l2: bool,
        max_steps: int,
        first_sym: int = -1,
        allow_records: bool = True,
    ) -> Tuple[int, int, bytes, BranchStats, list]:
        """Device-side unambiguous-run extension of branch ``h``; returns
        ``(steps_committed, stop_code, appended_bytes, stats, records)``
        with ``stats`` the snapshot at the stopped position (its ``fin``
        the finalized distances there, ``None`` when out of band) and
        ``records`` the absorbed reached-state snapshots ``[(step,
        fin_eds), ...]`` in commit order.  ``first_sym`` (a dense id, or
        -1) force-pushes the host's already-nominated child as step 0.
        On band overflow (code 5) the band is grown so the caller can
        simply continue."""
        from waffle_con_tpu_torch.ops import run_kernel

        inj = ragged.take_injected(self, h)
        if isinstance(inj, ragged._GangFailure):
            # the serving pool's launch of this call failed: fail the call
            raise inj.error
        served = inj is not None and not isinstance(inj, ragged._SpecInjected)
        used = served
        if inj is not None and not served:
            # a frontier-gang deposit: the slot was not advanced at gang
            # time, so a deposit that does not validate against the real
            # call is dropped and the run below starts from the slot
            used = self._spec_consume(
                inj, h, consensus, me_budget, other_cost, other_len,
                min_count, l2, max_steps, first_sym,
            )
            key = "run_gang_injected" if used else "run_gang_mispredict"
            self.counters[key] = self.counters.get(key, 0) + 1
        if served:
            # the serving pool ran this very call in a gang launch and
            # advanced the slot; its result is returned as the run's
            if inj.len0 != len(consensus):
                raise RuntimeError(
                    "serving-pool deposit out of step: made at consensus "
                    f"length {inj.len0}, called at {len(consensus)}")
            key = "run_ragged_injected"
            self.counters[key] = self.counters.get(key, 0) + 1
            rec = _phases.current()
            if rec is not None:
                # the device work happened in the group's own record
                rec.annotate(kernel="ragged", k=1, geom=self._geom_bucket())
        if used:
            steps, code, syms = inj.steps, inj.code, inj.ids[: inj.steps]
            stats, records = self._stats_np(*inj.stats), []
        else:
            args = self.run_args(
                len(consensus), me_budget, other_cost, other_len, min_count,
                l2, max_steps, first_sym, allow_records,
            )
            rec = _phases.current()
            if rec is not None:
                rec.annotate(kernel="solo", k=1, geom=self._geom_bucket())
            with _phases.device_scope(rec, self.device):
                out, rec_steps, rec_fins = self._run_launch(
                    self._slot_of[h], args)
            with _phases.transfer_scope(rec):
                res, rsteps, rfins = run_kernel.fetch(
                    out, rec_steps, rec_fins, self._R, self.num_symbols,
                    args.max_steps,
                )
            steps, code, syms = res.steps, res.code, res.syms
            n = self.num_reads
            records = [
                (int(rsteps[i]), rfins[i, :n].astype(np.int64))
                for i in range(res.rec_count)
            ]
            stats = self._stats_np(
                res.eds, res.occ, res.split, res.reached,
                None if res.fin_ovf else res.fin,
            )
        self.counters["run_calls"] += 1
        self.counters["run_steps"] += steps
        key = f"run_stop_{code}"
        self.counters[key] = self.counters.get(key, 0) + 1
        appended = b""
        if steps:
            appended = self.symtab[syms].astype(np.uint8).tobytes()
        if code == 5:
            self._grow_e()
        return steps, code, appended, stats, records

    # -- the run paths' launches and host mirrors (a read-sharded store,
    # ops/sharded_scorer.py, shares the run paths above and below and
    # brings its own of these) ----------------------------------------

    def _run_launch(self, slot: int, args):
        """One run of slot ``slot`` (``run_kernel.run_extend``)."""
        from waffle_con_tpu_torch.ops import run_kernel

        return run_kernel.run_extend(self._state, slot, self._reads,
                                     self._rlen, args)

    def _dual_launch(self, s1: int, s2: int, mc_tab, imb_tab, args):
        """One dual run of slots ``s1``, ``s2``
        (``run_dual_kernel.run_extend_dual``)."""
        from waffle_con_tpu_torch.ops import run_dual_kernel

        return run_dual_kernel.run_extend_dual(
            self._state, s1, s2, self._reads, self._rlen, mc_tab, imb_tab,
            args)

    def _arena_launch(self, slots, kinds, lc, pc, tr, mc_tab, imb_tab,
                      args):
        """One arena call over ``slots`` (``arena_kernel.arena``)."""
        from waffle_con_tpu_torch.ops import arena_kernel

        return arena_kernel.arena(self._state, self._reads, self._rlen,
                                  slots, kinds, lc, pc, tr, mc_tab, imb_tab,
                                  args)

    def _set_act_host(self, slot: int, act) -> None:
        """The host mirror of slot ``slot``'s active reads (``[R]``)."""
        self._act_host[slot] = act

    def _copy_off_host(self, dst: int, src: int) -> None:
        """Slot ``src``'s host mirror of the read offsets into ``dst``'s."""
        self._off_host[dst] = self._off_host[src]

    # -- the frontier gang's deposits -------------------------------------

    def ragged_run_probe(self, h: int):
        """``(self, h)`` when branch ``h`` of this store can join a gang
        (the serving pool's or the frontier gang), else None (no such
        branch); the pool still checks eligibility against the call."""
        if h not in self._slot_of:
            return None
        return (self, h)

    def ragged_release(self) -> None:
        """Release this store's serving-pool residency (a no-op when it
        has none) and drop its pending deposits; the supervisor calls it
        before it swaps backends."""
        ragged.release_scorer(self)

    def _geom_bucket(self) -> str:
        """Geometry label of phase records: slots x reads x band width."""
        return f"B{self._B}R{self._R}W{self._W}"

    def _spec_drop(self, h: int | None = None) -> None:
        """Invalidate pending gang deposits: branch ``h``'s when its slot
        is about to change outside the speculated run, or every one when
        the geometry grows (the held rows have the old geometry).  Slot
        growth copies every slot as it is, so it keeps them."""
        gang = self._frontier_gang
        if gang is not None:
            if h is None:
                gang.drop_all()
            else:
                gang.drop(h)

    def _spec_consume(self, inj, h: int, consensus: bytes, me_budget: int,
                      other_cost: int, other_len: int, min_count: int,
                      l2: bool, max_steps: int, first_sym: int) -> bool:
        """Validate a speculative gang deposit against the real
        ``run_extend`` arguments; on success copy its post-run rows into
        the slot and return True.

        Inside the run only the vote decisions, pure functions of the band
        state and the search constants, choose what commits; the per-call
        arguments (budget, the competing pop, the step cap) only decide
        where the run stops, and stopping earlier than the real call would
        is exact (the engine re-pops and goes on).  So the deposit is
        usable when the real call would have committed at least its
        steps: the same consensus length, forced symbol, ``min_count`` and
        cost model, ``steps <= max_steps``, and, past a forced first step
        (which only band overflow refuses), either the speculated (budget,
        other cost, other length) equal to the real ones (a budget may
        also differ when every state fit the real one) or a final cost
        within the real budget that still wins the real competitor's pop:
        costs never fall over a run, so that bounds every check the real
        call would have made.  Records need no check: the gang stops at a
        reached state, an early stop."""
        if inj.len0 != len(consensus):
            return False
        if inj.first_sym != int(first_sym):
            return False
        if inj.min_count != int(min_count) or inj.l2 != bool(l2):
            return False
        if inj.steps > int(max_steps):
            return False
        a = 1 if inj.first_sym >= 0 else 0
        if inj.steps > a:
            me = min(int(me_budget), 2**31 - 1)
            oc = min(int(other_cost), 2**31 - 1)
            args_equal = (
                inj.other_cost == oc
                and inj.other_len == int(other_len)
                and (inj.me_budget == me or inj.final_cost <= me)
            )
            if not args_equal:
                if inj.final_cost > me:
                    return False
                if not (inj.final_cost < oc or (
                        inj.final_cost == oc
                        and inj.len0 + a > int(other_len))):
                    return False
        dep, g = inj.post
        slot = self._slot_of[h]
        st = self._state
        for name in ("D", "e", "rmin", "er"):
            st[name][slot] = dep[name][g]
        end = inj.len0 + inj.steps
        st["cons"][slot, inj.len0:end] = dep["cons"][g, inj.len0:end]
        st["clen"][slot] = end
        return True

    # -- launch planners' answers --------------------------------------

    def _takes(self, kind: str, planner, *shape) -> bool:
        """Whether the kernel ``kind`` takes ``shape`` on this store's
        device (a refusal counts ``plan_refused_<kind>``)."""
        if not planner_refuses(self.device, planner, *shape):
            return True
        key = f"plan_refused_{kind}"
        self.counters[key] = self.counters.get(key, 0) + 1
        return False

    def run_takes(self) -> bool:
        """Whether :meth:`run_extend` may launch at the store's shape."""
        from waffle_con_tpu_torch.ops.run_kernel import plan_run

        return self._takes("run", plan_run, self._R, self._W,
                           self.num_symbols)

    def run_dual_takes(self) -> bool:
        """Whether :meth:`run_extend_dual` may launch at the store's
        shape."""
        from waffle_con_tpu_torch.ops.run_dual_kernel import plan_run_dual

        return self._takes("run_dual", plan_run_dual, self._R, self._W,
                           self.num_symbols)

    def arena_takes(self, Lw: int) -> bool:
        """Whether :meth:`run_arena` may launch at the store's shape with
        tracker windows of ``Lw`` lengths."""
        from waffle_con_tpu_torch.ops.arena_kernel import plan_arena

        return self._takes("arena", plan_arena, self.ARENA_K, self._R,
                           self._W, self.num_symbols, Lw, self._C)

    def run_extend_dual(
        self,
        h1: int,
        h2: int,
        consensus1: bytes,
        consensus2: bytes,
        me_budget: int,
        other_cost: int,
        other_len: int,
        min_count: int,
        ed_delta: int,
        imb_min: int,
        l2: bool,
        weighted: bool,
        max_steps: int,
        lock1: bool = False,
        lock2: bool = False,
        allow_records: bool = True,
        rec_min: int | None = None,
        mc_tab: np.ndarray | None = None,
        imb_tab: np.ndarray | None = None,
        mc_dyn: bool = False,
    ):
        """Device-side dual-node extension: both branches step together,
        with divergence pruning on device.  Returns ``(steps, stop_code,
        appended1, appended2, stats1, stats2, active1, active2,
        records)`` with ``records`` the absorbed reached-state snapshots
        ``[(step, fin1, fin2, act1, act2), ...]`` in commit order.  A
        locked side is frozen.  ``mc_tab`` / ``imb_tab`` default to
        constant ``min_count`` / ``imb_min`` tables (the ``min_af == 0``
        semantics).  On band overflow (code 5) the band is grown so the
        caller can simply continue."""
        from waffle_con_tpu_torch.ops import run_dual_kernel

        self._spec_drop(h1)
        self._spec_drop(h2)
        s1 = self._slot_of[h1]
        s2 = self._slot_of[h2]
        args, mc_t, imb_t = self.dual_run_args(
            max(len(consensus1), len(consensus2)), me_budget, other_cost,
            other_len, min_count, ed_delta, imb_min, l2, weighted, max_steps,
            lock1, lock2, allow_records, rec_min, mc_tab, imb_tab, mc_dyn,
        )
        max_steps = args.max_steps
        rec = _phases.current()
        if rec is not None:
            rec.annotate(kernel="dual", k=1, geom=self._geom_bucket())
        with _phases.device_scope(rec, self.device):
            out = self._dual_launch(s1, s2, mc_t, imb_t, args)
        with _phases.transfer_scope(rec):
            res, rsteps, rplanes = run_dual_kernel.fetch(
                *out, self._R, self.num_symbols, max_steps
            )
        steps, code = res.steps, res.code
        self.counters["run_dual_calls"] += 1
        self.counters["run_dual_steps"] += steps
        key = f"run_dual_stop_{code}"
        self.counters[key] = self.counters.get(key, 0) + 1

        def appended(side, locked):
            if not steps or locked:
                return b""
            return self.symtab[res.syms[side][:steps]].astype(np.uint8).tobytes()

        n = self.num_reads
        records = [
            (
                int(rsteps[i]),
                rplanes[0, i, :n].astype(np.int64),
                rplanes[1, i, :n].astype(np.int64),
                rplanes[2, i, :n].astype(bool),
                rplanes[3, i, :n].astype(bool),
            )
            for i in range(res.rec_count)
        ]
        # divergence pruning deactivates reads on the device: keep the
        # host mirror exact, or later activations are mis-routed
        self._set_act_host(s1, res.act[0])
        self._set_act_host(s2, res.act[1])
        if code == 5:
            self._grow_e()
        stats = [
            self._stats_np(res.eds[k], res.occ[k], res.split[k],
                           res.reached[k])
            for k in (0, 1)
        ]
        return (
            steps, code, appended(0, lock1), appended(1, lock2),
            stats[0], stats[1], res.act[0][:n], res.act[1][:n], records,
        )

    # -- the K-node pop arena -------------------------------------------

    #: ceiling of the arena's history (events per call)
    ARENA_CAP_MAX = 2048
    #: node capacity of the arena
    ARENA_K = 64
    #: competitors the engines hand in at most, reserving node slots for
    #: the creation pool
    ARENA_TAKE_MAX = ARENA_K - 1 - 16
    #: children one split event may create on the device
    ARENA_CRE_PER_EVENT = CRE_PER_EVENT
    #: creation pool nodes offered per arena call
    ARENA_POOL = 36

    @property
    def ARENA_CAP(self) -> int:
        """History capacity of one arena call, sized to the read length
        as ``JaxScorer`` sizes it."""
        return min(self.ARENA_CAP_MAX, max(512, _next_pow2(self._L)))

    def _scratch_reset(self) -> None:
        self._scratch_next = 0

    def _scratch_slot(self) -> int:
        """A slot backing an arena side no node owns (side 2 of a single
        node, both sides of a padding node): ``2 * ARENA_K`` slots taken
        from the store at the first use, in ``JaxScorer``'s order, kept
        for the scorer's life and never given a handle, so
        :meth:`live_handles` does not count them."""
        if not hasattr(self, "_scratch"):
            self._scratch = []
            for _ in range(2 * self.ARENA_K):
                if not self._free:
                    self._grow_slots()
                self._scratch.append(self._free.pop())
        slot = self._scratch[self._scratch_next]
        self._scratch_next += 1
        return slot

    def run_arena(
        self,
        node_specs,
        me_budget: int,
        min_count: int,
        ed_delta: int,
        imb_min: int,
        l2: bool,
        weighted: bool,
        rest_cost: int,
        rest_len: int,
        max_queue_size: int,
        capacity_per_size: int,
        step_limit: int,
        max_nodes_wo_constraint: int,
        lc: np.ndarray,
        pc: np.ndarray,
        tr_scalars: np.ndarray,
        create_mode: int = 0,
        mc_tab: np.ndarray | None = None,
        imb_tab: np.ndarray | None = None,
        split_relax: bool = True,
        mc_dyn: bool = False,
    ):
        """K-node pop arena (:mod:`~waffle_con_tpu_torch.ops.arena_kernel`)
        over ``node_specs`` ``[(h1, h2 or None, len1, len2), ...]`` (1 ..
        ``ARENA_K`` nodes; node 0 the engine's in-hand pop, later nodes
        in their queue pop order).  ``lc``/``pc`` ``[2, Lw]`` and
        ``tr_scalars`` ``[2, 4]`` (threshold, total, farthest, last
        constraint) are the single and dual trackers.  Returns
        ``(events, nsteps, code, stop_node, per_node_steps,
        per_side_appended, per_side_stats, per_side_act, alive,
        creations)`` as ``JaxScorer.run_arena`` does: sides flattened as
        ``[n0s1, n0s2, n1s1, ...]`` (None where no node owns the side),
        ``events`` the history as ``("commit", node)`` / ``("discard",
        node)`` / ``("split", node)`` / ``("create", rec)``, and
        ``creations[j]`` child ``len(node_specs) + j`` as a dict with
        ``parent``, ``kind``, ``sym1``/``sym2`` (bytes; ``sym2`` None for
        a single child), ``created_len`` and fresh handles ``h1``/``h2``.
        On band overflow (code 5) the band is grown."""
        from waffle_con_tpu_torch.ops import arena_kernel

        K = self.ARENA_K
        n_live = len(node_specs)
        if not 1 <= n_live <= K:
            raise ValueError("arena takes 1..ARENA_K nodes")
        for h1, h2, _l1, _l2 in node_specs:
            self._spec_drop(h1)
            if h2 is not None:
                self._spec_drop(h2)
        kinds = []
        slots = []
        live_sides = []
        self._scratch_reset()
        for h1, h2, _l1, _l2 in node_specs:
            kinds.append(1 if h2 is not None else 0)
            live_sides.append(len(slots))
            slots.append(self._slot_of[h1])
            if h2 is not None:
                live_sides.append(len(slots))
                slots.append(self._slot_of[h2])
            else:
                slots.append(self._scratch_slot())
        # creation pool: real slot pairs the arena may turn into children
        n_pool = min(self.ARENA_POOL, K - n_live) if create_mode else 0
        pool_pairs = [(self._alloc(), self._alloc()) for _ in range(n_pool)]
        for (_h1p, s1p), (_h2p, s2p) in pool_pairs:
            kinds.append(-1)
            slots += [s1p, s2p]
        for _ in range(K - n_live - n_pool):
            kinds.append(-1)
            slots += [self._scratch_slot(), self._scratch_slot()]
        if len(set(slots)) != 2 * K:
            raise ValueError("arena requires distinct state slots")
        step_limit = min(step_limit, self.ARENA_CAP)
        max_len = max(max(s[2], s[3]) for s in node_specs)
        while max_len + step_limit + 2 >= self._C:
            self._grow_cons()
        if mc_tab is None:
            mc_tab = np.full(self._R + 1, min_count, dtype=np.int32)
        mc_tab = _pad_len_table(mc_tab, self._R + 1)
        if imb_tab is None:
            imb_tab = np.full(8, imb_min, dtype=np.int32)
        imb_tab = _pad_len_table(imb_tab, max_len + step_limit + 2)
        args = arena_kernel.ArenaArgs(
            me_budget=min(int(me_budget), 2**31 - 1),
            min_count=int(min_count), delta=int(ed_delta), l2=bool(l2),
            weighted=bool(weighted),
            rest_cost=min(int(rest_cost), 2**31 - 1),
            rest_len=int(rest_len), n_live=n_live,
            max_queue=int(max_queue_size), cap=int(capacity_per_size),
            step_limit=int(step_limit),
            max_nwc=int(max_nodes_wo_constraint),
            create_mode=int(create_mode), n_pool=n_pool,
            relax=bool(split_relax), mc_dyn=bool(mc_dyn), wc=self._wc,
            et=self._et, a_real=self.num_symbols, max_steps=self.ARENA_CAP,
        )
        rec = _phases.current()
        if rec is not None:
            rec.annotate(kernel="arena", k=1, geom=self._geom_bucket())
        with _phases.device_scope(rec, self.device):
            out = self._arena_launch(
                slots, kinds, lc, pc, np.asarray(tr_scalars).reshape(2, 4),
                mc_tab, imb_tab, args)
        with _phases.transfer_scope(rec):
            res = arena_kernel.fetch(out, K, self._R, self.num_symbols,
                                     args.max_steps)
        nsteps, code, cre_count = res.nsteps, res.code, res.cre_count
        c = self.counters
        if code == 1:
            # why the stopping winner's split was not absorbed: its child
            # count and the gate flags
            key = f"arena_s1_nc{res.stop_diag // 64}_f{res.stop_diag % 64:02d}"
            c[key] = c.get(key, 0) + 1

        events = []
        for v in res.hist[:nsteps]:
            v = int(v)
            kind = ("commit", "discard", "split", "create")[min(v // K, 3)]
            events.append((kind, v - K * min(v // K, 3)))

        # creation records -> children with registered handles; unused
        # pool pairs (and the side-2 slot of single children) go back
        creations = []
        for j in range(cre_count):
            (h1p, _s1p), (h2p, _s2p) = pool_pairs[j]
            kind_j = int(res.cre[1, j])
            creations.append({
                "parent": int(res.cre[0, j]),
                "kind": kind_j,
                "sym1": int(self.symtab[int(res.cre[2, j])]),
                "sym2": (int(self.symtab[int(res.cre[3, j])])
                         if kind_j == 1 else None),
                "created_len": int(res.cre[4, j]),
                "h1": h1p,
                "h2": h2p if kind_j == 1 else None,
            })
            if kind_j == 0:
                self.free(h2p)
        for j in range(cre_count, n_pool):
            (h1p, _), (h2p, _) = pool_pairs[j]
            self.free(h1p)
            self.free(h2p)

        c["arena_calls"] += 1
        c["arena_steps"] = c.get("arena_steps", 0) + nsteps
        key = f"arena_stop_{code}"
        c[key] = c.get(key, 0) + 1
        n_disc = int(np.count_nonzero(~res.alive[: n_live + cre_count]))
        if n_disc:
            c["arena_discards"] = c.get("arena_discards", 0) + n_disc
        if cre_count:
            c["arena_creations"] = c.get("arena_creations", 0) + cre_count
            c["arena_split_events"] = c.get("arena_split_events", 0) + sum(
                1 for kind, _ in events if kind == "split")
        # divergence pruning deactivates reads on the device: mirror it
        for side in live_sides:
            self._set_act_host(slots[side], res.act[side])

        # per-node (kind, first length of side 1, of side 2), children too
        eff = [(kinds[i], node_specs[i][2], node_specs[i][3])
               for i in range(n_live)]
        for j, cre in enumerate(creations):
            eff.append((cre["kind"], cre["created_len"], cre["created_len"]))
            # host mirrors of the consumed pool slots
            p = cre["parent"]
            p1s = slots[2 * p]
            src2 = slots[2 * p + (1 if eff[p][0] == 1 else 0)]
            c1s = slots[2 * (n_live + j)]
            self._copy_off_host(c1s, p1s)
            self._set_act_host(c1s, res.act[2 * (n_live + j)])
            if cre["kind"] == 1:
                c2s = slots[2 * (n_live + j) + 1]
                self._copy_off_host(c2s, src2)
                self._set_act_host(c2s, res.act[2 * (n_live + j) + 1])

        # each side's appended symbols: its node's commit events in order
        n_nodes = n_live + cre_count
        syms = [[] for _ in range(2 * K)]
        for i, (kind, node) in enumerate(events):
            if kind == "commit":
                syms[2 * node].append(res.evsym[i, 0])
                syms[2 * node + 1].append(res.evsym[i, 1])
        appended, sides_stats, sides_act = [], [], []
        n = self.num_reads
        for f in range(2 * K):
            node = f // 2
            if node >= n_nodes or (f % 2 == 1 and eff[node][0] == 0):
                appended.append(None)
                sides_stats.append(None)
                sides_act.append(None)
                continue
            ids = np.asarray(syms[f], dtype=np.int64)
            appended.append(self.symtab[ids].astype(np.uint8).tobytes())
            sides_stats.append(self._stats_np(
                res.eds[f], res.occ[f], res.split[f], res.reached[f]))
            sides_act.append(res.act[f, :n])
        if code == 5:
            self._grow_e()
        return (
            events, nsteps, code, res.stop_node,
            [int(s) for s in res.steps], appended, sides_stats, sides_act,
            [bool(a) for a in res.alive], creations,
        )

    # -----------------------------------------------------------------

    def _stats_batch(self, out) -> List[BranchStats]:
        """A batch's ``BranchOut`` (``ops/branch_kernel.py``) -> one
        :class:`BranchStats` a row (read padding sliced away, the
        finalized distances where they are in the band): each field is
        converted once for the batch (no copy where it is int64 already;
        the kernel's int32 views of the pinned output are copied once) and
        each row is a view of it."""
        n = self.num_reads
        eds, occ, split, fin = (x[:, :n].astype(np.int64, copy=False)
                                for x in (out.eds, out.occ, out.split,
                                          out.fin))
        return [
            BranchStats(e, o, s, r, f if ok else None)
            for e, o, s, r, f, ok in zip(eds, occ, split,
                                         out.reached[:, :n], fin,
                                         out.fin_ok.tolist())
        ]

    def _stats_np(self, eds, occ, split, reached, fin=None) -> BranchStats:
        """Host arrays -> :class:`BranchStats`, slicing read padding
        away."""
        n = self.num_reads
        return BranchStats(
            eds[:n].astype(np.int64),
            occ[:n].astype(np.int64),
            split[:n].astype(np.int64),
            reached[:n].astype(bool),
            None if fin is None else fin[:n].astype(np.int64),
        )


# the branch life-cycle calls' kernels and twins, which build on this
# module's column primitives (so imported after them)
from waffle_con_tpu_torch.ops import branch_kernel  # noqa: E402
