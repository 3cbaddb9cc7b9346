"""Read-sharded branch store: one search's reads split over the devices
of a mesh, each shard a ``TorchScorer`` of its own.

The counterpart of ``waffle_con_tpu``'s read-sharded ``JaxScorer``
(``parallel/mesh.py`` ``shard_scorer``: the scorer's state placed with a
``NamedSharding`` over the read axis, every kernel partitioned by
GSPMD).  Here one process holds the shards (single-controller, as the
reference is): every store call runs on each shard in mesh order, and
what crosses shards is merged on the host in read order, or, for a
column step's three scalars, added in shard order on the mesh's first
device (:func:`reduce_partials`).  A mesh may list one device more than
once: the shards then share it.

Every shard has the geometry of the whole store (:class:`StoreGeometry`):
one symbol table, one read-buffer length ``L``, one consensus capacity
``C``, one band half-width ``E``, and exactly ``R / n`` rows, the padded
read count ``R`` (a power of two of at least 16, as ``TorchScorer``
pads it) rounded up to a multiple of the shard count as ``JaxScorer``
rounds it.  Shard ``k`` holds reads ``k R/n .. (k+1) R/n - 1``; rows
past the last read are inactive padding.  Slots and handles are
allocated on every shard in lockstep, so a handle names the same slot
on each.

A column step of a shard is one call of ``csrc/branch_step.cu``
(:func:`shard_step`, counted in ``shard_step.launches``); no shard
commits while any shard's reads overflow the band: a shard that did
commit goes back to the step's consensus length, every shard's band
grows and is replayed from that one consensus, and the step is retried.
A late read's offset scan and activation run on its own shard; a band
growth replays every shard.  The store exposes no run, dual-run, arena
or gang path: each would need an exchange between shards at every step,
so the engines take their per-pop expand path (:class:`FastPaths`),
which is exact.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.ops import branch_kernel, replay_kernel
from waffle_con_tpu_torch.ops.branch_kernel import BranchOut
from waffle_con_tpu_torch.ops.scorer import BranchStats, WavefrontScorer
from waffle_con_tpu_torch.ops.torch_scorer import (
    StoreGeometry,
    TorchScorer,
    _next_pow2,
)


def shard_step(state, rows, reads, rlen, wc: int, et: bool,
               num_symbols: int, bufs=None, force: bool = False,
               partials: bool = False, plain: bool = False):
    """One column step (rows ``(src, dst, sym)``) of one read shard's
    store: one call of ``csrc/branch_step.cu`` on a CUDA device
    (``branch_kernel.advance_cuda``, counted in ``shard_step.launches``),
    ``advance_plain`` on the CPU or with ``plain``.  ``force`` commits
    an overflowing batch; with ``partials`` the shard's partials come
    back as an int32 ``[3]`` tensor on the store's device (the active
    reads' edit-distance sum, any read reached, any pushed read
    overflowed: the kernel's, or :func:`partials_plain`).  Returns
    ``(BranchOut, partials or None)``."""
    dev = state["D"].device
    if not plain and branch_kernel._on_cuda(state["D"]):
        part = (torch.empty(3, dtype=torch.int32, device=dev)
                if partials else None)
        out = branch_kernel.advance_cuda(state, rows, reads, rlen, wc, et,
                                         num_symbols, bufs=bufs,
                                         force=force, part=part)
        shard_step.launches += 1
        return out, part
    out = branch_kernel.advance_plain(state, rows, reads, rlen, wc, et,
                                      num_symbols, force=force)
    return out, partials_plain(out, dev) if partials else None


shard_step.launches = 0


def partials_plain(out: BranchOut, device) -> torch.Tensor:
    """The partials of a step from its host stats (the twin of the
    kernel's ``part`` words): ``[sum of eds, any reached, overflow]``."""
    partials_plain.calls += 1
    return torch.tensor(
        [int(out.eds.sum(dtype=np.int64)), int(out.reached.any()),
         int(out.overflow)], dtype=torch.int32, device=device)


partials_plain.calls = 0


def reduce_partials(parts: Sequence[torch.Tensor], device):
    """The shards' partials added in shard order on ``device`` (the
    mesh's first): a peer copy where a shard lives on another device, a
    plain add where it is the same.  Returns ``(total, reached_any,
    overflow)`` as 0-d tensors on ``device``."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc[0], acc[1] > 0, acc[2] > 0


def merge_outs(outs: Sequence[BranchOut]) -> BranchOut:
    """The shards' outputs of one call as one, per-read fields in read
    order (shard after shard), ``fin_ok`` AND-ed, ``overflow`` OR-ed."""
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


class ShardedScorer(WavefrontScorer):
    """A branch store whose reads are split over ``devices`` (in mesh
    order; a device may repeat), built by
    :func:`waffle_con_tpu_torch.parallel.mesh.shard_scorer`."""

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig,
                 devices: Sequence) -> None:
        super().__init__(reads, config)
        self.devices = tuple(torch.device(d) for d in devices)
        n = len(self.devices)
        if n < 1:
            raise ValueError("a sharded store needs at least one device")
        R = max(_next_pow2(max(self.num_reads, 1)), TorchScorer.MIN_R)
        self._R = n * -(-R // n)
        self._Rs = self._R // n
        max_len = max((len(r) for r in self.reads), default=1)
        L = max(_next_pow2(max(max_len, 1)), TorchScorer.MIN_L)
        C = max(_next_pow2(max_len + 64), TorchScorer.MIN_C)
        Rs = self._Rs
        self.shards = [
            TorchScorer(self.reads[k * Rs:(k + 1) * Rs], config,
                        StoreGeometry(dev, Rs, L, C, self.symtab))
            for k, dev in enumerate(self.devices)
        ]
        self.device = self.devices[0]
        #: the card is switched before each shard's call only when the
        #: shards span more than one CUDA device
        cards = {d for d in self.devices if d.type == "cuda"}
        self._switch = len(cards) > 1
        self.counters = {
            "push_calls": 0,
            "stats_calls": 0,
            "clone_calls": 0,
            "clone_push_calls": 0,
            "activate_calls": 0,
            "finalize_calls": 0,
            "grow_e_events": 0,
            "replayed_cols": 0,
            "offset_scan_calls": 0,
            "shard_overflow_rollbacks": 0,
        }

    # -- geometry and placement ----------------------------------------

    @property
    def _E(self) -> int:
        return self.shards[0]._E

    @property
    def _C(self) -> int:
        return self.shards[0]._C

    @property
    def _off_host(self) -> np.ndarray:
        """``[B, R]`` host mirror of every slot's read offsets."""
        return np.concatenate([sh._off_host for sh in self.shards], axis=1)

    @property
    def _act_host(self) -> np.ndarray:
        """``[B, R]`` host mirror of every slot's active reads."""
        return np.concatenate([sh._act_host for sh in self.shards], axis=1)

    def _on(self, sh):
        """The shard's card made current (only where the shards span
        several cards)."""
        if self._switch and sh.device.type == "cuda":
            return torch.cuda.device(sh.device)
        return contextlib.nullcontext()

    def _locate(self, read_index: int) -> Tuple[TorchScorer, int]:
        k, local = divmod(int(read_index), self._Rs)
        return self.shards[k], local

    def _slot(self, h: int) -> int:
        return self.shards[0]._slot_of[h]

    @staticmethod
    def _same(values):
        if any(v != values[0] for v in values[1:]):
            raise RuntimeError(f"shards out of lockstep: {values}")
        return values[0]

    def _alloc(self) -> Tuple[int, int]:
        return self._same([sh._alloc() for sh in self.shards])

    def _grow_e(self) -> None:
        """Every shard's band doubled and replayed from its recorded
        consensus (one column-replay launch a shard on a card)."""
        before = self.shards[0].counters["replayed_cols"]
        for sh in self.shards:
            with self._on(sh):
                sh._grow_e()
        self.counters["grow_e_events"] += 1
        self.counters["replayed_cols"] += (
            self.shards[0].counters["replayed_cols"] - before)

    def _fit_cons(self, consensus: bytes) -> None:
        while len(consensus) >= self._C - 1:
            for sh in self.shards:
                sh._grow_cons()

    def live_handles(self) -> int:
        return self.shards[0].live_handles()

    # -- interface -----------------------------------------------------

    def root(self, active: np.ndarray) -> int:
        full = np.zeros(self._R, dtype=bool)
        full[: len(active)] = active
        Rs = self._Rs
        hs = []
        for k, sh in enumerate(self.shards):
            with self._on(sh):
                hs.append(sh.root(full[k * Rs:(k + 1) * Rs]))
        return self._same(hs)

    def clone(self, h: int) -> int:
        return self.clone_many([h])[0]

    def clone_many(self, hs: List[int]) -> List[int]:
        if not hs:
            return []
        self.counters["clone_calls"] += 1
        out = []
        for sh in self.shards:
            with self._on(sh):
                out.append(sh.clone_many(hs))
        return self._same(out)

    def free(self, h: int) -> None:
        for sh in self.shards:
            sh.free(h)

    def push(self, h: int, consensus: bytes) -> BranchStats:
        return self.push_many([(h, consensus)])[0]

    def push_many(self, specs: List[Tuple[int, bytes]]) -> List[BranchStats]:
        """Every listed branch advanced by its appended symbol on every
        shard; no shard commits while any shard overflows."""
        if not specs:
            return []
        self.counters["push_calls"] += 1
        for _, consensus in specs:
            self._fit_cons(consensus)
        slots = [self._slot(h) for h, _ in specs]
        if len(set(slots)) != len(slots):
            raise ValueError("push_many: duplicate branch handles in batch")
        syms = [self.sym_id[consensus[-1]] for _, consensus in specs]
        return self._advance_rows([(s, s, y) for s, y in zip(slots, syms)])

    def clone_push_many(self, specs):
        """``TorchScorer.clone_push_many`` on every shard: ``(src_handle,
        consensus_or_None, in_place)`` specs, ``[(handle, stats_or_None),
        ...]`` in spec order."""
        if not specs:
            return []
        self.counters["clone_push_calls"] += 1
        for _src, consensus, _inp in specs:
            if consensus is not None:
                self._fit_cons(consensus)
        rows, handles = [], []
        for src_h, consensus, in_place in specs:
            src = self._slot(src_h)
            if in_place:
                handle, dst = src_h, src
            else:
                handle, dst = self._alloc()
            handles.append(handle)
            sym = -1 if consensus is None else self.sym_id[consensus[-1]]
            rows.append((src, dst, sym))
            for sh in self.shards:
                sh._off_host[dst] = sh._off_host[src]
                sh._act_host[dst] = sh._act_host[src]
        if len({d for _, d, _ in rows}) != len(rows):
            raise ValueError("clone_push_many: duplicate destination slots")
        stats = self._advance_rows(rows)
        return [
            (h, stats[i] if specs[i][1] is not None else None)
            for i, h in enumerate(handles)
        ]

    def _advance_rows(self, rows) -> List[BranchStats]:
        """One column step of ``(src, dst, sym)`` rows on every shard
        (:func:`shard_step`).  When a shard overflows, the shards that
        committed get back the consensus length their sources had before
        the step (an overflowing shard committed nothing, so it still
        holds them), every shard's band grows and is replayed from that
        consensus, and the step is retried."""
        packed = np.ascontiguousarray(np.array(rows, dtype=np.int32).T)
        while True:
            outs = []
            for sh in self.shards:
                with self._on(sh):
                    outs.append(shard_step(
                        sh._state, packed, sh._reads, sh._rlen, sh._wc,
                        sh._et, self.num_symbols, bufs=sh._bk)[0])
            if not any(o.overflow for o in outs):
                return self._stats_batch(merge_outs(outs))
            held = next(sh for sh, o in zip(self.shards, outs) if o.overflow)
            srcs = torch.as_tensor(packed[0].astype(np.int64),
                                   device=held.device)
            pre = held._state["clen"][srcs].cpu()
            dsts = torch.as_tensor(packed[1].astype(np.int64))
            for sh, o in zip(self.shards, outs):
                if not o.overflow:
                    sh._state["clen"][dsts.to(sh.device)] = pre.to(sh.device)
            self.counters["shard_overflow_rollbacks"] += 1
            self._grow_e()

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        self.counters["stats_calls"] += 1
        slot = self._slot(h)
        outs = []
        for sh in self.shards:
            with self._on(sh):
                outs.append(branch_kernel.stats(
                    sh._state, [slot], sh._reads, sh._rlen,
                    self.num_symbols, bufs=sh._bk))
        m = merge_outs(outs)
        return self._stats_np(m.eds[0], m.occ[0], m.split[0], m.reached[0])

    def best_activation_offset(self, consensus: bytes, seq_index: int,
                               offset_window: int,
                               offset_compare_length: int, wildcard) -> int:
        """The offset scan on the read's own shard."""
        sh, local = self._locate(seq_index)
        before = sh.counters["offset_scan_calls"]
        with self._on(sh):
            best = sh.best_activation_offset(
                consensus, local, offset_window, offset_compare_length,
                wildcard)
        self.counters["offset_scan_calls"] += (
            sh.counters["offset_scan_calls"] - before)
        return best

    def activate(self, h: int, read_index: int, offset: int,
                 consensus: bytes) -> None:
        """The read's row caught up on its own shard (one column-replay
        launch on a card); an overflow grows every shard and retries."""
        self.counters["activate_calls"] += 1
        sh, local = self._locate(read_index)
        slot = sh._slot_of[h]
        sh._off_host[slot, local] = offset
        sh._act_host[slot, local] = True
        while True:
            with self._on(sh):
                overflow = replay_kernel.activate_row(
                    sh._state, slot, local, offset, sh._reads, sh._rlen,
                    sh._wc, sh._et)
            if not overflow:
                return
            self._grow_e()

    def deactivate(self, h: int, read_index: int) -> None:
        self.deactivate_many([(h, read_index)])

    def deactivate_many(self, pairs) -> None:
        by_shard = {}
        for h, r in pairs:
            sh, local = self._locate(r)
            by_shard.setdefault(id(sh), (sh, []))[1].append((h, local))
        for sh, local_pairs in by_shard.values():
            with self._on(sh):
                sh.deactivate_many(local_pairs)

    def finalized_eds(self, h: int, consensus: bytes) -> np.ndarray:
        self.counters["finalize_calls"] += 1
        slot = self._slot(h)
        while True:
            outs = []
            for sh in self.shards:
                with self._on(sh):
                    outs.append(branch_kernel.finalize(
                        sh._state, [slot], sh._reads, sh._rlen,
                        bufs=sh._bk))
            if not any(ovf[0] for _fin, ovf in outs):
                fin = np.concatenate([f[0] for f, _ovf in outs])
                return fin[: self.num_reads].astype(np.int64)
            self._grow_e()

    # host stats as BranchStats: TorchScorer's conversions, over the
    # merged reads
    _stats_batch = TorchScorer._stats_batch
    _stats_np = TorchScorer._stats_np
