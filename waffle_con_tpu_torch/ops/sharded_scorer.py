"""Read-sharded branch store: one search's reads split over the devices
of a mesh, each shard a ``TorchScorer`` of its own.

The counterpart of ``waffle_con_tpu``'s read-sharded ``JaxScorer``
(``parallel/mesh.py`` ``shard_scorer``: the scorer's state placed with a
``NamedSharding`` over the read axis, every kernel partitioned by
GSPMD).  Here one process holds the shards (single-controller, as the
reference is), and what crosses shards is merged on the host in read
order, or, for a column step's three scalars, added on the mesh's first
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

The route (:func:`shard_groups`).  The shards are split into groups,
and each branch-step call of the store (root, copy, push, clone-push,
stats, finalize) is one call of ``csrc/branch_step.cu`` a group
(:func:`shard_step`, ``branch_kernel.advance_shards`` and its kin): one
launch, one overflow word, so a step commits in every shard of the group
or in none inside the kernel, and the output comes back in read order.
Under ``"auto"`` the shards on one CUDA device form one group (one
launch a card) and a shard on the CPU is a group of its own (its twin
runs alone); ``"per_shard"`` makes every shard a group of one (the
comparison route).  Groups are each launched before the first wait; when
one overflows and another committed, the shards that committed go back
to the step's consensus length (the host rollback), every shard's band
grows and is replayed from that one consensus, and the step is retried
(on distinct cards not run here: the machines this was measured on have
one card).  A late read's offset scan and activation run on its own
shard; a band growth replays every shard.

The run paths.  The store has ``TorchScorer``'s ``run_extend``,
``run_extend_dual`` and ``run_arena`` (their host side is
``TorchScorer``'s: slot choice, scratch slots and the creation pool taken
on every shard in lockstep, capacity growth, the band grown on an
overflow, records, counters), and its planners ``run_takes``,
``run_dual_takes`` and ``arena_takes``.  Where the shards are
(:func:`placement`) decides what runs, whatever the route: shards on
one CUDA device are one launch of the kernel's shard instance for all of
them (``run_kernel.run_extend_shards_cuda`` and kin: one overflow word,
the CTAs' reads and the vote fold over the store's global reads, so the
result is the unsharded kernel's bit for bit); shards on the CPU take the
plain versions (the shards' slots gathered into one store, the unsharded
plain loop, the result split back); shards on more than one device are
refused by the three planners (each refusal counted as
``plan_refused_cross_card``), so the engines take their per-pop expand
path there, which is exact: a run across cards would need an exchange
between the cards at every step.  An overflow (code 5) grows every
shard's band and replays it from the one consensus, as a branch step's
does.  The store offers no frontier gang (:meth:`ragged_run_probe`), as
the JAX package's ``ops/ragged.py`` refuses a sharded scorer.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.config import CdwfaConfig
from waffle_con_tpu_torch.ops import (
    arena_kernel,
    branch_kernel,
    replay_kernel,
    run_dual_kernel,
    run_kernel,
)
from waffle_con_tpu_torch.ops.branch_kernel import BranchOut, merge_outs
from waffle_con_tpu_torch.ops.scorer import BranchStats, WavefrontScorer
from waffle_con_tpu_torch.ops.torch_scorer import (
    StoreGeometry,
    TorchScorer,
    _next_pow2,
)

#: the routes of a sharded store's calls (:func:`shard_groups`)
ROUTES = ("auto", "per_shard")


def _card(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device()
                            if torch.cuda.is_available() else 0)
    return d


#: where a sharded store's shards are (:func:`placement`)
PLACEMENTS = ("fused", "plain", "cross_card")


def placement(devices) -> str:
    """What a sharded store on ``devices`` runs for its run, dual-run and
    arena calls: ``"fused"`` when every shard is on one CUDA device (one
    launch of a kernel's shard instance for all of them), ``"plain"``
    when every shard is on the CPU (the plain versions), ``"cross_card"``
    when the shards are on more than one device (the planners refuse).
    A pure function of the devices' names."""
    cards = {str(_card(d)) for d in devices}
    if len(cards) != 1:
        return "cross_card"
    return "fused" if _card(next(iter(devices))).type == "cuda" else "plain"


def _fuses(device: torch.device) -> bool:
    """Whether ``"auto"`` puts the shards on ``device`` in one call: on a
    card, yes (one launch); on the CPU each shard is a group of its own,
    so the protocol between groups runs there too."""
    return device.type == "cuda"


def shard_groups(devices, route: str = "auto"):
    """The groups of shard indices that share one call, in mesh order of
    their first shard: ``[(device, [k, ...]), ...]``.  ``"auto"`` groups
    the shards of each CUDA device and leaves a shard on the CPU alone;
    ``"per_shard"`` leaves every shard alone.  Raises ``ValueError`` on
    another route, and when a group would hold more than
    ``branch_kernel.MAX_SHARDS`` shards."""
    if route not in ROUTES:
        raise ValueError(f"route {route!r} not in {ROUTES}")
    groups, at = [], {}
    for k, d in enumerate(devices):
        d = _card(d)
        key = str(d) if route == "auto" and _fuses(d) else k
        if key not in at:
            at[key] = len(groups)
            groups.append((d, []))
        groups[at[key]][1].append(k)
    for d, ks in groups:
        if len(ks) > branch_kernel.MAX_SHARDS:
            raise ValueError(
                f"{len(ks)} shards on {d}: a call takes at most "
                f"{branch_kernel.MAX_SHARDS}")
    return groups


def _launched(fn):
    """``fn()`` and the branch-step kernels it launched on this thread
    (counted in ``shard_step.launches``; another thread's launches in the
    meantime are not this call's)."""
    before = branch_kernel.thread_launches()
    out = fn()
    shard_step.launches += branch_kernel.thread_launches() - before
    return out


def shard_step(states, rows, reads, rlens, wc: int, et: bool,
               num_symbols: int, bufs=None, force: bool = False,
               partials: bool = False, plain: bool = False,
               defer: bool = False):
    """One column step (rows ``(src, dst, sym)``) of every read shard in
    ``states`` (one device, one geometry; one shard or several) as one
    call: ``branch_kernel.advance_shards_cuda`` on a card (one launch,
    every shard committed or none unless ``force``),
    ``advance_shards_plain`` on the CPU or with ``plain``.  With
    ``partials`` the call's partials come back as an int32 ``[3]`` tensor
    on the device (the active reads' edit-distance sum, any read reached,
    any pushed read overflowed: the kernel's atomics, or
    :func:`partials_plain`).  Returns ``(BranchOut over the shards' reads
    in shard order, partials or None)``; with ``defer`` (a card only) the
    first item is a function that waits for the output.
    ``shard_step.launches`` counts the kernels of every sharded call."""
    dev = states[0]["D"].device
    if not plain and branch_kernel._on_cuda(states[0]["D"]):
        part = (torch.empty(3, dtype=torch.int32, device=dev)
                if partials else None)
        out = _launched(lambda: branch_kernel.advance_shards_cuda(
            states, rows, reads, rlens, wc, et, num_symbols, bufs=bufs,
            force=force, part=part, defer=defer))
        return out, part
    out = branch_kernel.advance_shards_plain(states, rows, reads, rlens, wc,
                                             et, num_symbols, force=force)
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
    """The groups' partials added in order on ``device`` (the mesh's
    first): a peer copy where a group lives on another device, a plain
    add where it is the same; the integer sums are exact, so any order
    gives the same words.  Returns ``(total, reached_any, overflow)`` as
    0-d tensors on ``device``."""
    acc = parts[0].to(device)
    for p in parts[1:]:
        acc = acc + p.to(device)
    return acc[0], acc[1] > 0, acc[2] > 0


def _slice_reads(out: BranchOut, lo: int, hi: int) -> BranchOut:
    """Reads ``[lo, hi)`` of an output (the row flags kept whole)."""
    cut = lambda x: None if x is None else x[:, lo:hi]  # noqa: E731
    return out._replace(eds=cut(out.eds), occ=cut(out.occ),
                        split=cut(out.split), reached=cut(out.reached),
                        fin=cut(out.fin))


class ShardedScorer(WavefrontScorer):
    """A branch store whose reads are split over ``devices`` (in mesh
    order; a device may repeat), built by
    :func:`waffle_con_tpu_torch.parallel.mesh.shard_scorer`; ``route``
    groups the shards' calls (:func:`shard_groups`)."""

    def __init__(self, reads: Sequence[bytes], config: CdwfaConfig,
                 devices: Sequence, route: str = "auto") -> None:
        super().__init__(reads, config)
        self.devices = tuple(torch.device(d) for d in devices)
        n = len(self.devices)
        if n < 1:
            raise ValueError("a sharded store needs at least one device")
        #: ``[(device, [shard, ...]), ...]``: the shards of one call
        self.groups = shard_groups(self.devices, route)
        self._gbk = [branch_kernel.BranchBuffers() for _ in self.groups]
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
        #: what the run, dual-run and arena calls run (:func:`placement`)
        self.placement = placement(self.devices)
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
    def _B(self) -> int:
        return self.shards[0]._B

    @property
    def _L(self) -> int:
        return self.shards[0]._L

    @property
    def _W(self) -> int:
        return 2 * self._E + 2

    @property
    def _wc(self) -> int:
        return self.shards[0]._wc

    @property
    def _et(self) -> bool:
        return self.shards[0]._et

    @property
    def _slot_of(self):
        """Handle -> slot (every shard's: the slots are in lockstep)."""
        return self.shards[0]._slot_of

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

    def _grow_cons(self) -> None:
        for sh in self.shards:
            sh._grow_cons()

    def _fit_cons(self, consensus: bytes) -> None:
        while len(consensus) >= self._C - 1:
            self._grow_cons()

    def live_handles(self) -> int:
        return self.shards[0].live_handles()

    # -- interface -----------------------------------------------------

    def _group(self, gi):
        """A group's shards and their states, reads and rlen."""
        shs = [self.shards[k] for k in self.groups[gi][1]]
        return (shs, [sh._state for sh in shs], [sh._reads for sh in shs],
                [sh._rlen for sh in shs])

    def _by_read(self, outs) -> BranchOut:
        """The groups' outputs of one call in read order (shard order)."""
        if len(outs) == 1:
            return outs[0]
        per = [None] * len(self.shards)
        Rs = self._Rs
        for (_d, ks), out in zip(self.groups, outs):
            for i, k in enumerate(ks):
                per[k] = _slice_reads(out, i * Rs, (i + 1) * Rs)
        return merge_outs(per)

    def root(self, active: np.ndarray) -> int:
        full = np.zeros(self._R, dtype=bool)
        full[: len(active)] = active
        Rs = self._Rs
        masks = [full[k * Rs:(k + 1) * Rs] for k in range(len(self.shards))]
        handle, slot = self._same([sh._root_slot(m)
                                   for sh, m in zip(self.shards, masks)])
        for gi, (_d, ks) in enumerate(self.groups):
            shs, states, _rd, rlens = self._group(gi)
            act = np.concatenate([masks[k] for k in ks])
            with self._on(shs[0]):
                _launched(lambda: branch_kernel.root_shards(
                    states, slot, act, rlens, bufs=self._gbk[gi]))
        return handle

    def clone(self, h: int) -> int:
        return self.clone_many([h])[0]

    def clone_many(self, hs: List[int]) -> List[int]:
        if not hs:
            return []
        self.counters["clone_calls"] += 1
        handles, srcs, dsts = self._same(
            [sh._copy_slots(hs) for sh in self.shards])
        rows = np.asarray([srcs, dsts, [-1] * len(hs)], dtype=np.int32)
        for gi in range(len(self.groups)):
            shs, states, reads, rlens = self._group(gi)
            sh0 = shs[0]
            with self._on(sh0):
                _launched(lambda: branch_kernel.advance_shards(
                    states, rows, reads, rlens, sh0._wc, sh0._et,
                    self.num_symbols, with_stats=False, bufs=self._gbk[gi]))
        return handles

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
            handle, src, dst = self._same(
                [sh._push_slot(src_h, in_place) for sh in self.shards])
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

    def _step_group(self, gi, packed, defer):
        """One column step of group ``gi``: one call for its shards."""
        shs, states, reads, rlens = self._group(gi)
        sh = shs[0]
        with self._on(sh):
            return shard_step(states, packed, reads, rlens, sh._wc, sh._et,
                              self.num_symbols, bufs=self._gbk[gi],
                              defer=defer)[0]

    def _advance_rows(self, rows) -> List[BranchStats]:
        """One column step of ``(src, dst, sym)`` rows on every shard: one
        call a group, every group's queued before the first wait.  A
        group commits all or nothing inside its call, so one group needs
        no rollback: on an overflow the band grows and the step is
        retried.  Across groups, when one overflows, the shards of the
        groups that committed get back the consensus length their sources
        had before the step (an overflowing group committed nothing, so
        it still holds them), every shard's band grows and is replayed
        from that consensus, and the step is retried."""
        packed = np.ascontiguousarray(np.array(rows, dtype=np.int32).T)
        many = len(self.groups) > 1
        while True:
            queued = [self._step_group(gi, packed, many)
                      for gi in range(len(self.groups))]
            outs = [q() if callable(q) else q for q in queued]
            if not any(o.overflow for o in outs):
                return self._stats_batch(self._by_read(outs))
            committed = [gi for gi, o in enumerate(outs) if not o.overflow]
            if committed:
                held = self.shards[self.groups[
                    next(gi for gi, o in enumerate(outs) if o.overflow)][1][0]]
                srcs = torch.as_tensor(packed[0].astype(np.int64),
                                       device=held.device)
                pre = held._state["clen"][srcs].cpu()
                dsts = torch.as_tensor(packed[1].astype(np.int64))
                for gi in committed:
                    for k in self.groups[gi][1]:
                        sh = self.shards[k]
                        sh._state["clen"][dsts.to(sh.device)] = pre.to(
                            sh.device)
                self.counters["shard_overflow_rollbacks"] += 1
            self._grow_e()

    def stats(self, h: int, consensus: bytes) -> BranchStats:
        self.counters["stats_calls"] += 1
        slot = self._slot(h)
        queued = []
        for gi in range(len(self.groups)):
            shs, states, reads, rlens = self._group(gi)
            with self._on(shs[0]):
                queued.append(_launched(lambda: branch_kernel.stats_shards(
                    states, [slot], reads, rlens, self.num_symbols,
                    bufs=self._gbk[gi], defer=len(self.groups) > 1)))
        m = self._by_read([q() if callable(q) else q for q in queued])
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
            fins, ovf = [None] * len(self.shards), False
            for gi, (_d, ks) in enumerate(self.groups):
                shs, states, reads, rlens = self._group(gi)
                with self._on(shs[0]):
                    fin, o = _launched(lambda: branch_kernel.finalize_shards(
                        states, [slot], reads, rlens, bufs=self._gbk[gi]))
                ovf = ovf or bool(o[0])
                Rs = self._Rs
                for i, k in enumerate(ks):
                    fins[k] = fin[0, i * Rs:(i + 1) * Rs]
            if not ovf:
                fin = np.concatenate(fins)
                return fin[: self.num_reads].astype(np.int64)
            self._grow_e()

    # host stats as BranchStats: TorchScorer's conversions, over the
    # merged reads
    _stats_batch = TorchScorer._stats_batch
    _stats_np = TorchScorer._stats_np

    # -- the run paths: TorchScorer's host side, the launches below -----

    run_args = TorchScorer.run_args
    dual_run_args = TorchScorer.dual_run_args
    _fit_steps = TorchScorer._fit_steps
    run_extend = TorchScorer.run_extend
    run_extend_dual = TorchScorer.run_extend_dual
    run_arena = TorchScorer.run_arena
    run_takes = TorchScorer.run_takes
    run_dual_takes = TorchScorer.run_dual_takes
    arena_takes = TorchScorer.arena_takes
    _geom_bucket = TorchScorer._geom_bucket
    ARENA_CAP_MAX = TorchScorer.ARENA_CAP_MAX
    ARENA_K = TorchScorer.ARENA_K
    ARENA_TAKE_MAX = TorchScorer.ARENA_TAKE_MAX
    ARENA_CRE_PER_EVENT = TorchScorer.ARENA_CRE_PER_EVENT
    ARENA_POOL = TorchScorer.ARENA_POOL
    ARENA_CAP = TorchScorer.ARENA_CAP

    def _takes(self, kind: str, planner, *shape) -> bool:
        """``TorchScorer._takes`` where the shards share one device; on
        more than one device every planner refuses, counted as
        ``plan_refused_cross_card``."""
        if self.placement == "cross_card":
            key = "plan_refused_cross_card"
            self.counters[key] = self.counters.get(key, 0) + 1
            return False
        return TorchScorer._takes(self, kind, planner, *shape)

    def _spec_drop(self, h=None) -> None:
        """No gang deposits to drop: the store offers no gang."""

    def ragged_run_probe(self, h: int):
        """None: a sharded store joins no gang (the serving pool's or the
        frontier gang), as the JAX package's gang refuses a sharded
        scorer."""
        return None

    def _alloc(self) -> Tuple[int, int]:
        return self._same([sh._alloc() for sh in self.shards])

    def _scratch_reset(self) -> None:
        for sh in self.shards:
            sh._scratch_reset()

    def _scratch_slot(self) -> int:
        return self._same([sh._scratch_slot() for sh in self.shards])

    def _set_act_host(self, slot: int, act) -> None:
        Rs = self._Rs
        for k, sh in enumerate(self.shards):
            sh._act_host[slot] = act[k * Rs:(k + 1) * Rs]

    def _copy_off_host(self, dst: int, src: int) -> None:
        for sh in self.shards:
            sh._off_host[dst] = sh._off_host[src]

    def _store(self):
        """The shards' stores, reads and lengths."""
        return ([sh._state for sh in self.shards],
                [sh._reads for sh in self.shards],
                [sh._rlen for sh in self.shards])

    def _run_launch(self, slot: int, args):
        states, reads, rlens = self._store()
        return run_kernel.run_extend_shards(states, slot, reads, rlens, args)

    def _dual_launch(self, s1: int, s2: int, mc_tab, imb_tab, args):
        states, reads, rlens = self._store()
        return run_dual_kernel.run_extend_dual_shards(
            states, s1, s2, reads, rlens, mc_tab, imb_tab, args)

    def _arena_launch(self, slots, kinds, lc, pc, tr, mc_tab, imb_tab,
                      args):
        states, reads, rlens = self._store()
        return arena_kernel.arena_shards(states, reads, rlens, slots, kinds,
                                         lc, pc, tr, mc_tab, imb_tab, args)
