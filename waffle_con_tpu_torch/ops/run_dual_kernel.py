"""The dual run loop behind ``TorchScorer.run_extend_dual``.

Four pieces, one contract, as in :mod:`~waffle_con_tpu_torch.ops.run_kernel`:

* :func:`run_extend_dual_plain` — the loop in plain PyTorch over the
  column primitives of :mod:`waffle_con_tpu_torch.ops.torch_scorer`, one
  step per iteration.  It is what runs for tensors on the CPU, and the
  yardstick the CUDA kernel is held to on the card.
* :func:`plan_run_dual` — the launch geometry of the kernel (one
  thread-block cluster per dual run) from the shape alone.
* :func:`run_extend_dual_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/run_extend_dual.cu`` (built by
  :mod:`~waffle_con_tpu_torch.ops.cuda_build`, bound with ``ctypes``); it
  counts its launches in ``run_extend_dual_cuda.launches``.
* :func:`run_extend_dual` — the dispatch rule: a state on the CPU runs
  the plain loop, a state on a CUDA device launches the kernel (or
  raises).
* :func:`run_extend_dual_shards` — the same on a read-sharded store
  whose shards share one device: one launch of the kernel's shard
  instance on a card (:func:`run_extend_dual_shards_cuda`),
  :func:`run_extend_dual_shards_plain` on the CPU.

The contract is the one of ``waffle_con_tpu``'s ``_j_run_dual_pallas``
(``ops/pallas_run.py``) and ``_j_run_dual`` (``ops/jax_scorer.py``): the
two branch slots of a dual node advance one symbol per step, each side
with its own nomination (fractional tip votes, optionally weighted by the
relative edit distance, the ``mc_tab`` threshold table, the wildcard
drop, the ``VOTE_EPS`` near-tie guard); a locked side is frozen.  Per
step, in order: stop codes 3 (the node loses the next pop or goes over
budget), 2 (reads reached their end and the record cannot be absorbed),
1 (a dirty vote or a finished unlocked side, or an L2 cost overflow), 4
(step cap); then one column on each unlocked side — 5 on band overflow
(the step is not committed); divergence pruning on the new distances;
6 when a side's active count falls below ``imb_tab`` (the step is
committed).  Reached-end records of the pre-step state are absorbed into
``REC_CAP`` buffers.  Both slots of the branch store are updated in
place, ``act`` included.

Results come back as one packed ``int32`` tensor (see
:func:`dual_out_layout`), plus the record buffers when records were
absorbed.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.ops import branch_kernel, cuda_build, state_io
from waffle_con_tpu_torch.ops.run_kernel import (
    _LAUNCH_ERRORS,
    _ptr,
    shard_placement,
    MAX_CLUSTER,
    MAX_WARPS,
    SMEM_LIMIT,
    _ring_len,
    _wrap32,
)
from waffle_con_tpu_torch.ops.torch_scorer import (
    REC_CAP,
    VOTE_EPS,
    col_step,
    finalized,
    gather_window,
    stats_core,
)
from waffle_con_tpu_torch.runtime import faults

#: the "untracked side" cost of a read in the node-cost fold
BIG = 1 << 28


class DualRunArgs(NamedTuple):
    """Per-call scalars of one dual run (host integers, passed by
    value)."""

    me_budget: int
    other_cost: int
    other_len: int
    #: ``dual_max_ed_delta`` of the divergence pruning
    delta: int
    l2: bool
    weighted: bool
    max_steps: int
    lock1: bool
    lock2: bool
    allow_records: bool
    #: record-acceptance imbalance threshold (``full_min_count``)
    rec_min: int
    #: ``mc_tab`` is a dynamic (``min_af != 0``) table
    mc_dyn: bool
    #: dense wildcard id, or -2
    wc: int
    et: bool
    #: real dense alphabet size (columns of ``occ``)
    a_real: int


def dual_out_layout(R: int, A: int, max_steps: int
                    ) -> Dict[str, Tuple[int, int]]:
    """``name -> (start, stop)`` of each field in the packed ``int32``
    output: 8 scalars (steps, code, rec_count, clen1, clen2), then per
    side ``k`` in 1, 2 the final snapshot (``eds{k}``, ``split{k}``,
    ``reached{k}``, ``act{k}``: ``[R]`` each; ``occ{k}``: ``[R, A]``
    row-major), then the committed symbols of each side (``max_steps``
    slots each)."""
    fields = [("scalars", 8)]
    for k in (1, 2):
        fields += [(f"eds{k}", R), (f"split{k}", R), (f"reached{k}", R),
                   (f"act{k}", R), (f"occ{k}", R * A)]
    fields += [("syms1", max_steps), ("syms2", max_steps)]
    out = {}
    at = 0
    for name, n in fields:
        out[name] = (at, at + n)
        at += n
    return out


def _wrap_t(x):
    """Two's-complement int32 wrap of an int64 tensor."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def dual_votes(occ, split, w):
    """One side's fractional tip votes: each voting read (weight > 0,
    a tip at all) splits its weight ``w`` across its tips, summed over
    the reads in float32 (the device folds in another order; the
    VOTE_EPS contract of :func:`nominate_side` covers the difference).
    Returns ``(counts [A] float32, has_votes [A], nonexact)``: whether a
    voting read's split is not a power of two."""
    voting = (w > 0) & (split > 0)
    voters = (occ > 0) & voting[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=occ.device)
    frac = torch.where(
        split[:, None] > 0,
        occ.float() / split.clamp(min=1)[:, None].float(), zero,
    ) * w[:, None]
    counts = torch.where(voters, frac, zero).sum(0)
    dyadic = (split & (split - 1)) == 0
    return counts, voters.any(0), bool((voting & ~dyadic).any())


def nominate_side(counts, has_votes, nonexact: bool, wc: int,
                  weighted: bool, mc_tab, mc_dyn: bool):
    """One side's nomination from its summed votes (``_nominate_side`` of
    the JAX package): the wildcard drop with candidates recounted after
    it, the ``mc_tab`` threshold at the rounded vote total, the EPS
    near-tie guard, first-max tie-break.  Returns ``(dirty, sym)``;
    ``counts`` and ``has_votes`` are not modified."""
    eps = float(VOTE_EPS)
    counts, has_votes = counts.clone(), has_votes.clone()
    if wc >= 0 and int(has_votes.sum()) > 1:
        # the dual fold recounts candidates after the wildcard drop
        has_votes[wc] = False
        counts[wc] = 0.0
    n_cands = int(has_votes.sum())
    exactable = not nonexact and not weighted
    n_vote_f = counts.sum()
    n_vote_r = torch.round(n_vote_f)
    int_ok = bool((n_vote_f - n_vote_r).abs() < eps)
    tab_bad = mc_dyn and not int_ok
    exactable = exactable and not tab_bad
    idx = min(max(int(n_vote_r), 0), mc_tab.shape[0] - 1)
    mc_f = mc_tab[idx].float()
    neg1 = torch.full_like(counts, -1.0)
    maxc = torch.where(has_votes, counts, neg1).max()
    thr = torch.minimum(mc_f, maxc)
    passing = has_votes & (counts >= thr)
    npass = int(passing.sum())
    near_tie = bool((maxc - mc_f).abs() < eps) or bool(
        (has_votes & ((counts - thr).abs() < eps)).any()
    )
    dirty = ((not exactable) and near_tie) or npass != 1 or n_cands == 0 \
        or tab_bad
    sym = int(torch.argmax(torch.where(passing, counts, neg1)))
    return dirty, sym


def _nominate(occ, split, w, wc: int, weighted: bool, mc_tab, mc_dyn: bool):
    """One side's vote fold and nomination (``_dual_votes`` +
    ``_nominate_side`` of the JAX package).  Returns ``(dirty, sym)``."""
    counts, has_votes, nonexact = dual_votes(occ, split, w)
    return nominate_side(counts, has_votes, nonexact, wc, weighted, mc_tab,
                         mc_dyn)


# ---------------------------------------------------------------------
# plain PyTorch version


def run_extend_dual_plain(state, h1: int, h2: int, reads, rlen, mc_tab,
                          imb_tab, args: DualRunArgs):
    """The dual run loop in plain PyTorch (same contract and outputs as
    the CUDA kernel).  Returns ``(out, rec_steps, rec_planes)`` with
    ``rec_planes`` the ``[4, REC_CAP, R]`` record rows (fin1, fin2,
    act1, act2)."""
    run_extend_dual_plain.calls += 1
    dev = state["D"].device
    R, W = state["D"].shape[1:]
    E = (W - 2) // 2
    A = args.a_real
    hs = (h1, h2)
    locks = (bool(args.lock1), bool(args.lock2))
    off = [state["off"][h] for h in hs]
    D = [state["D"][h].clone() for h in hs]
    e = [state["e"][h].clone() for h in hs]
    rmin = [state["rmin"][h].clone() for h in hs]
    er = [state["er"][h].clone() for h in hs]
    act = [state["act"][h].clone() for h in hs]
    clen = [int(state["clen"][h]) for h in hs]
    clen0 = list(clen)
    syms = ([], [])
    rec_steps = torch.zeros(REC_CAP, dtype=torch.int32, device=dev)
    rec_planes = torch.zeros((4, REC_CAP, R), dtype=torch.int32, device=dev)
    imbn = imb_tab.shape[0]

    def cost(x):
        x = x.long()
        return _wrap_t(x * x) if args.l2 else x

    def window(s, j):
        return gather_window(reads, j, off[s], E, W)

    def stats(s):
        return stats_core(D[s], e[s], rmin[s], er[s], off[s], act[s], rlen,
                          window(s, clen[s]), clen[s], A, E)

    steps = 0
    code = 0
    rec_count = 0
    budget = args.me_budget
    while code == 0:
        (eds_a, occ_a, split_a, reached_a), (eds_b, occ_b, split_b,
                                             reached_b) = stats(0), stats(1)
        acta, actb = act
        best = torch.minimum(torch.where(acta, cost(eds_a), BIG),
                             torch.where(actb, cost(eds_b), BIG))
        total = _wrap32(torch.where(acta | actb, best, 0).sum())
        cost_overflow = args.l2 and max(int(eds_a.max()),
                                        int(eds_b.max())) > 2048

        # per-read vote weights
        both = acta & actb
        if args.weighted:
            c1f = eds_a.float().clamp(min=0.5)
            c2f = eds_b.float().clamp(min=0.5)
            denom = c1f + c2f
            wa = torch.where(both, c2f / denom, acta.float())
            wb = torch.where(both, c1f / denom, actb.float())
        else:
            wa, wb = acta.float(), actb.float()
        dirty = [False, False]
        sym = [0, 0]
        for s, (occ, split, w) in enumerate(((occ_a, split_a, wa),
                                             (occ_b, split_b, wb))):
            if not locks[s]:  # a locked side never arbitrates
                dirty[s], sym[s] = _nominate(
                    occ, split, w, args.wc, args.weighted, mc_tab,
                    args.mc_dyn,
                )

        reached_read = (acta & reached_a) | (actb & reached_b)
        if args.et:
            fin_side = [bool((reached_a | ~acta).all()),
                        bool((reached_b | ~actb).all())]
            reached_stop = bool((reached_read | (~acta & ~actb)).all())
        else:
            fin_side = [bool((acta & reached_a).any()),
                        bool((actb & reached_b).any())]
            reached_stop = bool(reached_read.any())
        cur_len = max(clen)
        wins_pop = total < args.other_cost or (
            total == args.other_cost and cur_len > args.other_len
        )

        # record evaluation of this (pre-step) state
        fin1, fo1 = finalized(e[0], rmin[0], acta, E)
        fin2, fo2 = finalized(e[1], rmin[1], actb, E)
        fc1, fc2 = cost(fin1), cost(fin2)
        side0 = acta & (~actb | (fc1 <= fc2))
        any_act = acta | actb
        fin_total = _wrap32(
            torch.where(any_act, torch.where(side0, fc1, fc2), 0).sum()
        )
        count0 = int((side0 & any_act).sum())
        count1 = int(any_act.sum()) - count0
        rec_imbalanced = count0 < args.rec_min or count1 < args.rec_min
        fin_cost_ovf = args.l2 and max(int(fin1.max()),
                                       int(fin2.max())) > 2048
        rec_blocked = (
            not args.allow_records or bool(fo1) or bool(fo2)
            or fin_cost_ovf or rec_count >= REC_CAP
        )

        if total > budget or not wins_pop:
            code = 3
        elif reached_stop and rec_blocked:
            code = 2
        elif (
            dirty[0] or dirty[1]
            or (fin_side[0] and not locks[0])
            or (fin_side[1] and not locks[1])
            or cost_overflow
        ):
            code = 1
        elif steps >= args.max_steps:
            code = 4
        if code != 0:
            break

        new = []
        for s in (0, 1):
            if locks[s]:
                new.append((D[s], e[s], rmin[s], er[s]))
            else:
                new.append(col_step(
                    D[s], e[s], rmin[s], er[s], off[s], act[s], rlen,
                    window(s, clen[s]), clen[s] + 1, sym[s], args.wc,
                    args.et, E,
                ))
        ea2, eb2 = new[0][1], new[1][1]
        if bool((acta & (ea2 >= E)).any() | (actb & (eb2 >= E)).any()):
            code = 5
            break
        # divergence pruning on the new distances
        acta2 = acta & ~(both & (eb2 + args.delta < ea2))
        actb2 = actb & ~(both & (ea2 + args.delta < eb2))
        imb_v = int(imb_tab[min(max(cur_len + 1, 0), imbn - 1)])
        if int(acta2.sum()) < imb_v or int(actb2.sum()) < imb_v:
            code = 6  # committed all the same
        if reached_stop:
            ri = min(rec_count, REC_CAP - 1)
            rec_steps[ri] = steps
            for k, row in enumerate((fin1, fin2, acta, actb)):
                rec_planes[k, ri] = row.to(torch.int32)
            rec_count += 1
            if not rec_imbalanced and fin_total < budget:
                budget = fin_total
        for s in (0, 1):
            D[s], e[s], rmin[s], er[s] = new[s]
            if not locks[s]:
                syms[s].append(sym[s])
                clen[s] += 1
        act = [acta2, actb2]
        steps += 1

    lay = dual_out_layout(R, A, args.max_steps)
    out = torch.zeros(lay["syms2"][1], dtype=torch.int32, device=dev)

    def put(name, value):
        a, b = lay[name]
        out[a:b] = value.reshape(-1).to(torch.int32)

    for s, h in enumerate(hs):
        eds, occ, split, reached = stats(s)
        k = s + 1
        put(f"eds{k}", eds)
        put(f"split{k}", split)
        put(f"reached{k}", reached)
        put(f"act{k}", act[s])
        put(f"occ{k}", occ)
        state["D"][h] = D[s]
        state["e"][h] = e[s]
        state["rmin"][h] = rmin[s]
        state["er"][h] = er[s]
        state["act"][h] = act[s]
        n = len(syms[s])
        if n:
            row = torch.tensor(syms[s], dtype=torch.int32, device=dev)
            state["cons"][h, clen0[s]:clen[s]] = row
            a = lay[f"syms{k}"][0]
            out[a:a + n] = row
        state["clen"][h] = clen[s]
    put("scalars", torch.tensor(
        [steps, code, rec_count, clen[0], clen[1], 0, 0, 0],
        dtype=torch.int32, device=dev,
    ))
    return out, rec_steps, rec_planes


run_extend_dual_plain.calls = 0


# ---------------------------------------------------------------------
# launch planner of the CUDA kernel


class DualRunPlan(NamedTuple):
    """Launch geometry of one ``run_extend_dual`` kernel call.  The unit
    of work is a (side, read) row; both sides of a read sit in one CTA."""

    #: CTAs of the one thread-block cluster
    cluster: int
    #: threads of each CTA (32 per warp)
    threads: int
    #: reads of each CTA (contiguous blocks; the last CTA may own fewer)
    reads_per_cta: int
    #: rows of each warp: 1 is a warp pair per read, one side each; an
    #: even number ``2k`` is both sides of ``k`` reads per warp
    rows_per_warp: int
    #: ``"smem"``: both band buffers of both sides of a CTA's reads in
    #: its shared memory; ``"global"``: each slot and a scratch buffer per
    #: side in device memory
    band: str
    #: dynamic shared memory of each CTA, bytes
    smem_bytes: int


def _part_words(A: int) -> int:
    """Words of one partial: 12 header words, then has[A] and counts[A]
    per side (``clu::Layout<6, 2, 2>`` in ``csrc/cluster_ops.cuh``)."""
    return (12 + 4 * A + 3) & ~3


def _smem_bytes(rpc: int, nw: int, W: int, A: int, on_chip: bool) -> int:
    """Dynamic shared memory of one CTA (the layout of ``carve`` in
    ``csrc/run_extend_dual.cu``): the CTA's partial and every CTA's
    partial by parity, 23 words per read (11 per side and its length),
    two histograms and a partial per warp, both sides' cluster votes and
    the broadcast decision; on chip also two band buffers and a symbol
    ring per (side, read) row."""
    P = _part_words(A)
    words = (1 + 2 * MAX_CLUSTER) * P + 23 * rpc + nw * (2 * A + P) \
        + 4 * A + 8
    nbytes = 4 * words
    if on_chip:
        nbytes += 16 * rpc * W + 4 * rpc * _ring_len(W)
    return nbytes


def plan_run_dual(R: int, W: int, A: int) -> DualRunPlan:
    """The launch geometry of the dual run kernel for ``R`` reads (``2R``
    rows), band width ``W`` and ``A`` dense symbols.  The rule:

    * the smallest cluster (1, 2, 4, 8 or 16 CTAs) whose CTAs hold at most
      16 rows each, one row per warp (a warp pair per read), with the
      band on chip;
    * else 16 CTAs of up to 16 warps, both sides of several reads per
      warp, with the band on chip when the CTA's share fits in shared
      memory (and a warp's rows are at most 32, one symbol ring fed per
      lane), and in device memory when it does not;
    * where even that overflows a CTA's shared memory (the per-warp
      histograms and partials grow with ``A``: R=256 at A=256), half the
      warps, then half again, each warp taking more reads.

    Raises ``ValueError`` on a shape no plan takes (an empty read set, a
    band narrower than 4 cells or odd, no symbol, or per-read state that
    exceeds a CTA's shared memory even on one warp with the band off
    chip)."""
    if R < 1 or A < 1 or W < 4 or W % 2:
        raise ValueError(f"no dual run plan for R={R}, W={W}, A={A}")
    c = 1
    while c <= MAX_CLUSTER:
        rpc = -(-R // c)
        nw = 2 * rpc
        smem = _smem_bytes(rpc, nw, W, A, True)
        if nw <= MAX_WARPS and smem <= SMEM_LIMIT:
            return DualRunPlan(c, 32 * nw, rpc, 1, "smem", smem)
        c *= 2
    rpc = -(-R // MAX_CLUSTER)
    nw = min(MAX_WARPS, rpc)
    while nw >= 1:
        rpw = 2 * -(-rpc // nw)
        for band in ("smem", "global"):
            smem = _smem_bytes(rpc, nw, W, A, band == "smem")
            if smem <= SMEM_LIMIT and (band == "global" or rpw <= 32):
                return DualRunPlan(MAX_CLUSTER, 32 * nw, rpc, rpw, band,
                                   smem)
        nw //= 2
    raise ValueError(
        f"no dual run plan for R={R}, W={W}, A={A}: {rpc} reads per CTA "
        f"need {smem} bytes of shared memory (limit {SMEM_LIMIT})"
    )


# ---------------------------------------------------------------------
# CUDA kernel: bind, launch


def _launcher():
    fn = cuda_build.library().run_extend_dual_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 28 + [
            ctypes.c_longlong, ctypes.c_void_p,
        ]
    return fn


def _shards_launcher():
    fn = cuda_build.library().run_extend_dual_shards_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 28
                       + [ctypes.c_longlong, ctypes.c_void_p])
    return fn


def _check_tables(mc_tab, imb_tab, dev) -> None:
    for name, tab in (("mc_tab", mc_tab), ("imb_tab", imb_tab)):
        if tab.dtype != torch.int32 or tab.device != dev or tab.dim() != 1 \
                or tab.shape[0] < 1 or not tab.is_contiguous():
            raise ValueError(f"{name}: need a non-empty contiguous int32 "
                             f"vector on {dev}")


def _buffers(R: int, W: int, args: DualRunArgs, plan: DualRunPlan, dev):
    """A launch's packed output (the kernel writes every field, the unused
    symbol slots included), record buffers and (band in device memory)
    scratch rows."""
    lay = dual_out_layout(R, args.a_real, args.max_steps)
    out = torch.empty(lay["syms2"][1], dtype=torch.int32, device=dev)
    rec_steps = torch.empty(REC_CAP, dtype=torch.int32, device=dev)
    rec_planes = torch.empty((4, REC_CAP, R), dtype=torch.int32, device=dev)
    scratch = (None if plan.band == "smem"
               else torch.empty((2, R, W), dtype=torch.int32, device=dev))
    return out, rec_steps, rec_planes, scratch


def _scalars(h1, h2, R, W, C, L, mc_tab, imb_tab, args: DualRunArgs,
             plan: DualRunPlan):
    """The ints of the C entries from the slots on, in their order, then
    the shared memory."""
    return (h1, h2, R, W, C, L, args.a_real, mc_tab.shape[0],
            imb_tab.shape[0], args.me_budget, args.other_cost,
            args.other_len, args.delta, int(args.l2), int(args.weighted),
            args.max_steps, int(args.lock1), int(args.lock2),
            int(args.allow_records), args.rec_min, int(args.mc_dyn), args.wc,
            int(args.et), plan.cluster, plan.threads, plan.reads_per_cta,
            plan.rows_per_warp, int(plan.band == "smem"), plan.smem_bytes)


def _raise_on(rc: int, R: int, W: int, args: DualRunArgs, plan,
              shards: int = 0) -> None:
    if rc != 0:
        why = _LAUNCH_ERRORS.get(rc, f"CUDA error {rc}")
        on = f", {shards} shards" if shards else ""
        raise RuntimeError(
            f"run_extend_dual kernel launch failed: {why} (R={R}, W={W}, "
            f"A={args.a_real}{on}, {plan})"
        )


def _counted(plan: DualRunPlan) -> None:
    run_extend_dual_cuda.launches += 1
    run_extend_dual_cuda.placements[plan.band] += 1
    run_extend_dual_cuda.last_plan = plan


def run_extend_dual_cuda(state, h1: int, h2: int, reads, rlen, mc_tab,
                         imb_tab, args: DualRunArgs):
    """Launch the CUDA dual run kernel on slots ``h1``/``h2``: one
    thread-block cluster of the geometry :func:`plan_run_dual` gives, the
    whole loop inside.  Same contract and outputs as
    :func:`run_extend_dual_plain`.  Raises on anything the kernel does
    not take, and when the launch is refused; never falls back.  The
    caller guarantees ``cons`` capacity ``C > clen + max_steps`` on both
    slots, as ``TorchScorer.run_extend_dual`` does.  Each launch adds one
    to ``run_extend_dual_cuda.launches`` and to its band placement's
    count in ``run_extend_dual_cuda.placements``;
    ``run_extend_dual_cuda.last_plan`` is the last launch's plan."""
    D = state["D"]
    dev = D.device
    if dev.type != "cuda":
        raise ValueError("run_extend_dual_cuda needs tensors on a CUDA device")
    B, R, W = D.shape
    C = state["cons"].shape[1]
    want = {
        "D": torch.int32, "e": torch.int32, "rmin": torch.int32,
        "er": torch.int32, "off": torch.int32, "act": torch.bool,
        "cons": torch.int32, "clen": torch.int32,
    }
    for name, dt in want.items():
        t = state[name]
        if t.dtype != dt or t.device != dev or not t.is_contiguous():
            raise ValueError(f"state[{name!r}]: need contiguous {dt} on {dev}")
    if reads.dtype != torch.int16 or reads.device != dev or reads.shape[0] != R:
        raise ValueError("reads: need contiguous int16 [R, L] on the state device")
    if rlen.dtype != torch.int32 or rlen.device != dev or rlen.shape != (R,):
        raise ValueError("rlen: need int32 [R] on the state device")
    _check_tables(mc_tab, imb_tab, dev)
    if not all(t.is_contiguous() for t in (reads, rlen)):
        raise ValueError("reads/rlen must be contiguous")
    if not (0 <= h1 < B and 0 <= h2 < B) or h1 == h2:
        raise ValueError(f"slots {h1}, {h2}: need two distinct slots < {B}")
    plan = plan_run_dual(R, W, args.a_real)
    launch = _launcher()
    out, rec_steps, rec_planes, scratch = _buffers(R, W, args, plan, dev)
    ptr = _ptr
    rc = launch(
        ptr(D), ptr(state["e"]), ptr(state["rmin"]), ptr(state["er"]),
        ptr(state["off"]), ptr(state["act"]), ptr(state["cons"]),
        ptr(state["clen"]), ptr(reads), ptr(rlen), ptr(mc_tab),
        ptr(imb_tab), ptr(scratch), ptr(out), ptr(rec_steps),
        ptr(rec_planes),
        *_scalars(h1, h2, R, W, C, reads.shape[1], mc_tab, imb_tab, args,
                  plan),
        cuda_build.stream_ptr(dev),
    )
    _raise_on(rc, R, W, args, plan)
    _counted(plan)
    return out, rec_steps, rec_planes


run_extend_dual_cuda.launches = 0
run_extend_dual_cuda.placements = {"smem": 0, "global": 0}
run_extend_dual_cuda.last_plan = None


def run_extend_dual_shards_cuda(states, h1: int, h2: int, reads, rlens,
                                mc_tab, imb_tab, args: DualRunArgs):
    """The dual kernel's shard instance: the dual run of slots ``h1``,
    ``h2`` of a read-sharded store whose shards (``states``, ``Rs`` reads
    each, with their ``reads`` and ``rlens``) share one card, in one
    launch for all of them, every row updated in place in its own shard
    and every symbol and length written to every shard.  Plan, tables
    (``mc_tab`` over the store's ``R + 1`` vote totals) and outputs are
    those of :func:`run_extend_dual_cuda` at the store's ``R = n Rs``, so
    the result is the unsharded kernel's on the gathered store, bit for
    bit.  Raises like :func:`run_extend_dual_cuda`; never falls back.
    Each launch adds one to ``run_extend_dual_cuda.launches`` and to
    ``run_extend_dual_shards_cuda.launches``."""
    table = branch_kernel.shard_records(states, reads, rlens)
    B, Rs, W = states[0]["D"].shape
    n = len(states)
    R = n * Rs
    C = states[0]["cons"].shape[1]
    dev = states[0]["D"].device
    _check_tables(mc_tab, imb_tab, dev)
    if not (0 <= h1 < B and 0 <= h2 < B) or h1 == h2:
        raise ValueError(f"slots {h1}, {h2}: need two distinct slots < {B}")
    plan = plan_run_dual(R, W, args.a_real)
    out, rec_steps, rec_planes, scratch = _buffers(R, W, args, plan, dev)
    rc = _shards_launcher()(
        _ptr(table), n, Rs, _ptr(mc_tab), _ptr(imb_tab), _ptr(scratch),
        _ptr(out), _ptr(rec_steps), _ptr(rec_planes),
        *_scalars(h1, h2, R, W, C, reads[0].shape[1], mc_tab, imb_tab, args,
                  plan),
        cuda_build.stream_ptr(dev),
    )
    _raise_on(rc, R, W, args, plan, n)
    _counted(plan)
    run_extend_dual_shards_cuda.launches += 1
    return out, rec_steps, rec_planes


run_extend_dual_shards_cuda.launches = 0


def run_extend_dual_shards_plain(states, h1: int, h2: int, reads, rlens,
                                 mc_tab, imb_tab, args: DualRunArgs):
    """The shard instance's plain version: slots ``h1``, ``h2`` of the
    shards gathered into one store (``state_io.gather_slots``), the plain
    dual loop on it, the result split back into the shards in place
    (``state_io.scatter_slots``)."""
    run_extend_dual_shards_plain.calls += 1
    state, rd, rl = state_io.gather_slots(states, [h1, h2], reads, rlens)
    out = run_extend_dual_plain(state, 0, 1, rd, rl, mc_tab, imb_tab, args)
    state_io.scatter_slots(states, [h1, h2], state)
    return out


run_extend_dual_shards_plain.calls = 0


def run_extend_dual_shards(states, h1: int, h2: int, reads, rlens, mc_tab,
                           imb_tab, args: DualRunArgs):
    """Dispatch rule of a sharded store's dual run (as
    ``run_kernel.run_extend_shards``'s)."""
    faults.check_kernel("run_dual")
    kind = shard_placement(states)
    if kind == "fused":
        return run_extend_dual_shards_cuda(states, h1, h2, reads, rlens,
                                           mc_tab, imb_tab, args)
    if kind == "plain":
        return run_extend_dual_shards_plain(states, h1, h2, reads, rlens,
                                            mc_tab, imb_tab, args)
    raise ValueError("no dual run kernel for shards on several devices")


def run_extend_dual(state, h1: int, h2: int, reads, rlen, mc_tab, imb_tab,
                    args: DualRunArgs):
    """Dispatch rule: CPU tensors run :func:`run_extend_dual_plain`, CUDA
    tensors launch the kernel; any other device raises, and so does an
    armed ``pallas_compile`` fault."""
    faults.check_kernel("run_dual")
    kind = state["D"].device.type
    if kind == "cuda":
        return run_extend_dual_cuda(state, h1, h2, reads, rlen, mc_tab,
                                    imb_tab, args)
    if kind == "cpu":
        return run_extend_dual_plain(state, h1, h2, reads, rlen, mc_tab,
                                     imb_tab, args)
    raise ValueError(f"no dual run kernel for device type {kind!r}")


class DualRunResult(NamedTuple):
    """Host view of one dual run's packed output (side ``k`` fields are
    tuples ``(side 1, side 2)``)."""

    steps: int
    code: int
    rec_count: int
    clen: Tuple[int, int]
    eds: Tuple[np.ndarray, np.ndarray]
    split: Tuple[np.ndarray, np.ndarray]
    reached: Tuple[np.ndarray, np.ndarray]
    act: Tuple[np.ndarray, np.ndarray]
    occ: Tuple[np.ndarray, np.ndarray]
    syms: Tuple[np.ndarray, np.ndarray]


def unpack(out_np: np.ndarray, R: int, A: int,
           max_steps: int) -> DualRunResult:
    """Split a fetched packed output (see :func:`dual_out_layout`)."""
    lay = dual_out_layout(R, A, max_steps)
    get = lambda name: out_np[lay[name][0]:lay[name][1]]  # noqa: E731
    sc = get("scalars")
    steps = int(sc[0])
    clen = (int(sc[3]), int(sc[4]))
    pair = lambda f: (f(1), f(2))  # noqa: E731
    return DualRunResult(
        steps, int(sc[1]), int(sc[2]), clen,
        pair(lambda k: get(f"eds{k}")), pair(lambda k: get(f"split{k}")),
        pair(lambda k: get(f"reached{k}").astype(bool)),
        pair(lambda k: get(f"act{k}").astype(bool)),
        pair(lambda k: get(f"occ{k}").reshape(R, A)),
        pair(lambda k: get(f"syms{k}")),
    )


def fetch(out, rec_steps, rec_planes, R: int, A: int, max_steps: int
          ) -> Tuple[DualRunResult, Optional[np.ndarray], Optional[np.ndarray]]:
    """One device-to-host copy of the packed output, plus the record rows
    (``[n]`` steps and ``[4, n, R]`` planes) when any were absorbed."""
    res = unpack(out.cpu().numpy(), R, A, max_steps)
    if not res.rec_count:
        return res, None, None
    n = res.rec_count
    return res, rec_steps[:n].cpu().numpy(), rec_planes[:, :n].cpu().numpy()
