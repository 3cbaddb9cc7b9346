"""The dual run loop behind ``TorchScorer.run_extend_dual``.

Three pieces, one contract, as in :mod:`~waffle_con_tpu_torch.ops.run_kernel`:

* :func:`run_extend_dual_plain` — the loop in plain PyTorch over the
  column primitives of :mod:`waffle_con_tpu_torch.ops.torch_scorer`, one
  step per iteration.  It is what runs for tensors on the CPU, and the
  yardstick the CUDA kernel is held to on the card.
* :func:`run_extend_dual_cuda` — the wrapper of the hand-written Hopper
  kernel ``csrc/run_extend_dual.cu`` (built by
  :mod:`~waffle_con_tpu_torch.ops.cuda_build`, bound with ``ctypes``); it
  counts its launches in ``run_extend_dual_cuda.launches``.
* :func:`run_extend_dual` — the dispatch rule: a state on the CPU runs
  the plain loop, a state on a CUDA device launches the kernel (or
  raises).

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

from waffle_con_tpu_torch.ops import cuda_build
from waffle_con_tpu_torch.ops.run_kernel import _wrap32
from waffle_con_tpu_torch.ops.torch_scorer import (
    REC_CAP,
    VOTE_EPS,
    col_step,
    finalized,
    gather_window,
    stats_core,
)

#: the "untracked side" cost of a read in the node-cost fold
BIG = 1 << 28
#: shared memory a CTA may use on Hopper (bytes)
SMEM_CAP = 232448
#: threads (and warps) of the kernel's one CTA
THREADS = 1024
WARPS = THREADS // 32


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


def _nominate(occ, split, w, wc: int, weighted: bool, mc_tab, mc_dyn: bool):
    """One side's vote fold and nomination (``_dual_votes`` +
    ``_nominate_side`` of the JAX package).  Returns ``(dirty, sym)``."""
    eps = float(VOTE_EPS)
    voting = (w > 0) & (split > 0)
    voters = (occ > 0) & voting[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=occ.device)
    frac = torch.where(
        split[:, None] > 0,
        occ.float() / split.clamp(min=1)[:, None].float(), zero,
    ) * w[:, None]
    counts = torch.where(voters, frac, zero).sum(0)
    has_votes = voters.any(0)
    if wc >= 0 and int(has_votes.sum()) > 1:
        # the dual fold recounts candidates after the wildcard drop
        has_votes[wc] = False
        counts[wc] = 0.0
    n_cands = int(has_votes.sum())
    dyadic = (split & (split - 1)) == 0
    exactable = not bool((voting & ~dyadic).any()) and not weighted
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
# CUDA kernel: bind, launch


def smem_bytes(R: int, A: int) -> int:
    """Dynamic shared memory of one launch (mirrors ``smem_bytes`` in
    ``csrc/run_extend_dual.cu``)."""
    return 4 * (23 * R + 5 * WARPS * A + 4 * A)


def _launcher():
    fn = cuda_build.library().run_extend_dual_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 16 + [ctypes.c_int] * 23 + [
            ctypes.c_void_p
        ]
    return fn


def run_extend_dual_cuda(state, h1: int, h2: int, reads, rlen, mc_tab,
                         imb_tab, args: DualRunArgs):
    """Launch the CUDA dual run kernel on slots ``h1``/``h2`` (one CTA,
    the whole loop inside).  Same contract and outputs as
    :func:`run_extend_dual_plain`.  Raises on anything the kernel does
    not take (the per-read shared memory caps R); never falls back.  The
    caller guarantees ``cons`` capacity ``C > clen + max_steps`` on both
    slots, as ``TorchScorer.run_extend_dual`` does."""
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
    for name, tab in (("mc_tab", mc_tab), ("imb_tab", imb_tab)):
        if tab.dtype != torch.int32 or tab.device != dev or tab.dim() != 1 \
                or tab.shape[0] < 1:
            raise ValueError(f"{name}: need a non-empty int32 vector on {dev}")
    if not all(t.is_contiguous() for t in (reads, rlen, mc_tab, imb_tab)):
        raise ValueError("reads/rlen/mc_tab/imb_tab must be contiguous")
    if not (0 <= h1 < B and 0 <= h2 < B) or h1 == h2:
        raise ValueError(f"slots {h1}, {h2}: need two distinct slots < {B}")
    if smem_bytes(R, args.a_real) > SMEM_CAP - 1024:  # static smem beside
        raise ValueError(
            f"R={R} reads x A={args.a_real} symbols need "
            f"{smem_bytes(R, args.a_real)} bytes of shared memory "
            f"(cap {SMEM_CAP})"
        )
    launch = _launcher()
    lay = dual_out_layout(R, args.a_real, args.max_steps)
    # zeroed: symbol slots past a side's commits stay 0, as in the plain loop
    out = torch.zeros(lay["syms2"][1], dtype=torch.int32, device=dev)
    rec_steps = torch.empty(REC_CAP, dtype=torch.int32, device=dev)
    rec_planes = torch.empty((4, REC_CAP, R), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, R, W), dtype=torch.int32, device=dev)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    rc = launch(
        ptr(D), ptr(state["e"]), ptr(state["rmin"]), ptr(state["er"]),
        ptr(state["off"]), ptr(state["act"]), ptr(state["cons"]),
        ptr(state["clen"]), ptr(reads), ptr(rlen), ptr(mc_tab),
        ptr(imb_tab), ptr(scratch), ptr(out), ptr(rec_steps),
        ptr(rec_planes),
        h1, h2, R, W, C, reads.shape[1], args.a_real, mc_tab.shape[0],
        imb_tab.shape[0],
        args.me_budget, args.other_cost, args.other_len, args.delta,
        int(args.l2), int(args.weighted), args.max_steps, int(args.lock1),
        int(args.lock2), int(args.allow_records), args.rec_min,
        int(args.mc_dyn), args.wc, int(args.et),
        cuda_build.stream_ptr(dev),
    )
    if rc != 0:
        raise RuntimeError(
            f"run_extend_dual kernel launch failed: CUDA error {rc} "
            f"(R={R}, W={W}, A={args.a_real})"
        )
    run_extend_dual_cuda.launches += 1
    return out, rec_steps, rec_planes


run_extend_dual_cuda.launches = 0


def run_extend_dual(state, h1: int, h2: int, reads, rlen, mc_tab, imb_tab,
                    args: DualRunArgs):
    """Dispatch rule: CPU tensors run :func:`run_extend_dual_plain`, CUDA
    tensors launch the kernel; any other device raises."""
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
