"""The K-node pop arena behind ``TorchScorer.run_arena``.

The arena resolves the pop competition among the engine's in-hand node
and up to ``K - 1`` next-best queue entries on the device.  It runs the
host's exact pop loop for the group — priority by (cost, length desc,
FIFO rank), both node kinds' tracker bookkeeping (threshold
constriction, per-length capacity, queue totals), the me-budget,
threshold, capacity and imbalance discards, each node's nomination and
its committed extensions — creates the children of clean vote splits on
the device, and stops before any pop the host must arbitrate.  The
contract is ``waffle_con_tpu``'s ``_j_arena`` (``ops/jax_scorer.py``)
with one event per iteration (its speculative ``cols`` unroll is
bit-identical to one event by construction, so it has no counterpart).

Pieces, in the style of :mod:`~waffle_con_tpu_torch.ops.run_kernel`:

* :func:`arena_plain` — the loop in plain PyTorch (column steps and
  stats) and numpy (the per-node decision records, the tournament and the
  trackers).  It runs for tensors on the CPU and is the yardstick the
  CUDA kernel is held to on the card.  Like the kernel it keeps every
  node's decision record and recomputes it only for the rows an event
  changed: a side's stats are a pure function of its row.
* :func:`plan_arena` — the kernel's launch geometry from the shape.
* :func:`arena_cuda` — the wrapper of the hand-written Hopper kernel
  ``csrc/arena.cu``: one thread-block cluster runs the whole loop, each
  CTA a block of reads and its own copy of the decisions, the rows
  stepped in place in the branch store.  Counted in
  ``arena_cuda.launches``.
* :func:`arena` — the dispatch rule: CPU tensors take the twin, CUDA
  tensors launch the kernel or raise.
* :func:`arena_shards` — the same on a read-sharded store whose shards
  share one device: one launch of the kernel's shard instance on a card
  (:func:`arena_shards_cuda`), :func:`arena_shards_plain` on the CPU.

Node ``n`` owns side rows ``2n`` and ``2n + 1`` (``slots[2n + s]`` of the
store).  ``kinds[n]`` is 0 (single), 1 (dual) or -1 (dead, or a creation
pool node).  Results come back as one packed ``int32`` tensor (see
:func:`arena_out_layout`): the history (``n`` commit, ``K + n`` discard,
``2K + n`` split, ``3K + j`` creation record ``j``), the symbols each
commit appended, per-node steps, alive flags and kinds, per-side lengths,
activity and stats (zero on sides no node owns), and the creation
records.  Stop codes: 1 host arbitration (votes, a finished side), 2 the
winner reached its end, 3 a rest-of-queue entry wins (or every node
died), 4 step limit (or a discard of the forced first pop), 5 band
overflow.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.ops import branch_kernel, cuda_build, state_io
from waffle_con_tpu_torch.ops.run_kernel import (
    MAX_CLUSTER,
    _ptr,
    shard_placement,
    MAX_WARPS,
    SMEM_LIMIT,
    _ring_len,
)
from waffle_con_tpu_torch.ops.torch_scorer import (
    CRE_PER_EVENT,
    VOTE_EPS,
    col_step,
    gather_window,
    stats_core,
)
from waffle_con_tpu_torch.runtime import faults

#: creation records of one arena call
CRE_CAP = 64
#: the tournament's cost of a dead node
BIGTOT = 2**31 - 1
#: the "untracked side" cost of a read in a dual node's cost fold
BIG = 1 << 28
#: int32 parameters at the head of the kernel's packed input
N_PARAMS = 24
#: nodes the kernel's tournament takes (two per lane of one warp)
MAX_K = 64
#: dense symbols the kernel's decision records take
MAX_A = 128

_F32 = np.float32
_EPS = _F32(VOTE_EPS)


class ArenaArgs(NamedTuple):
    """Per-call scalars of one arena call (host integers)."""

    me_budget: int
    min_count: int
    #: ``dual_max_ed_delta`` of the divergence pruning
    delta: int
    l2: bool
    weighted: bool
    #: priority of the best queue entry outside the arena
    rest_cost: int
    rest_len: int
    #: nodes handed in (node 0 is the in-hand pop)
    n_live: int
    max_queue: int
    #: per-length capacity of the trackers
    cap: int
    step_limit: int
    max_nwc: int
    #: 0 none, 1 singles, 2 singles + split pairs + dual cross products
    create_mode: int
    #: creation pool nodes (``n_live .. n_live + n_pool - 1``)
    n_pool: int
    #: clear-margin fractional splits allowed (``min_af == 0``)
    relax: bool
    #: ``mc_tab`` is a dynamic (``min_af != 0``) table
    mc_dyn: bool
    #: dense wildcard id, or -2
    wc: int
    et: bool
    #: real dense alphabet size
    a_real: int
    #: history capacity (``ARENA_CAP``)
    max_steps: int


def _params(args: ArenaArgs):
    """``args`` as the kernel's ``N_PARAMS`` int32 head (order fixed by
    ``csrc/arena.cu``)."""
    vals = [
        args.me_budget, args.min_count, args.delta, int(args.l2),
        int(args.weighted), args.rest_cost, args.rest_len, args.n_live,
        args.max_queue, args.cap, args.step_limit, args.max_nwc,
        args.create_mode, args.n_pool, int(args.relax), int(args.mc_dyn),
        args.wc, int(args.et), args.a_real, args.max_steps,
    ]
    return vals + [0] * (N_PARAMS - len(vals))


def arena_out_layout(K: int, R: int, A: int, max_steps: int
                     ) -> Dict[str, Tuple[int, int]]:
    """``name -> (start, stop)`` of each field of the packed ``int32``
    output: 8 scalars (nsteps, code, stop_node, cre_count, stop_diag),
    the history, the (sym1, sym2) of each history entry, per-node
    ``steps``/``alive``/``kinds``, per-side ``clen``, per-side ``[R]``
    rows of ``act``/``eds``/``split``/``reached``, per-side ``[R, A]``
    ``occ``, then the creation records' ``parent``, ``kind``, ``sym1``,
    ``sym2`` and ``len`` (``CRE_CAP`` each)."""
    S = 2 * K
    fields = [
        ("scalars", 8), ("hist", max_steps), ("evsym", 2 * max_steps),
        ("steps", K), ("alive", K), ("kinds", K), ("clen", S),
        ("act", S * R), ("eds", S * R), ("split", S * R),
        ("reached", S * R), ("occ", S * R * A),
        ("cre_parent", CRE_CAP), ("cre_kind", CRE_CAP),
        ("cre_sym1", CRE_CAP), ("cre_sym2", CRE_CAP), ("cre_len", CRE_CAP),
    ]
    out, at = {}, 0
    for name, n in fields:
        out[name] = (at, at + n)
        at += n
    return out


def arena_in_layout(K: int, Lw: int, MCN: int, IMBN: int
                    ) -> Dict[str, Tuple[int, int]]:
    """``name -> (start, stop)`` of the kernel's packed ``int32`` input:
    the parameters, ``slots [2K]``, ``kinds [K]``, the trackers' scalars
    ``tr [2, 4]`` (threshold, total, farthest, last constraint), the
    length and processed counts ``lc``/``pc`` ``[2, Lw]``, ``mc_tab`` and
    ``imb_tab``.  The kernel updates ``tr``/``lc``/``pc`` in place."""
    fields = [("params", N_PARAMS), ("slots", 2 * K), ("kinds", K),
              ("tr", 8), ("lc", 2 * Lw), ("pc", 2 * Lw), ("mc_tab", MCN),
              ("imb_tab", IMBN)]
    out, at = {}, 0
    for name, n in fields:
        out[name] = (at, at + n)
        at += n
    return out


def _wrap32(x):
    """Two's-complement int32 wrap (numpy int64 array or scalar)."""
    return ((np.asarray(x, dtype=np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _nominate(occ, split, w, args: ArenaArgs, mc_tab):
    """One side's vote fold and nomination (``_dual_votes`` +
    ``_nominate_side`` of the JAX package), in float32.  Returns
    ``(dirty, sym, counts, has_votes, exactable, mc, near_tie)``."""
    voting = (w > 0) & (split > 0)
    voters = (occ > 0) & voting[:, None]
    frac = np.where(
        split[:, None] > 0,
        occ.astype(_F32) / np.maximum(split, 1)[:, None].astype(_F32),
        _F32(0),
    ) * w[:, None]
    counts = np.where(voters, frac, _F32(0)).sum(0, dtype=_F32)
    has = voters.any(0)
    if args.wc >= 0 and int(has.sum()) > 1:
        has[args.wc] = False
        counts[args.wc] = _F32(0)
    n_cands = int(has.sum())
    dyadic = (split & (split - 1)) == 0
    exact = bool(np.where(voting, dyadic, True).all()) and not args.weighted
    n_vote_f = counts.sum(dtype=_F32)
    n_vote_r = np.round(n_vote_f)
    int_ok = bool(abs(n_vote_f - n_vote_r) < _EPS)
    tab_bad = bool(args.mc_dyn) and not int_ok
    exact = exact and not tab_bad
    mc = int(mc_tab[min(max(int(n_vote_r), 0), len(mc_tab) - 1)])
    mc_f = _F32(mc)
    maxc = np.where(has, counts, _F32(-1)).max()
    thr = min(mc_f, maxc)
    passing = has & (counts >= thr)
    npass = int(passing.sum())
    near = bool(abs(maxc - mc_f) < _EPS) or bool(
        (has & (np.abs(counts - thr) < _EPS)).any())
    dirty = ((not exact) and near) or npass != 1 or n_cands == 0 or tab_bad
    sym = int(np.argmax(np.where(passing, counts, _F32(-1))))
    return dirty, sym, counts, has, exact, mc, near


class _Records:
    """Every node's decision record (``node_eval`` of ``_j_arena``)."""

    def __init__(self, K: int, A: int):
        self.total = np.zeros(K, np.int64)
        self.reach = np.zeros(K, bool)
        self.dirty = np.zeros(K, bool)
        self.sym = np.zeros((K, 2), np.int64)
        self.imb = np.zeros(K, bool)
        self.fin = np.zeros((K, 2), bool)
        self.covf = np.zeros(K, bool)
        self.cnt = np.zeros((K, 2, A), _F32)
        self.hv = np.zeros((K, 2, A), bool)
        self.ex = np.zeros((K, 2), bool)
        self.mc = np.zeros((K, 2), np.int64)
        self.nt = np.zeros((K, 2), bool)


def _node_eval(rec: _Records, n: int, dual: bool, sides, clen2, args,
               mc_tab, imb_tab):
    """Record of node ``n`` from its sides' stats ``sides[s] = (eds,
    occ, split, reached, act)`` (side 2 ignored for a single node)."""
    eds1, occ1, split1, reached1, a1 = sides[0]
    R = len(a1)
    if dual:
        eds2, occ2, split2, reached2, a2 = sides[1]
    else:
        eds2 = np.zeros(R, np.int64)
        reached2 = a2 = np.zeros(R, bool)
    cost = lambda x: _wrap32(x * x) if args.l2 else x  # noqa: E731
    c1, c2 = cost(eds1.astype(np.int64)), cost(eds2.astype(np.int64))
    if dual:
        best = np.minimum(np.where(a1, c1, BIG), np.where(a2, c2, BIG))
        total = np.where(a1 | a2, best, 0).sum()
    else:
        total = np.where(a1, c1, 0).sum()
    rec.total[n] = int(_wrap32(total))
    rec.covf[n] = bool(args.l2) and max(
        int(np.where(a1, eds1, 0).max()), int(np.where(a2, eds2, 0).max())
    ) > 2048
    rr = (a1 & reached1) | (a2 & reached2)
    if args.et:
        fin1 = bool((reached1 | ~a1).all())
        fin2 = bool((reached2 | ~a2).all())
        rec.reach[n] = bool((rr | (~a1 & ~a2)).all()) if dual else fin1
    else:
        fin1 = bool((a1 & reached1).any())
        fin2 = bool((a2 & reached2).any())
        rec.reach[n] = bool(rr.any()) if dual else bool(reached1.any())
    rec.fin[n] = (fin1, fin2)
    both = a1 & a2
    c1f = np.maximum(eds1.astype(_F32), _F32(0.5))
    c2f = np.maximum(eds2.astype(_F32), _F32(0.5))
    denom = c1f + c2f
    use_w = bool(args.weighted) and dual
    one = lambda a: np.where(a, _F32(1), _F32(0))  # noqa: E731
    w1 = np.where(use_w & both, c2f / denom, one(a1)).astype(_F32)
    d1, s1, cnt1, hv1, ex1, mc1, nt1 = _nominate(occ1, split1, w1, args,
                                                 mc_tab)
    rec.cnt[n, 0], rec.hv[n, 0] = cnt1, hv1
    rec.ex[n, 0], rec.mc[n, 0], rec.nt[n, 0] = ex1, mc1, nt1
    dirty, s2 = d1, 0
    if dual:
        w2 = np.where(use_w & both, c1f / denom, one(a2)).astype(_F32)
        d2, s2, cnt2, hv2, ex2, mc2, nt2 = _nominate(
            sides[1][1], sides[1][2], w2, args, mc_tab)
        rec.cnt[n, 1], rec.hv[n, 1] = cnt2, hv2
        rec.ex[n, 1], rec.mc[n, 1], rec.nt[n, 1] = ex2, mc2, nt2
        dirty = d1 or d2 or fin1 or fin2
    else:
        rec.cnt[n, 1], rec.hv[n, 1] = 0, False
        rec.ex[n, 1], rec.mc[n, 1], rec.nt[n, 1] = False, 0, False
    rec.dirty[n] = dirty or rec.covf[n]
    rec.sym[n] = (s1, s2)
    nlen = max(clen2[0], clen2[1]) if dual else clen2[0]
    imb_v = int(imb_tab[min(max(nlen, 0), len(imb_tab) - 1)])
    rec.imb[n] = dual and (int(a1.sum()) < imb_v or int(a2.sum()) < imb_v)


def _split_specs(single: bool, n_children: int, pass_a, pass_b, cand_nw,
                 cnt_a, A: int):
    """Child ``t``'s ``(kind, symA, symB)`` in the host's exact
    ``_build_specs`` order: singles by ascending symbol, then split pairs
    over the non-wildcard candidates in (count desc, symbol asc) order
    (single parents); the cross product of both sides' passing symbols
    (dual parents)."""
    sa = np.flatnonzero(pass_a)
    sb = np.flatnonzero(pass_b)
    n_a = len(sa)
    key = np.where(cand_nw, -cnt_a, _F32(3e38))
    order = np.lexsort((np.arange(A), key))
    ncand = int(cand_nw.sum())
    specs = []
    for t in range(n_children):
        if not single:
            nb = max(len(sb), 1)
            specs.append((1, int(sa[t // nb]), int(sb[t % nb])))
        elif t < n_a:
            specs.append((0, int(sa[t]), 0))
        else:
            pp = t - n_a
            r = 0
            while pp >= ncand - 1 - r:
                pp -= ncand - 1 - r
                r += 1
            specs.append((1, int(order[r]), int(order[r + 1 + pp])))
    return specs


def arena_plain(state, reads, rlen, slots, kinds, lc, pc, tr, mc_tab,
                imb_tab, args: ArenaArgs):
    """The arena loop in plain PyTorch and numpy (same contract and
    output as the CUDA kernel).  ``slots`` ``[2K]``, ``kinds`` ``[K]``,
    ``lc``/``pc`` ``[2, Lw]``, ``tr`` ``[2, 4]``, ``mc_tab`` and
    ``imb_tab`` are host arrays (not modified); the store's rows at
    ``slots`` are stepped in place.  Returns the packed output on the
    store's device."""
    arena_plain.calls += 1
    st = state
    dev = st["D"].device
    _B, R, W = st["D"].shape
    C = st["cons"].shape[1]
    E = (W - 2) // 2
    A = args.a_real
    slots = np.asarray(slots, dtype=np.int64)
    kinds = np.array(kinds, dtype=np.int64)
    K = len(kinds)
    lc = np.array(lc, dtype=np.int64)
    pc = np.array(pc, dtype=np.int64)
    tr = np.array(tr, dtype=np.int64).reshape(2, 4)
    Lw = lc.shape[1]
    mc_tab = np.asarray(mc_tab, dtype=np.int64)
    imb_tab = np.asarray(imb_tab, dtype=np.int64)
    n_live = args.n_live
    n_lim = n_live + args.n_pool
    step_limit = args.step_limit
    max_steps = args.max_steps
    clen = st["clen"][torch.as_tensor(slots, device=dev)].cpu().numpy()
    clen = clen.astype(np.int64)
    rows = lambda fs: torch.as_tensor(slots[fs], device=dev)  # noqa: E731

    sides = {}  # side -> (eds, occ, split, reached, act), real sides only

    def refresh(fs):
        """Stats of sides ``fs`` from their store rows."""
        idx = rows(fs)
        off, act, cl = st["off"][idx], st["act"][idx], st["clen"][idx]
        got = stats_core(
            st["D"][idx], st["e"][idx], st["rmin"][idx], st["er"][idx], off,
            act, rlen, gather_window(reads, cl, off, E, W), cl, A, E)
        got = [x.cpu().numpy() for x in got] + [act.cpu().numpy()]
        for i, f in enumerate(fs):
            sides[f] = tuple(x[i] for x in got)

    rec = _Records(K, A)

    def evaluate(n):
        dual = kinds[n] == 1
        _node_eval(rec, n, dual, (sides[2 * n], sides.get(2 * n + 1)),
                   (int(clen[2 * n]), int(clen[2 * n + 1])), args, mc_tab,
                   imb_tab)

    live_sides = [f for n in range(n_live) for f in
                  ((2 * n, 2 * n + 1) if kinds[n] == 1 else (2 * n,))]
    refresh(live_sides)
    for n in range(n_live):
        evaluate(n)

    def step(srcs, syms):
        """New columns of sides ``srcs`` pushed by ``syms`` (nothing
        written)."""
        idx = rows(srcs)
        sym = torch.as_tensor(syms, dtype=torch.int32, device=dev)
        off, act, cl = st["off"][idx], st["act"][idx], st["clen"][idx]
        Dn, en, rminn, ern = col_step(
            st["D"][idx], st["e"][idx], st["rmin"][idx], st["er"][idx], off,
            act, rlen, gather_window(reads, cl, off, E, W), cl + 1, sym,
            args.wc, args.et, E)
        ovf = bool((act & (en >= E)).any())
        stepped[0] += int(act.sum())
        return (Dn, en, rminn, ern), act, ovf

    def write(dst, src, new, act_row, sym):
        """Row ``dst`` = row ``src`` advanced by ``sym`` (``new``)."""
        d, s = int(slots[dst]), int(slots[src])
        Dn, en, rminn, ern = new
        st["D"][d], st["e"][d], st["rmin"][d], st["er"][d] = Dn, en, rminn, ern
        st["act"][d] = act_row
        cons = st["cons"][s].clone()
        cons[min(max(int(clen[src]), 0), C - 1)] = sym
        st["cons"][d] = cons
        st["off"][d] = st["off"][s]
        clen[dst] = clen[src] + 1
        st["clen"][d] = int(clen[dst])

    def prune(new1, new2, act1, act2, dual):
        """Divergence pruning of a dual pair's new distances."""
        if not dual:
            return act1, act2
        both = act1 & act2
        e1, e2 = new1[1], new2[1]
        return (act1 & ~(both & (e2 + args.delta < e1)),
                act2 & ~(both & (e1 + args.delta < e2)))

    stepped = [0]  # active rows pushed by a column step, children's too
    hist = np.zeros(max_steps, np.int64)
    evsym = np.zeros((max_steps, 2), np.int64)
    steps = np.zeros(K, np.int64)
    seqv = np.arange(K, dtype=np.int64)
    fresh = np.arange(K) != 0
    alive = np.arange(K) < n_live
    seq_ctr = K + 1
    pool_next = n_live
    cre = np.zeros((5, CRE_CAP), np.int64)
    cre_count = 0
    nsteps = 0
    code = 0
    stop_diag = 0
    stop_node = 0
    sym_idx = np.arange(A)
    while code == 0:
        # ---- tournament: (cost, length desc, FIFO rank); node 0 first
        dualn = kinds == 1
        lens = np.where(dualn, np.maximum(clen[0::2], clen[1::2]), clen[0::2])
        totals = np.where(alive & (kinds >= 0), rec.total, BIGTOT)
        cand1 = totals == totals.min()
        cand2 = cand1 & (lens == np.where(cand1, lens, -1).max())
        win = int(np.argmin(np.where(cand2, seqv, 2**31 - 1)))
        first = nsteps == 0
        if first:
            win = 0
        wtot, wlen = int(totals[win]), int(lens[win])
        arena_empty = wtot == BIGTOT
        rest_wins = not first and (
            wtot > args.rest_cost
            or (wtot == args.rest_cost and wlen < args.rest_len)
            or (wtot == args.rest_cost and wlen == args.rest_len
                and not fresh[win]))
        # ---- tracker constriction of both kinds (not at the forced pop)
        if not first:
            for k_ in (0, 1):
                thr_, tot_, far_, lcon_ = (int(v) for v in tr[k_])
                while ((tot_ > args.max_queue or lcon_ >= args.max_nwc)
                       and thr_ < far_):
                    tot_ -= int(lc[k_, min(max(thr_, 0), Lw - 1)])
                    thr_ += 1
                    lcon_ = 0
                tr[k_] = (thr_, tot_, far_, lcon_)
        k = min(max(int(kinds[win]), 0), 1)
        thr, total_q, far, lcon = (int(v) for v in tr[k])
        li = min(max(wlen, 0), Lw - 1)
        discarded = (wtot > args.me_budget or wlen < thr
                     or pc[k, li] >= args.cap or bool(rec.imb[win]))
        discard_now = (not first and not rest_wins and not arena_empty
                       and discarded and nsteps < step_limit)

        # ---- creation decision
        single = kinds[win] == 0
        cA, cB = rec.cnt[win, 0], rec.cnt[win, 1]
        hvA, hvB = rec.hv[win, 0], rec.hv[win, 1]
        mcA, mcB = _F32(rec.mc[win, 0]), _F32(rec.mc[win, 1])
        passA = hvA & (cA >= min(mcA, np.where(hvA, cA, _F32(-1)).max()))
        passB = hvB & (cB >= min(mcB, np.where(hvB, cB, _F32(-1)).max()))
        nA, nB = int(passA.sum()), int(passB.sum())
        wc_mask = (args.wc >= 0) & (sym_idx == max(args.wc, 0))
        cand_nw = hvA & ~wc_mask
        ncand = int(cand_nw.sum())
        npass_mc = int((cand_nw & (cA >= mcA)).sum())
        n_pairs = (ncand * (ncand - 1) // 2
                   if args.create_mode >= 2 and npass_mc > 1 else 0)
        n_children = nA + n_pairs if single else nA * nB
        margA = bool(np.where(hvA, np.abs(cA - mcA) > _EPS, True).all())
        margB = bool(np.where(hvB, np.abs(cB - mcB) > _EPS, True).all())
        pairm = cand_nw[:, None] & cand_nw[None, :] & ~np.eye(A, dtype=bool)
        pair_ok = bool(np.where(
            pairm, np.abs(cA[:, None] - cA[None, :]) > _EPS, True).all())
        relaxA = bool(args.relax) and not rec.nt[win, 0] and margA
        relaxB = bool(args.relax) and not rec.nt[win, 1] and margB
        ord_ok = pair_ok or args.create_mode < 2
        exA, exB = bool(rec.ex[win, 0]), bool(rec.ex[win, 1])
        exact_ok = ((exA or (relaxA and ord_ok)) if single
                    else (exA or relaxA) and (exB or relaxB))
        kind_ok = single or (args.create_mode >= 2
                             and not rec.fin[win, 0] and not rec.fin[win, 1])
        gates = (
            exact_ok, kind_ok, n_children <= CRE_PER_EVENT,
            pool_next + n_children <= n_lim,
            cre_count + n_children <= CRE_CAP,
            nsteps + 1 + n_children <= step_limit,
        )
        splitable = (args.create_mode >= 1 and all(gates)
                     and not rec.covf[win] and n_children >= 2)
        want_split = (bool(rec.dirty[win]) and splitable
                      and not rec.reach[win] and not discarded
                      and not rest_wins and not arena_empty)
        stop_diag = n_children * 64 + sum(int(g) << i
                                          for i, g in enumerate(gates))
        if rest_wins or arena_empty:
            code = 3
        elif discarded:
            code = 4 if first or nsteps >= step_limit else 0
        elif rec.reach[win]:
            code = 2
        elif rec.dirty[win] and not want_split:
            code = 1
        elif nsteps >= step_limit:
            code = 4

        # ---- on-device child creation (atomic: an overflow writes none)
        split_commit = False
        if want_split:
            p1, p2 = 2 * win, 2 * win + 1
            specs = _split_specs(single, n_children, passA, passB, cand_nw,
                                 cA, A)
            srcs, syms = [], []
            for kind_t, sa, sb in specs:
                srcs.append(p1)
                syms.append(sa)
                if kind_t == 1:
                    srcs.append(p1 if single else p2)
                    syms.append(sb)
            new, act_src, ovf = step(srcs, syms)
            if ovf:
                code = 5
            else:
                split_commit = True
                at = 0
                nl = wlen + 1
                for t, (kind_t, sa, sb) in enumerate(specs):
                    c = pool_next + t
                    n1 = tuple(x[at] for x in new)
                    act1 = act_src[at]
                    src2 = p1 if single else p2
                    if kind_t == 1:
                        n2 = tuple(x[at + 1] for x in new)
                        act2 = act_src[at + 1]
                        act1n, act2n = prune(n1, n2, act1, act2, True)
                        write(2 * c, p1, n1, act1n, sa)
                        write(2 * c + 1, src2, n2, act2n, sb)
                        at += 2
                    else:
                        write(2 * c, p1, n1, act1, sa)
                        at += 1
                    kinds[c] = kind_t
                    alive[c] = True
                    seqv[c] = seq_ctr + t
                    fresh[c] = False
                    lc[kind_t, min(max(nl, 0), Lw - 1)] += 1
                    tr[kind_t, 1] += int(nl >= tr[kind_t, 0])
                    hist[min(max(nsteps + 1 + t, 0), max_steps - 1)] = (
                        3 * K + cre_count + t)
                    cre[:, min(cre_count + t, CRE_CAP - 1)] = (
                        win, kind_t, sa, sb, nl)
                new_sides = [f for t, (kind_t, _a, _b) in enumerate(specs)
                             for f in ((2 * (pool_next + t),
                                        2 * (pool_next + t) + 1)
                                       if kind_t == 1
                                       else (2 * (pool_next + t),))]
                refresh(new_sides)
                for t in range(n_children):
                    evaluate(pool_next + t)

        # ---- commit: the winner's side(s) advance by their nomination
        commit = False
        if code == 0 and not discard_now and not split_commit:
            s1 = 2 * win
            dual_w = kinds[win] == 1
            fs = [s1, s1 + 1] if dual_w else [s1]
            csyms = (int(rec.sym[win, 0]),
                     int(rec.sym[win, 1]) if dual_w else 0)
            new, act_src, ovf = step(fs, list(csyms[:len(fs)]))
            if ovf:
                code = 5
            else:
                commit = True
                n1 = tuple(x[0] for x in new)
                if dual_w:
                    n2 = tuple(x[1] for x in new)
                    a1n, a2n = prune(n1, n2, act_src[0], act_src[1], True)
                    write(s1, s1, n1, a1n, csyms[0])
                    write(s1 + 1, s1 + 1, n2, a2n, csyms[1])
                else:
                    write(s1, s1, n1, act_src[0], csyms[0])
                refresh(fs)
                evaluate(win)

        # ---- tracker bookkeeping and the history
        hp = min(max(nsteps, 0), max_steps - 1)
        if commit:
            if not first:
                lc[k, li] -= 1
                total_q -= int(wlen >= thr)
            pc[k, li] += 1
            lc[k, min(max(wlen + 1, 0), Lw - 1)] += 1
            total_q += int(wlen + 1 >= thr)
            tr[k] = (thr, total_q, max(far, wlen), lcon + 1)
            hist[hp] = win
            evsym[hp] = csyms
            steps[win] += 1
            seqv[win] = seq_ctr
            fresh[win] = False
            seq_ctr += 1
            nsteps += 1
        elif discard_now:
            lc[k, li] -= 1
            tr[k, 1] = total_q - int(wlen >= thr)
            hist[hp] = K + win
            alive[win] = False
            nsteps += 1
        elif split_commit:
            if not first:
                lc[k, li] -= 1
                tr[k, 1] -= int(wlen >= thr)
            tr[k, 2] = max(far, wlen)
            tr[k, 3] = lcon + 1
            pc[k, li] += 1
            hist[hp] = 2 * K + win
            alive[win] = False
            nsteps += 1 + n_children
            seq_ctr += n_children
            pool_next += n_children
            cre_count += n_children
        stop_node = win

    lay = arena_out_layout(K, R, A, max_steps)
    out = np.zeros(lay["cre_len"][1], dtype=np.int64)

    def put(name, value):
        a, b = lay[name]
        out[a:b] = np.asarray(value, dtype=np.int64).reshape(-1)

    put("scalars", [nsteps, code, stop_node, cre_count, stop_diag, 0, 0, 0])
    put("hist", hist)
    put("evsym", evsym)
    put("steps", steps)
    put("alive", alive)
    put("kinds", kinds)
    put("clen", clen)
    S = 2 * K
    planes = {name: np.zeros((S, R), np.int64)
              for name in ("act", "eds", "split", "reached")}
    occ = np.zeros((S, R, A), np.int64)
    for f, (eds, occ_f, split, reached, act) in sides.items():
        planes["eds"][f], planes["split"][f] = eds, split
        planes["reached"][f], planes["act"][f] = reached, act
        occ[f] = occ_f
    for name, plane in planes.items():
        put(name, plane)
    put("occ", occ)
    for i, name in enumerate(("cre_parent", "cre_kind", "cre_sym1",
                              "cre_sym2", "cre_len")):
        put(name, cre[i])
    arena_plain.stepped_rows = stepped[0]
    return torch.from_numpy(out.astype(np.int32)).to(dev)


arena_plain.calls = 0
#: rows the last call stepped (the kernel steps the same rows)
arena_plain.stepped_rows = 0


# ---------------------------------------------------------------------
# launch planner of the CUDA kernel


class ArenaPlan(NamedTuple):
    """Launch geometry of one ``arena`` kernel call: one thread-block
    cluster.  The unit of work is a (side, read) row; both sides of a read
    sit in one CTA, and a row belongs to one warp for the whole call."""

    #: CTAs of the one thread-block cluster
    cluster: int
    #: threads of each CTA (32 per warp)
    threads: int
    #: reads of each CTA (contiguous blocks; the last CTA may own fewer)
    reads_per_cta: int
    #: rows of a commit each warp steps (row ``q = side * reads_per_cta +
    #: local read`` belongs to warp ``q % warps``)
    rows_per_warp: int
    #: ``"smem"``: each row staged in shared memory for its column step,
    #: the new column kept there until the commit; ``"global"``: the step
    #: runs on device memory through a scratch row
    band: str
    #: where each CTA's copy of the records' vote rows lives (``"smem"``
    #: or ``"global"``, a per-CTA copy in device memory)
    records: str
    #: where each CTA's copy of the trackers ``lc``/``pc`` lives
    trackers: str
    #: node records folded per cluster barrier (a split's children, the
    #: initial records); a commit folds one
    fold_nodes: int
    #: dynamic shared memory of each CTA, bytes
    smem_bytes: int


#: (side, read) rows a CTA holds at one row per warp
ROWS_PER_CTA = 16
#: min-count table entries each CTA keeps in shared memory
MC_CACHE = 256


def _stage_words(W: int) -> int:
    """Words of a row's staging area (``stage_words`` in
    ``csrc/arena.cu``): two ``[W]`` columns and a ring of the read's
    symbols (``ring_len(W)`` int16 slots), rounded up to 4 words."""
    return (2 * W + _ring_len(W) // 2 + 3) & ~3


def _part_words(A: int) -> int:
    """Words of one node partial: 8 header words (three sums, a maximum,
    the flags), then has[A] and counts[A] per side (``clu::Layout<3, 1,
    2>`` in ``csrc/cluster_ops.cuh``)."""
    return (8 + 4 * A + 3) & ~3


def _smem_bytes(K: int, A: int, rpc: int, csize: int, fold_nodes: int,
                W: int, Lw: int, band: bool, records: bool,
                trackers: bool) -> int:
    """Dynamic shared memory of one CTA (``smem_words`` and ``carve`` in
    ``csrc/arena.cu``): the CTA's node partials and every CTA's by parity,
    16 words per node (its record's scalars, tournament fields and sides'
    lengths), 136 decision words, the winner's passing symbols and
    candidate order, the row words, tip histograms and vote terms of a
    fold round, the parameters and slots, the head of the min-count
    table, 8 words of staging state per commit row; with ``band`` a
    staging area per commit row, with ``records`` the records' vote rows
    (float32 counts and has-vote flags, ``[K, 2, A]`` each), with
    ``trackers`` ``lc`` and ``pc`` (``[2, Lw]`` each)."""
    P = _part_words(A)
    words = (fold_nodes * P + 2 * fold_nodes * csize * P + 16 * K + 136
             + 3 * A + 2 * fold_nodes * rpc * (9 + 2 * A) + N_PARAMS + 2 * K
             + MC_CACHE + 2 * rpc * 8)
    if band:
        words += 2 * rpc * _stage_words(W)
    if records:
        words += 4 * K * A
    if trackers:
        words += 4 * Lw
    return 4 * words


def _place(on_chip: bool) -> str:
    return "smem" if on_chip else "global"


def plan_arena(K: int, R: int, W: int, A: int, Lw: int, C: int) -> ArenaPlan:
    """The arena kernel's launch geometry for ``K`` nodes, ``R`` reads,
    band width ``W``, ``A`` dense symbols, tracker windows of ``Lw``
    lengths and a consensus capacity of ``C``.  The rule:

    * the smallest cluster (1, 2, 4, 8 or 16 CTAs) whose CTAs hold at most
      16 (side, read) rows, both sides of a read in one CTA, one row per
      warp; else 16 CTAs of 16 warps, several rows per warp;
    * placements, as long as a CTA's shared memory holds them, in this
      order of need: the band staged (every commit row, both columns and
      a ring of its read's symbols), the trackers, the records' vote rows,
      and 8 node records a fold round; short of room the fold round
      shrinks first (to 1), then the records, the trackers and last the
      band move to device memory.

    At the dual north star (R=64, W=258, A=4, Lw=8192) that is 8 CTAs of
    16 warps with everything in shared memory.  Raises ``ValueError`` on
    any shape the kernel does not take (``K`` above 64, ``A`` above 128,
    an odd or narrow band, an empty read set or tracker window, a
    consensus capacity below 2, per-CTA state beyond shared memory)."""
    if not (1 <= K <= MAX_K and R >= 1 and 1 <= A <= MAX_A and W >= 4
            and W % 2 == 0 and Lw >= 1 and C >= 2):
        raise ValueError(
            f"no arena plan for K={K}, R={R}, W={W}, A={A}, Lw={Lw}, C={C}")
    c = 1
    while c < MAX_CLUSTER and 2 * -(-R // c) > ROWS_PER_CTA:
        c *= 2
    rpc = -(-R // c)
    nw = min(MAX_WARPS, 2 * rpc)
    rpw = -(-2 * rpc // nw)
    for band in (True, False):
        for trackers in (True, False):
            for records in (True, False):
                for fold in (8, 4, 2, 1):
                    smem = _smem_bytes(K, A, rpc, c, fold, W, Lw, band,
                                       records, trackers)
                    if smem <= SMEM_LIMIT:
                        return ArenaPlan(c, 32 * nw, rpc, rpw, _place(band),
                                         _place(records), _place(trackers),
                                         fold, smem)
    raise ValueError(f"no arena plan for K={K}, R={R}, A={A}: {rpc} reads "
                     f"per CTA need {smem} bytes of shared memory (limit "
                     f"{SMEM_LIMIT})")


def scratch_words(plan: ArenaPlan, K: int, R: int, W: int, A: int,
                  Lw: int) -> int:
    """Words of the kernel's device-memory scratch: the commit's new
    columns ``[2, R, W]`` (band in device memory), then per CTA the
    records' vote rows ``[4, K, A]`` and the trackers ``[4, Lw]`` where
    the plan keeps them in device memory (at least one word)."""
    words = 2 * R * W if plan.band == "global" else 0
    if plan.records == "global":
        words += plan.cluster * 4 * K * A
    if plan.trackers == "global":
        words += plan.cluster * 4 * Lw
    return max(words, 1)


# ---------------------------------------------------------------------
# CUDA kernel: bind, launch

_ERRORS = {-1: "the plan does not match the kernel",
           -2: "no cluster of the plan's shape fits on the device"}


def _launcher():
    fn = cuda_build.library().arena_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 18 + [
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    return fn


#: the profiled variant's output: clock64 totals of each part of an event
#: (the tournament and decisions, the row step, the commit write-back, the
#: record fold, the finish), of the whole launch, and the loop's events
PROF_FIELDS = ("decide", "step", "write_back", "fold", "finish", "total",
               "events")


def _shards_launcher():
    fn = cuda_build.library().arena_shards_launch
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 18
                       + [ctypes.c_longlong, ctypes.c_void_p,
                          ctypes.c_void_p])
    return fn


def _launch_io(slots, kinds, lc, pc, tr, mc_tab, imb_tab, args: ArenaArgs,
               B: int, R: int, W: int, C: int, dev, profile):
    """Checks a call's slots and profile buffer, plans it and packs its
    host inputs: ``(plan, in buffer, out, scratch, the C entries' ints from
    R on)``; the caller passes ``B`` and the store in front of them."""
    slots = np.asarray(slots, dtype=np.int64)
    K = len(kinds)
    if slots.shape != (2 * K,) or len(set(slots.tolist())) != 2 * K or (
            slots.min() < 0 or slots.max() >= B):
        raise ValueError(f"slots: need {2 * K} distinct slots < {B}")
    if profile is not None and (
            profile.dtype != torch.int64 or profile.device != dev
            or profile.shape != (len(PROF_FIELDS),)):
        raise ValueError(f"profile: need int64 [{len(PROF_FIELDS)}] on {dev}")
    lc = np.asarray(lc)
    Lw = lc.shape[1]
    A = args.a_real
    plan = plan_arena(K, R, W, A, Lw, C)
    mc_tab = np.asarray(mc_tab, dtype=np.int64)
    imb_tab = np.asarray(imb_tab, dtype=np.int64)
    lay_in = arena_in_layout(K, Lw, len(mc_tab), len(imb_tab))
    host = np.empty(lay_in["imb_tab"][1], dtype=np.int32)
    for name, value in (("params", _params(args)), ("slots", slots),
                        ("kinds", kinds), ("tr", tr), ("lc", lc),
                        ("pc", pc), ("mc_tab", mc_tab),
                        ("imb_tab", imb_tab)):
        a, b = lay_in[name]
        host[a:b] = np.asarray(value, dtype=np.int64).reshape(-1)
    buf = torch.from_numpy(host).to(dev, non_blocking=False)
    lay = arena_out_layout(K, R, A, args.max_steps)
    out = torch.empty(lay["cre_len"][1], dtype=torch.int32, device=dev)
    scratch = torch.empty(scratch_words(plan, K, R, W, A, Lw),
                          dtype=torch.int32, device=dev)
    return plan, buf, out, scratch, (
        len(mc_tab), len(imb_tab), args.max_steps, plan.cluster,
        plan.threads, plan.reads_per_cta, plan.fold_nodes,
        int(plan.band == "smem"), int(plan.records == "smem"),
        int(plan.trackers == "smem"), plan.smem_bytes)


def _raise_on(rc: int, K: int, R: int, W: int, A: int, plan,
              shards: int = 0) -> None:
    if rc != 0:
        why = _ERRORS.get(rc, f"CUDA error {rc}")
        on = f", {shards} shards" if shards else ""
        raise RuntimeError(f"arena kernel launch failed: {why} (K={K}, "
                           f"R={R}, W={W}, A={A}{on}, {plan})")


def _counted(plan: ArenaPlan) -> None:
    arena_cuda.launches += 1
    arena_cuda.placements[plan.band] += 1
    arena_cuda.last_plan = plan


def arena_cuda(state, reads, rlen, slots, kinds, lc, pc, tr, mc_tab,
               imb_tab, args: ArenaArgs, profile=None):
    """Launch ``csrc/arena.cu``: one thread-block cluster of the
    geometry :func:`plan_arena` gives runs the whole loop, stepping the
    rows at ``slots`` in place in the branch store.  Same contract and output as
    :func:`arena_plain`; the host inputs go up in one packed copy.
    Raises on anything the kernel does not take and when the launch is
    refused; never falls back.  Each launch adds one to
    ``arena_cuda.launches``.  ``profile``, an int64 tensor of
    ``len(PROF_FIELDS)`` on the device, launches the profiled variant of
    the same source, which fills it (see :data:`PROF_FIELDS`)."""
    D = state["D"]
    dev = D.device
    if dev.type != "cuda":
        raise ValueError("arena_cuda needs tensors on a CUDA device")
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
    if (reads.dtype != torch.int16 or reads.device != dev
            or reads.shape[0] != R or not reads.is_contiguous()):
        raise ValueError("reads: need contiguous int16 [R, L] on the state device")
    if rlen.dtype != torch.int32 or rlen.device != dev or rlen.shape != (R,):
        raise ValueError("rlen: need int32 [R] on the state device")
    K, A = len(kinds), args.a_real
    plan, buf, out, scratch, ints = _launch_io(
        slots, kinds, lc, pc, tr, mc_tab, imb_tab, args, B, R, W, C, dev,
        profile)
    rc = _launcher()(
        _ptr(D), _ptr(state["e"]), _ptr(state["rmin"]), _ptr(state["er"]),
        _ptr(state["off"]), _ptr(state["act"]), _ptr(state["cons"]),
        _ptr(state["clen"]), _ptr(reads), _ptr(rlen), _ptr(buf), _ptr(out),
        _ptr(scratch), B, R, W, C, reads.shape[1], A, K,
        np.asarray(lc).shape[1], *ints, _ptr(profile),
        cuda_build.stream_ptr(dev),
    )
    _raise_on(rc, K, R, W, A, plan)
    _counted(plan)
    return out


arena_cuda.launches = 0
arena_cuda.placements = {"smem": 0, "global": 0}
arena_cuda.last_plan = None


def arena_shards_cuda(states, reads, rlens, slots, kinds, lc, pc, tr,
                      mc_tab, imb_tab, args: ArenaArgs, profile=None):
    """The arena kernel's shard instance: the call on a read-sharded
    store whose shards (``states``, ``Rs`` reads each and the same slots,
    with their ``reads`` and ``rlens``) share one card, in one launch for
    all of them: every row stepped in place in its own shard, every
    consensus row and length written to every shard.  Plan, inputs and
    output are those of :func:`arena_cuda` at the store's ``R = n Rs``, so
    the result is the unsharded kernel's on the gathered store, bit for
    bit.  Raises like :func:`arena_cuda`; never falls back.  Each launch
    adds one to ``arena_cuda.launches`` and to
    ``arena_shards_cuda.launches``."""
    table = branch_kernel.shard_records(states, reads, rlens)
    B, Rs, W = states[0]["D"].shape
    n = len(states)
    R = n * Rs
    C = states[0]["cons"].shape[1]
    dev = states[0]["D"].device
    K, A = len(kinds), args.a_real
    plan, buf, out, scratch, ints = _launch_io(
        slots, kinds, lc, pc, tr, mc_tab, imb_tab, args, B, R, W, C, dev,
        profile)
    rc = _shards_launcher()(
        _ptr(table), n, Rs, _ptr(buf), _ptr(out), _ptr(scratch), B, R, W, C,
        reads[0].shape[1], A, K, np.asarray(lc).shape[1], *ints,
        _ptr(profile), cuda_build.stream_ptr(dev),
    )
    _raise_on(rc, K, R, W, A, plan, n)
    _counted(plan)
    arena_shards_cuda.launches += 1
    return out


arena_shards_cuda.launches = 0


def arena_shards_plain(states, reads, rlens, slots, kinds, lc, pc, tr,
                       mc_tab, imb_tab, args: ArenaArgs):
    """The shard instance's plain version: the call's ``2K`` slots of the
    shards gathered into one store (``state_io.gather_slots``, slot ``i``
    of it ``slots[i]``), :func:`arena_plain` on it, the result split back
    into the shards in place (``state_io.scatter_slots``)."""
    arena_shards_plain.calls += 1
    slots = [int(x) for x in slots]
    state, rd, rl = state_io.gather_slots(states, slots, reads, rlens)
    out = arena_plain(state, rd, rl, list(range(len(slots))), kinds, lc, pc,
                      tr, mc_tab, imb_tab, args)
    state_io.scatter_slots(states, slots, state)
    return out


arena_shards_plain.calls = 0


def arena_shards(states, reads, rlens, slots, kinds, lc, pc, tr, mc_tab,
                 imb_tab, args: ArenaArgs):
    """Dispatch rule of a sharded store's arena (as
    ``run_kernel.run_extend_shards``'s)."""
    faults.check_kernel("arena")
    kind = shard_placement(states)
    if kind == "fused":
        fn = arena_shards_cuda
    elif kind == "plain":
        fn = arena_shards_plain
    else:
        raise ValueError("no arena kernel for shards on several devices")
    return fn(states, reads, rlens, slots, kinds, lc, pc, tr, mc_tab,
              imb_tab, args)


def arena(state, reads, rlen, slots, kinds, lc, pc, tr, mc_tab, imb_tab,
          args: ArenaArgs):
    """Dispatch rule: CPU tensors take :func:`arena_plain`, CUDA tensors
    launch :func:`arena_cuda`; any other device raises, and so does an
    armed ``pallas_compile`` fault."""
    faults.check_kernel("arena")
    kind = state["D"].device.type
    if kind == "cuda":
        fn = arena_cuda
    elif kind == "cpu":
        fn = arena_plain
    else:
        raise ValueError(f"no arena kernel for device type {kind!r}")
    return fn(state, reads, rlen, slots, kinds, lc, pc, tr, mc_tab, imb_tab,
              args)


class ArenaResult(NamedTuple):
    """Host view of one arena call's packed output."""

    nsteps: int
    code: int
    stop_node: int
    cre_count: int
    stop_diag: int
    hist: np.ndarray
    evsym: np.ndarray
    steps: np.ndarray
    alive: np.ndarray
    kinds: np.ndarray
    clen: np.ndarray
    act: np.ndarray
    eds: np.ndarray
    split: np.ndarray
    reached: np.ndarray
    occ: np.ndarray
    cre: np.ndarray


def unpack(out_np: np.ndarray, K: int, R: int, A: int,
           max_steps: int) -> ArenaResult:
    """Split a fetched packed output (see :func:`arena_out_layout`)."""
    lay = arena_out_layout(K, R, A, max_steps)
    get = lambda name: out_np[lay[name][0]:lay[name][1]]  # noqa: E731
    sc = get("scalars")
    plane = lambda name: get(name).reshape(2 * K, R)  # noqa: E731
    return ArenaResult(
        int(sc[0]), int(sc[1]), int(sc[2]), int(sc[3]), int(sc[4]),
        get("hist"), get("evsym").reshape(max_steps, 2), get("steps"),
        get("alive").astype(bool), get("kinds"), get("clen"),
        plane("act").astype(bool), plane("eds"), plane("split"),
        plane("reached").astype(bool), get("occ").reshape(2 * K, R, A),
        np.stack([get(n) for n in ("cre_parent", "cre_kind", "cre_sym1",
                                   "cre_sym2", "cre_len")]),
    )


def fetch(out, K: int, R: int, A: int, max_steps: int) -> ArenaResult:
    """One device-to-host copy of the packed output."""
    return unpack(out.cpu().numpy(), K, R, A, max_steps)
