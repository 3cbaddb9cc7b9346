"""The frontier gang: same-search speculation through one gang launch.

The port's counterpart of the self-gang half of ``waffle_con_tpu``'s
``ops/ragged.py``.  Alongside the in-hand node's ``run_extend`` the
engines advance the next-best queued branches of the same search in one
launch (:class:`FrontierGang`, driven by
:class:`~waffle_con_tpu_torch.models.frontier.FrontierSpeculator`).  Each
member's post-run state is kept as a consume-once deposit
(:class:`_SpecInjected`); no slot is touched at gang time, and a deposit
is used only when the member's own pop makes a call it validates
(``TorchScorer._spec_consume``), so every gang width is byte-identical to
M = 1.

Pieces:

* :func:`ragged_plain` — the plain PyTorch twin of the JAX package's
  ``_j_run_ragged`` (``BandArena._build_kernel``): the K=1 run body over a
  pool of member rows with per-row ``(off, act, seg, wrow)`` descriptors,
  every per-branch fold a segment reduce.  Same arguments and outputs
  (mixed band strides included), so the tests hold it to JAX.
* :class:`FrontierGang` — gathers nothing to the host: the member slots
  are read on the device by the gang launch
  (:func:`~waffle_con_tpu_torch.ops.ragged_kernel.run_ragged`: the CUDA
  kernel ``csrc/run_ragged.cu`` on a CUDA device, :func:`ragged_plain` on
  the CPU), the post-states stay in device deposit buffers, and only the
  control scalars and the final stats come to the host in one packed
  fetch.  Consuming a deposit is a device copy into the slot.

What decides "no gang" is settled before the launch and counted in the
scorer's counters: fewer than two members (``gang_skip_members``), a
member whose run could need more consensus capacity
(``gang_skip_capacity``), a member with a pending deposit
(``gang_skip_pending``), the gang planner's refusal
(``plan_refused_ragged``).  A member whose slot does not hold the
engine's consensus length runs nothing in the launch and gets no deposit
(``gang_skip_desync``); the launch still counts as a group
(``gang_groups``), and only the in-step members count in
``gang_members``.  A failed build or launch raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

#: columns of the per-member parameter rows ``jp [G + 1, 10]`` of
#: :func:`ragged_plain`: in_group, me_budget, other_cost, other_len,
#: min_count, l2, max_steps, first_sym, wildcard, early termination
JP_COLS = 10


def serving_active() -> bool:
    """True inside a serving scope, where the cross-job dispatcher owns
    batching and engines must not self-gang.  The port has no serving
    layer yet (``serve_scope`` comes with the serving pool), so this is
    always False."""
    return False


# ======================================================================
# the plain PyTorch twin of _j_run_ragged


def _seg_any(x, seg, G1: int):
    return torch.zeros(G1, dtype=torch.int32, device=x.device).scatter_reduce(
        0, seg, x.to(torch.int32), "amax") > 0


def _seg_max0(x, seg, G1: int):
    """Per-segment maximum of non-negative int32 values (0 when empty)."""
    return torch.zeros(G1, dtype=x.dtype, device=x.device).scatter_reduce(
        0, seg, x, "amax")


def seg_vote_fold(occ, split, seg, G1: int):
    """Per-segment sums of each row's fractional tip votes ``occ /
    split`` (float32, rows added in row order): ``[G1, A]``."""
    frac = torch.where(
        split[:, None] > 0,
        occ.to(torch.float32)
        / split.clamp(min=1)[:, None].to(torch.float32),
        torch.zeros((), dtype=torch.float32, device=occ.device),
    )
    out = torch.zeros((G1, occ.shape[1]), dtype=torch.float32,
                      device=occ.device)
    return out.index_add_(0, seg, frac)


def ragged_plain(reads, rlen, D0, e0, rmin0, er0, off, act, seg, wrow,
                 cons0, clen0, jp, A: int):
    """The JAX package's ``_j_run_ragged`` in plain PyTorch.

    Inputs: ``reads [P, L]`` int16 (each row its member's read), ``rlen
    [P]``, ``D0 [P, W]`` int32, ``e0``/``rmin0``/``er0``/``off`` ``[P]``,
    ``act [P]`` bool, ``seg [P]`` (the row's member; ``G`` marks a padding
    row), ``wrow [P]`` (the row's band width, at most ``W``), ``cons0 [G +
    1, C]``, ``clen0 [G + 1]``, ``jp [G + 1, 10]`` (:data:`JP_COLS`).  Each
    member: a forced first push when ``first_sym >= 0`` (only band
    overflow refuses it, code 5), then one symbol a step until a stop code
    3 (over budget or loses the pop) > 2 (reached; records are never
    absorbed) > 1 (dirty) > 4 (``max_steps``), or 5 (overflow after the
    column step).  Returns ``(D, e, rmin, er, cons, clen, steps, code,
    iters, eds, occ, split, reached, fin, fin_ovf)``: the state at the
    stop, per-member ``steps``/``code``/``iters`` (live iterations), and
    the stats of the stopped state."""
    dev = D0.device
    i32 = torch.int32
    P, W = D0.shape
    L = reads.shape[1]
    G1, C = cons0.shape
    INF = 1 << 20
    eps = float(np.float32(1e-2))  # VOTE_EPS
    seg = seg.long()
    reads = reads.to(i32)
    jp = jp.to(i32)
    in_group = jp[:, 0] != 0
    me_budget, other_cost, other_len = jp[:, 1], jp[:, 2], jp[:, 3]
    min_count_f = jp[:, 4].to(torch.float32)
    l2 = jp[:, 5] != 0
    max_steps, first_sym, wc = jp[:, 6], jp[:, 7], jp[:, 8]
    et = jp[:, 9] != 0
    l2_r, wc_r, et_r = l2[seg], wc[seg], et[seg]
    t = torch.arange(W, dtype=i32, device=dev)[None, :]
    gi = torch.arange(G1, device=dev)
    erow = torch.div(wrow - 2, 2, rounding_mode="floor")
    wmask = t < wrow[:, None]
    a_idx = torch.arange(A, dtype=i32, device=dev)

    def gather(i):
        return torch.gather(reads, 1, i.clamp(0, L - 1).long())

    def col_step(D, e, rmin, er, jnew_r, sym_r):
        i_new = jnew_r[:, None] - off[:, None] - erow[:, None] + t
        bchar = gather(i_new - 1)
        sub = ((bchar != sym_r[:, None]) & (bchar != wc_r[:, None])).to(i32)
        diag = D + sub
        dele = torch.cat(
            [D[:, 1:], torch.full_like(D[:, :1], INF)], dim=1) + 1
        base = torch.minimum(diag, dele)
        invalid = (i_new < 0) | (i_new > rlen[:, None]) | ~wmask
        base = torch.where(invalid, INF, base)
        chain = torch.cummin(base - t, dim=1).values
        Dn = torch.minimum(torch.minimum(base, chain + t),
                           torch.tensor(INF, dtype=i32, device=dev))
        # the columns past a row's stride back to the sentinel before
        # any reduce (the insertion chain puts finite values there)
        Dn = torch.where(wmask, Dn, INF)
        colmin = Dn.amin(1)
        rend = torch.where(i_new == rlen[:, None], Dn, INF).amin(1)
        rmin_n = torch.minimum(rmin, rend)
        e_unc = torch.maximum(e, colmin)
        e_cap = torch.where(
            er < INF, e,
            torch.maximum(e, torch.minimum(colmin,
                                           torch.maximum(e, rmin_n))))
        e_n = torch.where(et_r, e_cap, e_unc)
        er_n = torch.where(
            er < INF, er,
            torch.where(rmin_n <= e_n, torch.maximum(e, rmin_n), INF))
        return (torch.where(act[:, None], Dn, D).to(i32),
                torch.where(act, e_n, e).to(i32),
                torch.where(act, rmin_n, rmin).to(i32),
                torch.where(act, er_n, er).to(i32))

    def stats_rows(D, e, er, clen):
        i = clen[seg][:, None] - off[:, None] - erow[:, None] + t
        vchar = gather(i)
        tip = (act[:, None] & (D <= e[:, None]) & wmask & (i >= 0)
               & (i < rlen[:, None]))
        onehot = (vchar[:, :, None] == a_idx) & tip[:, :, None]
        occ = onehot.sum(1, dtype=i32)
        split = occ.sum(1, dtype=i32)
        reached = act & (er < INF) & (e == er)
        eds = torch.where(act, e, 0).to(i32)
        return eds, occ, split, reached

    # forced first push per member: only band overflow refuses it
    force = in_group & (first_sym >= 0)
    clen = clen0.to(i32).clone()
    Df, ef, rminf, erf = col_step(D0, e0, rmin0, er0, (clen + 1)[seg],
                                  first_sym[seg])
    fovf = _seg_any(act & (ef >= erow), seg, G1)
    fcommit = force & ~fovf
    code = torch.where(force & fovf, 5, 0).to(i32)
    cons = cons0.to(i32).clone()
    cpos = clen.clamp(0, C - 1).long()
    cons[gi, cpos] = torch.where(fcommit, first_sym, cons[gi, cpos])
    fm = fcommit[seg]
    D = torch.where(fm[:, None], Df, D0)
    e = torch.where(fm, ef, e0)
    rmin = torch.where(fm, rminf, rmin0)
    er = torch.where(fm, erf, er0)
    clen = clen + fcommit.to(i32)
    steps = fcommit.to(i32)
    iters = torch.zeros(G1, dtype=i32, device=dev)

    while bool((in_group & (code == 0)).any()):
        live = in_group & (code == 0)
        eds, occ, split, reached = stats_rows(D, e, er, clen)
        costs = torch.where(l2_r, eds * eds, eds)
        total = torch.zeros(G1, dtype=i32, device=dev).index_add_(
            0, seg, costs)
        nonexact = (split > 0) & ((split & (split - 1)) != 0)
        eds_max = _seg_max0(eds, seg, G1)
        all_exact = ~_seg_any(nonexact, seg, G1)
        cost_overflow = l2 & (eds_max > 2048)
        # inactive rows count as done under early termination
        reached_here = torch.where(et, ~_seg_any(act & ~reached, seg, G1),
                                   _seg_any(reached, seg, G1))
        counts = seg_vote_fold(occ, split, seg, G1)
        has_votes = torch.zeros((G1, A), dtype=i32, device=dev).index_add_(
            0, seg, (occ > 0).to(i32)) > 0
        n_cands = has_votes.sum(1)
        drop_wc = (wc >= 0) & (n_cands > 1)
        wc_mask = drop_wc[:, None] & (a_idx == wc.clamp(min=0)[:, None])
        has_votes = has_votes & ~wc_mask
        counts = torch.where(wc_mask, 0.0, counts)
        neg1 = torch.full_like(counts, -1.0)
        maxc = torch.where(has_votes, counts, neg1).amax(1)
        thr = torch.minimum(min_count_f, maxc)
        passing = has_votes & (counts >= thr[:, None])
        npass = passing.sum(1)
        near_tie = ((maxc - min_count_f).abs() < eps) | (
            has_votes & ((counts - thr[:, None]).abs() < eps)).any(1)
        dirty = ((~all_exact & near_tie) | (npass != 1) | (n_cands == 0)
                 | cost_overflow)
        # records are never absorbed: a reached state stops with code 2
        wins_pop = (total < other_cost) | (
            (total == other_cost) & (clen > other_len))
        code_new = torch.where(
            (total > me_budget) | ~wins_pop, 3,
            torch.where(reached_here, 2,
                        torch.where(dirty, 1,
                                    torch.where(steps >= max_steps, 4, 0))))
        sym = torch.argmax(torch.where(passing, counts, neg1), 1).to(i32)
        D2, e2, rmin2, er2 = col_step(D, e, rmin, er, (clen + 1)[seg],
                                      sym[seg])
        ovf = _seg_any(act & (e2 >= erow), seg, G1)
        commit = live & (code_new == 0) & ~ovf
        code = torch.where(
            ~live, code,
            torch.where(code_new != 0, code_new,
                        torch.where(ovf, 5, 0))).to(i32)
        cpos = clen.clamp(0, C - 1).long()
        cons[gi, cpos] = torch.where(commit, sym, cons[gi, cpos])
        cm = commit[seg]
        D = torch.where(cm[:, None], D2, D)
        e = torch.where(cm, e2, e)
        rmin = torch.where(cm, rmin2, rmin)
        er = torch.where(cm, er2, er)
        clen = clen + commit.to(i32)
        steps = steps + commit.to(i32)
        iters = iters + live.to(i32)

    eds, occ, split, reached = stats_rows(D, e, er, clen)
    fin = torch.maximum(e, rmin)
    fin_ovf = _seg_any(act & (fin >= erow), seg, G1)
    fin_r = torch.where(act, fin.clamp(max=INF), 0).to(i32)
    return (D, e, rmin, er, cons, clen, steps, code, iters, eds, occ, split,
            reached, fin_r, fin_ovf)


def gang_iters(first_sym: int, steps: int) -> int:
    """Live iterations of a member (``ragged_plain``'s ``iters``) from its
    result: a forced push is no iteration, and every iteration but the
    last commits one step."""
    if first_sym >= 0:
        return steps
    return steps + 1


# ======================================================================
# deposits


@dataclass
class _Injected:
    """A consume-once precomputed ``run_extend`` result; the member's own
    ``run_extend`` call returns it."""

    len0: int
    steps: int
    code: int
    ids: np.ndarray          # appended dense symbol ids (length >= steps)
    stats: tuple             # (eds, occ, split, reached, fin or None)
    iters: int


@dataclass
class _SpecInjected(_Injected):
    """A speculative frontier-gang deposit.  The member's slot was not
    advanced at gang time: its post-run state stays in the gang's device
    buffers (``post``) and is copied into the slot only when the member's
    own pop makes a call that validates it
    (``TorchScorer._spec_consume``); a mismatch discards it and the solo
    run starts from the untouched slot."""

    speculative: bool = True
    #: forced first symbol the speculation assumed (-1 = unforced)
    first_sym: int = -1
    #: total cost of the advanced state under the member's cost model
    final_cost: int = 0
    #: speculated min_count / l2 (search constants; guarded for safety)
    min_count: int = 0
    l2: bool = False
    #: the call arguments the speculation ran with
    me_budget: int = 2**31 - 1
    other_cost: int = 2**31 - 1
    other_len: int = 0
    #: ``(deposit buffers, member index)``: the post-run rows ``D [G, R,
    #: W]``, ``e``/``rmin``/``er [G, R]``, ``cons [G, C]``, ``clen [G]``
    post: tuple = ()


@dataclass
class GangMember:
    """One branch's speculated ``run_extend`` call for a frontier gang:
    the in-hand node carries its real arguments; peers carry the engine's
    prediction of the arguments their own pop will use (a prediction only
    affects how often deposits are used: consumption validates them)."""

    h: int
    consensus: bytes
    me_budget: int
    other_cost: int
    other_len: int
    max_steps: int
    first_sym: int = -1


def _bump(counters, key: str, n: int = 1) -> None:
    counters[key] = counters.get(key, 0) + n


class FrontierGang:
    """Same-search speculative ganging: advance the top-M branches of one
    search in a single launch.  Branches of one search share the scorer,
    hence R and the band width, so each member is an independent run of
    the run kernel's geometry.  Results are kept as consume-once
    :class:`_SpecInjected` deposits; no slot is touched at gang time.
    Single-threaded: the gang belongs to one search loop."""

    #: fixed member-group capacity (the kernel's ``kMaxGang``)
    G = 8

    def __init__(self, scorer) -> None:
        self.scorer = scorer
        self._injected: Dict[int, _SpecInjected] = {}
        self.counters = {
            "groups": 0, "members": 0, "deposits": 0, "dropped": 0,
            "occupancy_max": 0,
        }

    # -- consume-once deposits -----------------------------------------

    def take(self, h: int) -> Optional[_SpecInjected]:
        return self._injected.pop(int(h), None)

    def pending(self, h: int) -> bool:
        return int(h) in self._injected

    def drop(self, h: int) -> None:
        """Invalidate a branch's deposit: its slot changed (push /
        activate / arena / free), so the held post-state is stale."""
        if self._injected.pop(int(h), None) is not None:
            self.counters["dropped"] += 1

    def drop_all(self) -> None:
        """Invalidate everything: a band or consensus-capacity growth
        changed every slot's geometry."""
        n = len(self._injected)
        if n:
            self._injected.clear()
            self.counters["dropped"] += n

    # -- gang execution ------------------------------------------------

    def run(self, members: List[GangMember], min_count: int,
            l2: bool) -> int:
        """One gang launch over ``members`` (in-hand member first);
        deposits a speculative result per member and returns the deposit
        count (0: no gang, every member runs solo)."""
        from waffle_con_tpu_torch.ops import ragged_kernel, run_kernel

        sc = self.scorer
        c = sc.counters
        R, W, C = sc._R, sc._W, sc._C
        live = []
        for m in members[: self.G]:
            slot = sc._slot_of.get(m.h)
            if slot is None:
                continue
            if int(m.h) in self._injected:
                _bump(c, "gang_skip_pending")
                continue
            if len(m.consensus) + int(m.max_steps) + 2 >= C:
                _bump(c, "gang_skip_capacity")  # the solo run would grow C
                continue
            live.append((m, slot))
        if len(live) < 2:
            _bump(c, "gang_skip_members")
            return 0
        A = sc.num_symbols
        if not sc._takes("ragged", ragged_kernel.plan_ragged, len(live), R,
                         W, A, C):
            return 0
        params = np.asarray([
            (slot, len(m.consensus), min(int(m.me_budget), 2**31 - 1),
             min(int(m.other_cost), 2**31 - 1), int(m.other_len),
             int(m.max_steps), int(m.first_sym))
            for m, slot in live
        ], dtype=np.int32)
        call = ragged_kernel.GangCall(
            min_count=int(min_count), l2=bool(l2), wc=sc._wc, et=sc._et,
            a_real=A)
        dep = ragged_kernel.run_ragged(sc._state, params, sc._reads,
                                       sc._rlen, call)
        # every launch is a group, whatever its members turn out to hold
        self.counters["groups"] += 1
        _bump(c, "gang_groups")
        # the one packed fetch: control scalars and final stats
        out = dep["out"].cpu().numpy()
        synced = [g for g in range(len(live)) if out[g, 1] != -1]
        if len(synced) < len(live):
            _bump(c, "gang_skip_desync", len(live) - len(synced))
        if not synced:
            return 0
        MS = int(params[:, 5].max())
        for g in synced:
            m = live[g][0]
            res = run_kernel.unpack(out[g], R, A, MS)
            eds = res.eds.astype(np.int64)
            cost_rows = eds * eds if l2 else eds
            self._injected[int(m.h)] = _SpecInjected(
                len0=len(m.consensus),
                steps=res.steps,
                code=res.code,
                ids=res.syms,
                stats=(res.eds, res.occ, res.split, res.reached,
                       None if res.fin_ovf else res.fin),
                iters=gang_iters(int(m.first_sym), res.steps),
                first_sym=int(m.first_sym),
                final_cost=min(int(cost_rows.sum()), 2**31 - 1),
                min_count=int(min_count),
                l2=bool(l2),
                me_budget=min(int(m.me_budget), 2**31 - 1),
                other_cost=min(int(m.other_cost), 2**31 - 1),
                other_len=int(m.other_len),
                post=(dep, g),
            )
        n = len(synced)
        self.counters["members"] += n
        self.counters["deposits"] += n
        self.counters["occupancy_max"] = max(
            self.counters["occupancy_max"], n)
        _bump(c, "gang_members", n)
        return n

    def stats(self) -> Dict:
        c = dict(self.counters)
        groups = c["groups"]
        return {
            "pending": len(self._injected),
            "mean_occupancy": (c["members"] / groups) if groups else 0.0,
            **c,
        }


def frontier_gang_for(scorer) -> FrontierGang:
    """The scorer's lazily created frontier gang (one per scorer; lives
    and dies with it)."""
    gang = getattr(scorer, "_frontier_gang", None)
    if gang is None:
        gang = FrontierGang(scorer)
        scorer._frontier_gang = gang
    return gang


def take_injected(scorer, h: int) -> Optional[_SpecInjected]:
    """The scorer's pending gang deposit for ``h``, taken (None when
    there is none)."""
    gang = getattr(scorer, "_frontier_gang", None)
    return gang.take(h) if gang is not None else None
