"""Gang runs through one launch: the cross-job serving pool and the
frontier gang.

The port of ``waffle_con_tpu``'s ``ops/ragged.py``.  Two users share the
gang kernel (:mod:`~waffle_con_tpu_torch.ops.ragged_kernel`:
``csrc/run_ragged.cu`` on a CUDA device, :func:`ragged_plain` on the
CPU):

* **The serving pool** (:class:`BandArena`): the serve layer's
  :class:`~waffle_con_tpu_torch.serve.dispatcher.BatchingDispatcher`
  gangs parked ``run_extend`` calls of *different* jobs — different read
  counts, read lengths, band widths, alphabets and search constants —
  into one launch.  :class:`PageTable` keeps JAX's residency accounting:
  a job's reads hold whole pages of a fixed pool of rows, and a pool that
  cannot hold another job raises the typed :class:`ArenaExhausted`
  internally (the call then takes the bucketed path: backpressure, never
  corruption).  :func:`probe` resolves a parked call down the proxy
  stack (``CoalescingScorer`` -> supervisor -> ``TorchScorer``) through
  the ``ragged_run_probe`` hop, checks eligibility and admits the job;
  :func:`run_group` runs the members in one launch and deposits a
  consume-once result per member that its own ``run_extend`` then
  returns at once, so supervision, faults and tracing compose unchanged.
* **The frontier gang** (:class:`FrontierGang`): alongside the in-hand
  node's ``run_extend`` the engines advance the next-best queued branches
  of the same search in one launch, each member's post-run state kept as
  a consume-once speculative deposit (:class:`_SpecInjected`); no slot is
  touched at gang time, and a deposit is used only when the member's own
  pop makes a call it validates (``TorchScorer._spec_consume``).  Inside
  a serve scope (:func:`serving_active`) the engines do not self-gang.

Where the pool differs from JAX's.  JAX stages every member's reads into
one ``[ROWS, L] int16`` pool array and gathers and scatters band state,
because one XLA call needs one array.  The port stages nothing: the gang
kernel reads each member straight from its own branch store (its slot,
its reads) at its own geometry and advances the slot in place, as the
member's own ``run_extend`` would; only each member's packed output
comes to the host, in one copy.  The page table still decides residency
and exhaustion with JAX's semantics and counters, so the same jobs gang.

Byte-identity with the serial path: a member's cluster runs the run
kernel's body at the member's own split of reads over CTAs and warps, so
its fold, hence its result, is its solo launch's; records are never
absorbed (a reached state stops with code 2, which the engines handle);
a member whose band grows mid-run (code 5) is re-centred in the pool
(:func:`recenter_scorer`), keeping its residency while its new width
fits the pool's.

No fallback hides the kernel: a gang whose build or launch fails leaves
a failure deposit for each member, whose own ``run_extend`` raises it
(the job's supervisor, if any, sees a failed call).  The only ways to
the bucketed path are JAX's — not eligible, :class:`ArenaExhausted`, or
a planner refusal — and each is counted.

The JAX package's knobs are config fields here (:class:`ArenaConfig`,
built from the service's ``ServeConfig``): ``WAFFLE_RAGGED`` ->
``enabled``, ``WAFFLE_RAGGED_MIXED_W`` -> ``mixed_w``, ``_ROWS`` /
``_PAGE`` / ``_E`` / ``_L`` / ``_C`` / ``_GANG`` -> ``rows`` /
``page_rows`` / ``band_e`` / ``read_len`` / ``cons_len`` / ``gang``.
The port reads no environment variable.

:func:`ragged_plain` is the plain PyTorch twin of JAX's ``_j_run_ragged``
(``BandArena._build_kernel``): the K=1 run body over a pool of member
rows with per-row ``(off, act, seg, wrow)`` descriptors, every
per-branch fold a segment reduce; same arguments and outputs (mixed band
strides included), so the tests hold it to JAX.

What decides "no gang" for the frontier gang is settled before the
launch and counted in the scorer's counters: fewer than two members
(``gang_skip_members``), a member whose run could need more consensus
capacity (``gang_skip_capacity``), a member with a pending deposit
(``gang_skip_pending``), the gang planner's refusal
(``plan_refused_ragged``).  A member whose slot does not hold the
engine's consensus length runs nothing in the launch and gets no deposit
(``gang_skip_desync``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from waffle_con_tpu_torch.analysis import lockcheck
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs import phases as _phases

logger = logging.getLogger(__name__)

#: columns of the per-member parameter rows ``jp [G + 1, 10]`` of
#: :func:`ragged_plain`: in_group, me_budget, other_cost, other_len,
#: min_count, l2, max_steps, first_sym, wildcard, early termination
JP_COLS = 10


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
class _GangFailure:
    """A serving-pool group whose build or launch failed: each member's
    own ``run_extend`` raises ``error`` (never a quiet solo run)."""

    error: BaseException


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


# ======================================================================
# the serving pool: configuration, serve scope, page table


class ArenaExhausted(RuntimeError):
    """Typed backpressure: the page table cannot hold another job's
    reads.  Callers fall back to the bucketed dispatch path — this must
    never surface as a corrupted result."""


def _in_range(name: str, value: int, lo: int, hi: int) -> None:
    if not lo <= value <= hi:
        raise ValueError(f"{name}={value} outside [{lo}, {hi}]")


@dataclass(frozen=True)
class ArenaConfig:
    """Pool geometry and switches (JAX's defaults and ranges)."""

    rows: int = 256       # total pool rows (reads across all jobs)
    page_rows: int = 8    # rows per page (residency quantum)
    band_e: int = 32      # pool band half-width; W = 2E + 2
    read_len: int = 512   # longest read a member may have
    cons_len: int = 2048  # per-member consensus capacity
    gang: int = 8         # max members per group
    alphabet: int = 8     # widest dense alphabet a member may have
    #: the ragged pass at all (JAX's ``WAFFLE_RAGGED``)
    enabled: bool = True
    #: members of different band widths share a group (the band width is
    #: a cap, not an equality; JAX's ``WAFFLE_RAGGED_MIXED_W``)
    mixed_w: bool = True

    def __post_init__(self) -> None:
        _in_range("rows", self.rows, 16, 1 << 16)
        _in_range("page_rows", self.page_rows, 1, 256)
        _in_range("band_e", self.band_e, 8, 512)
        _in_range("read_len", self.read_len, 64, 1 << 15)
        _in_range("cons_len", self.cons_len, 256, 1 << 16)
        _in_range("gang", self.gang, 2, 64)
        _in_range("alphabet", self.alphabet, 1, 1 << 16)

    @property
    def W(self) -> int:
        return 2 * self.band_e + 2


@dataclass(frozen=True)
class GeometryHint:
    band: int    # floor for the scorer's band half-width E
    rows: int    # floor for the read-slot axis R
    length: int  # floor for the reads axis L
    cons: int    # floor for the consensus axis C


_TLS = threading.local()


@contextlib.contextmanager
def serve_scope(config: Optional[ArenaConfig] = None):
    """Marks the current thread as building and running a served job
    with the pool ``config`` (default: the process arena's): scorer
    constructors consult :func:`geometry_hint` while it is active, and
    the engines do not self-gang (:func:`serving_active`)."""
    prev = getattr(_TLS, "serving", 0)
    prev_cfg = getattr(_TLS, "config", None)
    _TLS.serving = prev + 1
    _TLS.config = config
    try:
        yield
    finally:
        _TLS.serving = prev
        _TLS.config = prev_cfg


def serving_active() -> bool:
    """True inside a :func:`serve_scope`, where the coalescing dispatcher
    owns batching and engines must not self-gang (a frontier gang would
    race the cross-job pass over the same slots).  The nesting counter
    decides, so a thread that once served a job gets its self-ganging
    back afterwards."""
    return bool(getattr(_TLS, "serving", 0))


def _scope_config() -> ArenaConfig:
    cfg = getattr(_TLS, "config", None)
    if cfg is not None:
        return cfg
    arena = _ARENA
    return arena.cfg if arena is not None else ArenaConfig()


def geometry_hint() -> Optional[GeometryHint]:
    """The serve scope's geometry floor, or None outside a served job (or
    with the pool switched off).  Only the consensus axis is always
    floored — eligibility demands ``len(consensus) + max_steps + 2 < C``
    at probe time, and the solo path grows C lazily mid-run — and the
    band half-width too when mixed widths are off (then the band width
    is the gang's equality gate).  R and L stay natural: the kernel reads
    any member's R and L from its own store."""
    if not serving_active():
        return None
    cfg = _scope_config()
    if not cfg.enabled:
        return None
    band = 0 if cfg.mixed_w else cfg.band_e
    return GeometryHint(band=band, rows=0, length=0, cons=cfg.cons_len)


class PageTable:
    """Host-side fixed-page allocator over the pool's rows.

    Pages are the residency quantum: a job's ``num_reads`` rows round up
    to whole pages.  Free pages recycle LIFO."""

    def __init__(self, n_pages: int, page_rows: int) -> None:
        if n_pages < 1 or page_rows < 1:
            raise ValueError("page table needs >= 1 page of >= 1 row")
        self.n_pages = n_pages
        self.page_rows = page_rows
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._held: Dict[int, List[int]] = {}

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, key: int, rows_needed: int) -> np.ndarray:
        """Allocate the page run covering ``rows_needed`` rows under
        ``key``; returns the (page-quantized) pool row indices.  Raises
        :class:`ArenaExhausted` when the pool cannot hold them."""
        if rows_needed < 1:
            raise ValueError("rows_needed must be >= 1")
        pages = -(-rows_needed // self.page_rows)
        if pages > len(self._free):
            raise ArenaExhausted(
                f"band-state pool exhausted: need {pages} pages "
                f"({rows_needed} rows), {len(self._free)} free of "
                f"{self.n_pages}"
            )
        got = [self._free.pop() for _ in range(pages)]
        self._held[key] = got
        return np.concatenate([
            np.arange(p * self.page_rows, (p + 1) * self.page_rows)
            for p in sorted(got)
        ]).astype(np.int64)

    def release(self, key: int) -> bool:
        pages = self._held.pop(key, None)
        if pages is None:
            return False
        self._free.extend(pages)
        return True


# ======================================================================
# dispatch-time records

_RUN_ARGS = (
    "h", "consensus", "me_budget", "other_cost", "other_len",
    "min_count", "l2", "max_steps", "first_sym", "allow_records",
)


@dataclass
class RunSpec:
    """One probed and admitted group member: the resolved ``TorchScorer``
    endpoint plus the normalized ``run_extend`` call arguments."""

    scorer: object
    h: int
    vals: Dict
    ticket: object = None
    job_id: Optional[int] = None


@dataclass
class _Residency:
    scorer: object           # strong ref: keyed by id() while resident
    rows: np.ndarray
    job_id: Optional[int] = None


def _normalize_run_args(args, kwargs) -> Optional[Dict]:
    """Positional/keyword ``run_extend`` call -> named dict (None when
    the shape is unrecognized — then the call just runs solo)."""
    if len(args) > len(_RUN_ARGS):
        return None
    vals: Dict = {"first_sym": -1, "allow_records": True}
    vals.update(zip(_RUN_ARGS, args))
    for k, v in kwargs.items():
        if k not in _RUN_ARGS:
            return None
        vals[k] = v
    if any(k not in vals for k in _RUN_ARGS[:8]):
        return None
    return vals


# ======================================================================
# the pool


class BandArena:
    """The serving pool: page table, residency, deposits and counters.

    All host bookkeeping is guarded by one lock; device work happens on
    the dispatcher thread (:meth:`run_group`) with :meth:`release_job` the
    only cross-thread caller."""

    def __init__(self, cfg: ArenaConfig) -> None:
        self.cfg = cfg
        self.rows = cfg.rows
        self.page_rows = cfg.page_rows
        self.E = cfg.band_e
        self.W = cfg.W
        self.L = cfg.read_len
        self.C = cfg.cons_len
        self.gang = cfg.gang
        self.A = cfg.alphabet
        self.pages = PageTable(cfg.rows // cfg.page_rows, cfg.page_rows)
        self._lock = lockcheck.make_rlock("ops.ragged.BandArena")
        self._resident: Dict[int, _Residency] = {}
        self._injected: Dict[Tuple[int, int], object] = {}
        self._counters = {
            "groups": 0, "members": 0, "occupancy_max": 0,
            "admits": 0, "releases": 0, "exhausted": 0,
            "injected_consumed": 0, "injected_dropped": 0,
            "member_store_failures": 0,
            # width-agnostic accounting: groups whose members span >= 2
            # band widths, rows stepped, in-pool re-centerings
            "mixed_w_groups": 0, "gang_rows": 0, "recenters": 0,
            # the port's: launches, groups whose launch failed, and
            # groups a planner refused
            "launches": 0, "group_failures": 0, "plan_refused": 0,
        }
        #: probes that took the bucketed path, by reason
        self._refused: Dict[str, int] = {}

    def _publish_pages(self) -> None:
        if not obs_metrics.metrics_enabled():
            return
        reg = obs_metrics.registry()
        reg.gauge("waffle_ragged_pool_pages_used").set(self.pages.used_pages)
        reg.gauge("waffle_ragged_pool_pages_free").set(self.pages.free_pages)

    def refuse(self, reason: str) -> None:
        """Count one probe that takes the bucketed path."""
        with self._lock:
            self._refused[reason] = self._refused.get(reason, 0) + 1

    # -- eligibility + residency ---------------------------------------

    def why_not(self, scorer, vals: Dict) -> Optional[str]:
        """Why ``scorer`` cannot take part with the call ``vals`` (None:
        it can).  With mixed widths (the default) the pool's band width
        is a cap: any member with ``W <= pool W`` gangs at its own row
        stride; without, the widths must be equal.  The capacity check
        mirrors the solo path's growth condition, so a ganged run never
        needs a consensus growth.  A read-sharded store never takes part
        (``"sharded"``): a placed job's reads span several stores, so the
        mesh and the pool stay exclusive."""
        from waffle_con_tpu_torch.ops.sharded_scorer import ShardedScorer

        if isinstance(scorer, ShardedScorer):
            return "sharded"
        try:
            n = scorer.num_reads
            if n < 1 or n > self.rows:
                return "rows"
            if self.cfg.mixed_w:
                if scorer._W > self.W:
                    return "width"
            elif scorer._W != self.W:
                return "width"
            if scorer.num_symbols > self.A:
                return "alphabet"
            if scorer._max_rlen > self.L:
                return "length"
            need = len(vals["consensus"]) + int(vals["max_steps"]) + 2
            if need >= min(scorer._C, self.C):
                return "capacity"
        except (AttributeError, TypeError):
            return "not_a_store"
        return None

    def eligible(self, scorer, vals: Dict) -> bool:
        """Geometry gate for one probed member (see :meth:`why_not`)."""
        return self.why_not(scorer, vals) is None

    def try_admit(self, scorer, job_id: Optional[int]) -> Optional[np.ndarray]:
        """Admission on first probe: allocate this scorer's page run.
        Returns the pool rows, or None on exhaustion (the call takes the
        bucketed path).  The port stages no reads: a member's kernel
        reads its own store."""
        with self._lock:
            key = id(scorer)
            res = self._resident.get(key)
            if res is not None:
                if res.job_id is None:
                    res.job_id = job_id
                return res.rows
            try:
                rows = self.pages.alloc(key, scorer.num_reads)
            except ArenaExhausted:
                self._counters["exhausted"] += 1
                if obs_metrics.metrics_enabled():
                    obs_metrics.registry().counter(
                        "waffle_ragged_exhausted_total"
                    ).inc()
                return None
            self._resident[key] = _Residency(scorer, rows, job_id)
            self._counters["admits"] += 1
            self._publish_pages()
            return rows

    def _release_key(self, key: int) -> None:
        res = self._resident.pop(key, None)
        if res is None:
            return
        self.pages.release(key)
        self._counters["releases"] += 1
        # pending deposits of the departing scorer are stale by definition
        for k in [k for k in self._injected if k[0] == key]:
            self._injected.pop(k, None)
            self._counters["injected_dropped"] += 1
        self._publish_pages()

    def release_scorer(self, scorer) -> None:
        with self._lock:
            self._release_key(id(scorer))

    def release_job(self, job_id) -> None:
        if job_id is None:
            return
        with self._lock:
            for key in [
                k for k, r in self._resident.items() if r.job_id == job_id
            ]:
                self._release_key(key)

    def recenter_scorer(self, scorer) -> bool:
        """In-pool band re-centering: the scorer's band just grew, so any
        held deposits are stale, but its page run is untouched by a band
        change, so residency survives and the member gangs again on its
        next probe at the new row stride.  Only a width outgrowing the
        pool's (or the equality gate) evicts; returns True while the
        scorer is still resident."""
        with self._lock:
            key = id(scorer)
            res = self._resident.get(key)
            if res is None:
                return False
            for k in [k for k in self._injected if k[0] == key]:
                self._injected.pop(k, None)
                self._counters["injected_dropped"] += 1
            try:
                if scorer._W > self.W or not self.cfg.mixed_w:
                    self._release_key(key)
                    return False
            except AttributeError:
                self._release_key(key)
                return False
            self._counters["recenters"] += 1
            if obs_metrics.metrics_enabled():
                obs_metrics.registry().counter(
                    "waffle_ragged_recenter_total"
                ).inc()
            return True

    # -- deposits ------------------------------------------------------

    def take_injected(self, scorer, h: int):
        with self._lock:
            inj = self._injected.pop((id(scorer), int(h)), None)
            if inj is not None:
                self._counters["injected_consumed"] += 1
            return inj

    def discard_injected(self, keys) -> None:
        """Drop deposits of a batch that were never consumed (the member's
        dispatch raised before reaching the scorer): a stale deposit must
        never survive into a later call."""
        with self._lock:
            for k in keys:
                if self._injected.pop(k, None) is not None:
                    self._counters["injected_dropped"] += 1

    # -- group execution -----------------------------------------------

    def run_group(self, specs: List[RunSpec]) -> List[Tuple[int, int]]:
        """Run every member (up to ``gang``) in one gang launch (groups
        of more than 8 in consecutive launches of 8), each advancing its
        own slot in place, then deposit each member's result.  Returns
        the deposit keys (the dispatcher discards leftovers after the
        batch).  A failed build or launch deposits a failure for every
        member instead, which its own ``run_extend`` raises."""
        rec = _phases.begin("ragged_group", "torch")
        try:
            return self._run_group(specs)
        finally:
            _phases.end(rec)

    def _run_group(self, specs: List[RunSpec]) -> List[Tuple[int, int]]:
        from waffle_con_tpu_torch.ops import ragged_kernel, run_kernel
        from waffle_con_tpu_torch.ops.torch_scorer import planner_refuses

        members = []
        with self._lock:
            for spec in specs[: self.gang]:
                res = self._resident.get(id(spec.scorer))
                slot = spec.scorer._slot_of.get(spec.h)
                if res is None or slot is None:
                    continue
                if spec.scorer._W > self.W:
                    continue  # grew past the pool since the probe
                members.append((spec, slot, len(res.rows)))
        if len(members) < 2:
            return []
        dev = members[0][0].scorer.device
        if any(m[0].scorer.device != dev for m in members):
            # one launch runs on one device: the first device's members
            members = [m for m in members if m[0].scorer.device == dev]
            if len(members) < 2:
                return []
        gm = []
        for spec, slot, _rows in members:
            sc, v = spec.scorer, spec.vals
            gm.append(ragged_kernel.Member(
                sc._state, slot, sc._reads, sc._rlen, len(v["consensus"]),
                min(int(v["me_budget"]), 2**31 - 1),
                min(int(v["other_cost"]), 2**31 - 1), int(v["other_len"]),
                int(v["max_steps"]), int(v["first_sym"]),
                int(v["min_count"]), bool(v["l2"]), sc._wc, sc._et,
                sc.num_symbols,
            ))
        # a launch's shapes the planner refuses take the bucketed path
        for i in range(0, len(gm), ragged_kernel.MAX_GANG):
            chunk = gm[i:i + ragged_kernel.MAX_GANG]
            if planner_refuses(dev, ragged_kernel.plan_members,
                               [m.shape() for m in chunk]):
                with self._lock:
                    self._counters["plan_refused"] += 1
                for spec, _slot, _rows in members:
                    c = spec.scorer.counters
                    c["plan_refused_ragged"] = (
                        c.get("plan_refused_ragged", 0) + 1)
                return []
        rec = _phases.current()
        widths = {m.shape()[1] for m in gm}
        if rec is not None:
            rec.annotate(kernel="ragged", k=1,
                         geom=f"G{len(gm)}W{max(widths)}")
        keys: List[Tuple[int, int]] = []
        try:
            with _phases.device_scope(rec, dev):
                outs, _dep = ragged_kernel.run_members(gm, in_place=True)
            with _phases.transfer_scope(rec):
                host = ragged_kernel.fetch_outs(outs)
        except Exception as exc:  # noqa: BLE001 - delivered to every member
            logger.warning("ragged group of %d failed", len(gm),
                           exc_info=True)
            with self._lock:
                self._counters["group_failures"] += 1
                for spec, _slot, _rows in members:
                    key = (id(spec.scorer), int(spec.h))
                    self._injected[key] = _GangFailure(exc)
                    keys.append(key)
            return keys
        n_members = n_rows = 0
        run_widths = set()
        for (spec, _slot, rows), m, out in zip(members, gm, host):
            R, W, A, _C = m.shape()
            res = run_kernel.unpack(out, R, A, m.max_steps)
            if res.code == -1:
                continue  # slot out of step with the engine: solo decides
            inj = _Injected(
                len0=m.len0, steps=res.steps, code=res.code, ids=res.syms,
                stats=(res.eds, res.occ, res.split, res.reached,
                       None if res.fin_ovf else res.fin),
                iters=gang_iters(m.first_sym, res.steps),
            )
            key = (id(spec.scorer), int(spec.h))
            with self._lock:
                self._injected[key] = inj
            keys.append(key)
            n_members += 1
            # JAX's count: the member's page run, up to its store's rows
            n_rows += min(rows, spec.scorer._R)
            run_widths.add(W)
        n_launch = -(-len(gm) // ragged_kernel.MAX_GANG)
        with self._lock:
            self._counters["launches"] += n_launch
            if n_members:
                self._counters["groups"] += 1
                self._counters["members"] += n_members
                self._counters["occupancy_max"] = max(
                    self._counters["occupancy_max"], n_members)
                self._counters["gang_rows"] += n_rows
                if len(run_widths) > 1:
                    self._counters["mixed_w_groups"] += 1
        if n_members and obs_metrics.metrics_enabled():
            reg = obs_metrics.registry()
            reg.histogram(
                "waffle_ragged_occupancy",
                buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
            ).observe(n_members)
            reg.histogram(
                "waffle_ragged_gang_rows",
                buckets=obs_metrics.DEFAULT_COUNT_BUCKETS,
            ).observe(n_rows)
            reg.gauge("waffle_ragged_gang_widths").set(len(run_widths))
        return keys

    # -- introspection -------------------------------------------------

    def stats(self) -> Dict:
        with self._lock:
            c = dict(self._counters)
            refused = dict(self._refused)
        groups = c["groups"]
        return {
            "active": True,
            "enabled": self.cfg.enabled,
            "mixed_w": self.cfg.mixed_w,
            "rows": self.rows,
            "page_rows": self.page_rows,
            "pages_total": self.pages.n_pages,
            "pages_used": self.pages.used_pages,
            "pages_free": self.pages.free_pages,
            "band_e": self.E,
            "gang": self.gang,
            "mean_occupancy": (c["members"] / groups) if groups else 0.0,
            "mean_gang_rows": (c["gang_rows"] / groups) if groups else 0.0,
            "refused": refused,
            **c,
        }


# ======================================================================
# process-wide arena registry and the module API the serve layer calls.
# The default arena backs a single service; named arenas (one a
# replicated service's replica) keep residency and groups replica-local.
# Scorer-keyed lookups search every arena (id(scorer) is process-unique).

_ARENA: Optional[BandArena] = None
_ARENA_LOCK = lockcheck.make_lock("ops.ragged.PROCESS_ARENA")
_NAMED_ARENAS: Dict[str, BandArena] = {}


def get_arena(config: Optional[ArenaConfig] = None) -> BandArena:
    """The process arena, built on first use (``config``, or the
    defaults); a ``config`` that differs from the live arena's replaces
    it."""
    global _ARENA
    with _ARENA_LOCK:
        if _ARENA is None or (config is not None and _ARENA.cfg != config):
            _ARENA = BandArena(config or ArenaConfig())
        return _ARENA


def peek_arena() -> Optional[BandArena]:
    return _ARENA


def new_arena(name: str, config: Optional[ArenaConfig] = None) -> BandArena:
    """Create (or replace) the named arena."""
    arena = BandArena(config or ArenaConfig())
    with _ARENA_LOCK:
        _NAMED_ARENAS[name] = arena
    return arena


def drop_arena(name: str) -> None:
    with _ARENA_LOCK:
        _NAMED_ARENAS.pop(name, None)


def _all_arenas() -> List[BandArena]:
    with _ARENA_LOCK:
        out = [] if _ARENA is None else [_ARENA]
        out.extend(_NAMED_ARENAS.values())
        return out


def reset_arena() -> None:
    """Drop the process arena and every named arena."""
    global _ARENA
    with _ARENA_LOCK:
        _ARENA = None
        _NAMED_ARENAS.clear()


def enabled(arena: Optional[BandArena] = None) -> bool:
    """The ragged pass's switch of ``arena`` (default: the process
    arena's; on when there is none)."""
    a = arena if arena is not None else _ARENA
    return a.cfg.enabled if a is not None else True


def gang_width(arena: Optional[BandArena] = None) -> int:
    return (arena or get_arena()).gang


def probe(payload, ticket=None,
          arena: Optional[BandArena] = None) -> Optional[RunSpec]:
    """Resolve one parked ``run_extend`` call into a group member.

    ``payload`` is ``(probe_attr, args, kwargs)`` captured by the
    coalescing proxy; ``probe_attr`` hops the proxy and supervisor stack
    to the live ``TorchScorer`` (or gives None when the current backend
    cannot take part).  Returns None — the bucketed path — on any
    ineligibility, pool exhaustion included; each such probe is counted
    by reason in the arena's ``refused``."""
    arena = arena if arena is not None else get_arena()
    if not arena.cfg.enabled:
        arena.refuse("disabled")
        return None
    probe_fn, args, kwargs = payload
    vals = _normalize_run_args(args, kwargs)
    if vals is None:
        arena.refuse("args")
        return None
    try:
        endpoint = probe_fn(vals["h"])
    except Exception:  # noqa: BLE001 - a dead handle just runs solo
        arena.refuse("dead_handle")
        return None
    if endpoint is None:
        arena.refuse("no_endpoint")
        return None
    scorer, bh = endpoint
    why = arena.why_not(scorer, vals)
    if why is not None:
        arena.refuse(why)
        return None
    job_id = getattr(ticket, "job_id", None)
    if arena.try_admit(scorer, job_id) is None:
        arena.refuse("exhausted")
        return None
    return RunSpec(
        scorer=scorer, h=int(bh), vals=vals, ticket=ticket, job_id=job_id
    )


def run_group(specs: List[RunSpec],
              arena: Optional[BandArena] = None) -> List[Tuple[int, int]]:
    return (arena if arena is not None else get_arena()).run_group(specs)


def take_injected(scorer, h: int):
    """The scorer's pending deposit for ``h``, taken (None when there is
    none): a frontier-gang deposit first (search-local, and never at the
    same time as a serving-pool one), then the arenas'."""
    gang = getattr(scorer, "_frontier_gang", None)
    if gang is not None:
        inj = gang.take(h)
        if inj is not None:
            return inj
    if _ARENA is None and not _NAMED_ARENAS:
        return None  # no serving pool: every run_extend asks, keep it cheap
    for a in _all_arenas():
        inj = a.take_injected(scorer, h)
        if inj is not None:
            return inj
    return None


def discard_injected(keys, arena: Optional[BandArena] = None) -> None:
    if arena is not None:
        arena.discard_injected(keys)
        return
    for a in _all_arenas():
        a.discard_injected(keys)


def release_scorer(scorer) -> None:
    """A backend swap: every held deposit of ``scorer`` is stale, and its
    residency ends."""
    gang = getattr(scorer, "_frontier_gang", None)
    if gang is not None:
        gang.drop_all()
    for a in _all_arenas():
        a.release_scorer(scorer)


def recenter_scorer(scorer) -> bool:
    """The band of ``scorer`` grew: drop its stale deposits everywhere
    but keep its residency (see :meth:`BandArena.recenter_scorer`).
    Returns True while it is still resident in some arena."""
    resident = False
    for a in _all_arenas():
        if a.recenter_scorer(scorer):
            resident = True
    return resident


def release_job(job_id, arena: Optional[BandArena] = None) -> None:
    if arena is not None:
        arena.release_job(job_id)
        return
    a = _ARENA
    if a is not None:
        a.release_job(job_id)


def arena_stats(arena: Optional[BandArena] = None) -> Dict:
    a = arena if arena is not None else _ARENA
    if a is None:
        return {"active": False, "enabled": True}
    return a.stats()
