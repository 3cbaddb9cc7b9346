"""Single-consensus engine: least-cost-first search over partial consensus
strings, scored by incremental per-read wavefronts.

The port of ``waffle_con_tpu``'s ``models/consensus.py``: the same search,
queue and bookkeeping, byte for byte, over the
:class:`~waffle_con_tpu_torch.ops.scorer.WavefrontScorer` seam.  On the
``"torch"`` backend the popped branch extends through unambiguous
stretches inside one device run call (``run_extend``) — on a CUDA device
one launch of the hand-written run kernel per engagement.

Example::

    from waffle_con_tpu_torch import CdwfaConfigBuilder, ConsensusDWFA

    cdwfa = ConsensusDWFA(CdwfaConfigBuilder().backend("torch").build())
    for s in [b"ACGT", b"ACCGT", b"ACCCGT"]:
        cdwfa.add_sequence(s)
    results = cdwfa.consensus()
    assert results[0].sequence == b"ACCGT"
    assert results[0].scores == [1, 0, 1]
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.models.frontier import FrontierSpeculator, GangMember
from waffle_con_tpu_torch.obs import audit as obs_audit
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs.instrument import FrontierSampler
from waffle_con_tpu_torch.obs.report import run_reported_search as _reported_search
from waffle_con_tpu_torch.ops.scorer import (
    BranchStats,
    WavefrontScorer,
    fast_paths,
    make_scorer,
)
from waffle_con_tpu_torch.runtime import faults as faults_mod
from waffle_con_tpu_torch.runtime.watchdog import enforce_dispatch_budget
from waffle_con_tpu_torch.utils.pqueue import PQueueTracker, SetPriorityQueue

logger = logging.getLogger(__name__)

#: Per-engagement column cap for the device run loop: bounds the host-side
#: bookkeeping simulation; long clean stretches simply re-engage next pop.
RUN_SIM_CAP = 65536

#: Queue pops between search-progress debug lines.
PROGRESS_LOG_INTERVAL = 1000


class EngineError(Exception):
    """Engine-level failure (coverage gaps, invalid inputs, ...).  The
    message strings are API surface, shared with ``waffle_con_tpu``."""


def check_invariant(condition: bool, message: str) -> None:
    """Engine invariant check that survives ``python -O``."""
    if not condition:
        raise EngineError(f"internal invariant violated: {message}")


class Consensus:
    """A final consensus result: the sequence, the cost model, and the
    per-read scores."""

    __slots__ = ("sequence", "consensus_cost", "scores")

    def __init__(
        self,
        sequence: bytes,
        consensus_cost: ConsensusCost,
        scores: List[int],
    ) -> None:
        self.sequence = bytes(sequence)
        self.consensus_cost = consensus_cost
        self.scores = list(scores)

    def __eq__(self, rhs) -> bool:
        return (
            isinstance(rhs, Consensus)
            and self.sequence == rhs.sequence
            and self.consensus_cost == rhs.consensus_cost
            and self.scores == rhs.scores
        )

    def __repr__(self) -> str:
        return (
            f"Consensus(sequence={self.sequence!r}, "
            f"cost={self.consensus_cost.value}, scores={self.scores})"
        )


def shift_offsets(
    offsets: List[Optional[int]], auto_shift: bool
) -> List[Optional[int]]:
    """When no read starts at offset ``None`` and auto-shift is enabled,
    shift every offset down by the minimum (the minimum becomes ``None``)."""
    if not auto_shift or any(o is None for o in offsets):
        return list(offsets)
    min_offset = min(offsets)
    logger.debug("No start sequence detected, shifting all offsets by %d", min_offset)
    return [None if o == min_offset else o - min_offset for o in offsets]


def replay_run_bookkeeping(
    tracker: PQueueTracker,
    cfg: CdwfaConfig,
    top_len: int,
    steps: int,
    farthest: int,
    last_constraint: int,
    on_length=None,
) -> Tuple[int, int]:
    """Replay the per-length tracker bookkeeping for a device-committed
    extension run, exactly as the per-symbol host loop would have done it:
    threshold constriction, remove/process/insert, and the farthest /
    constraint counters.  ``on_length`` runs once per replayed length for
    engine-specific tables.  Returns updated ``(farthest,
    last_constraint)``.

    Without ``on_length``, segments between constriction triggers
    collapse to one ``bulk_run_advance``: the queue total is constant
    during a run, so the only mid-run trigger is the
    ``max_nodes_wo_constraint`` counter, whose firing step is computable
    in closed form."""
    j = 0
    while on_length is None and j < steps:
        if j > 0:
            # constrict exactly as the scalar loop would before pop j
            while (
                len(tracker) > cfg.max_queue_size
                or last_constraint >= cfg.max_nodes_wo_constraint
            ) and tracker.threshold() < farthest:
                tracker.increment_threshold()
                last_constraint = 0
        # inside a segment the queue total transiently holds one extra
        # entry (each step's insert precedes the next step's remove);
        # if that would trip the queue-size trigger, every inner step
        # would constrict and the closed form breaks — go scalar
        if len(tracker) + 1 > cfg.max_queue_size:
            break
        seg = min(steps - j, cfg.max_nodes_wo_constraint - last_constraint)
        if seg <= 0:
            break  # budget pinned with threshold at farthest: go scalar
        if not tracker.bulk_run_advance(top_len + j, seg, fresh_pop=(j == 0)):
            break  # capacity edge: exact scalar loop handles it
        farthest = max(farthest, top_len + j + seg - 1)
        last_constraint += seg
        j += seg
    for j in range(j, steps):
        length = top_len + j
        if j > 0:
            while (
                len(tracker) > cfg.max_queue_size
                or last_constraint >= cfg.max_nodes_wo_constraint
            ) and tracker.threshold() < farthest:
                tracker.increment_threshold()
                last_constraint = 0
            tracker.remove(length)
        farthest = max(farthest, length)
        last_constraint += 1
        tracker.process(length)
        tracker.insert(length + 1)
        if on_length is not None:
            on_length(length)
    return farthest, last_constraint


def replay_arena_history(
    events, lens, kinds, trackers, far, lcon, cfg, creations=None,
    on_length=None,
):
    """Replay a device arena's committed pop sequence onto the real
    tracker objects — the one copy of the per-pop bookkeeping both
    engines' arena paths share (the engines' pop order: constrict every
    kind, remove, process, insert; the in-hand first pop was constricted
    and removed before the arena engaged).

    ``events`` is the history from ``run_arena``:

    - ``("commit", n)``: a committed extension pop of node ``n`` (remove,
      process, insert at length + 1).
    - ``("discard", n)``: a pop discarded on the device: only its queue
      removal (the engine's ignored-pop path).
    - ``("split", n)``: node ``n``'s pop was consumed by child creation:
      remove and process, no insert (its children's inserts follow).
    - ``("create", j)``: creation record ``j`` of ``creations`` registers
      the child at node index ``len(lens)`` and replays its insert; not a
      pop, so no constriction.

    ``lens``/``kinds`` are mutated in place and grow as children are
    registered; ``far``/``lcon`` are per kind, matching ``trackers``."""
    first_pop = True
    for kind, arg in events:
        if kind == "create":
            rec = creations[arg]
            lens.append(rec["created_len"])
            kinds.append(rec["kind"])
            trackers[rec["kind"]].insert(rec["created_len"])
            continue
        which = arg
        k = kinds[which]
        length = lens[which]
        if not first_pop:
            for kk in range(len(trackers)):
                while (
                    len(trackers[kk]) > cfg.max_queue_size
                    or lcon[kk] >= cfg.max_nodes_wo_constraint
                ) and trackers[kk].threshold() < far[kk]:
                    trackers[kk].increment_threshold()
                    lcon[kk] = 0
            trackers[k].remove(length)
        first_pop = False
        if kind == "discard":
            continue
        far[k] = max(far[k], length)
        lcon[k] += 1
        trackers[k].process(length)
        if kind == "commit":
            trackers[k].insert(length + 1)
            lens[which] += 1
        if on_length is not None:
            on_length(length)


def requeue_arena_nodes(
    pqueue, nodes, taken, node_steps, events, cost, on_duplicate,
    alive=None, n_live=None,
):
    """Re-queue arena participants preserving insertion order: extended
    nodes re-enter in the order of their last arena pop (a later pop is a
    newer insertion), children created on the device at their creation
    (or their last pop, if popped later); never-popped competitors keep
    their original sequence number (FIFO tie order).
    ``on_duplicate(idx, node)`` handles a key collision (drop the
    newcomer, undo its replayed tracker insert).  Nodes discarded or
    consumed by a split on the device (``alive[idx]`` False) are never
    re-queued: the caller frees them.  ``nodes`` covers the children
    (indices ``n_live + j`` in creation-record order)."""
    if n_live is None:
        n_live = len(nodes)
    last_pos = {}
    n_created = 0
    for i, (kind, arg) in enumerate(events):
        if kind == "commit":
            last_pos[arg] = i
        elif kind == "create":
            last_pos[n_live + n_created] = i
            n_created += 1
    for i, (cand, pri, seq) in enumerate(taken, start=1):
        if node_steps[i] == 0 and (alive is None or alive[i]):
            ok = pqueue.push_restored(cand.key(), cand, pri, seq)
            check_invariant(ok, "arena restore unique")
    for idx in sorted(last_pos, key=last_pos.get):
        if alive is not None and not alive[idx]:
            continue
        nd = nodes[idx]
        if not pqueue.push(nd.key(), nd, nd.priority(cost)):
            on_duplicate(idx, nd)


def accept_record(maximum_error, results, total, result, max_return_size):
    """Result acceptance: a strictly better total resets the budget and
    clears the tied set; totals at the budget append up to
    ``max_return_size``.  Returns the new budget."""
    if total < maximum_error:
        maximum_error = total
        results.clear()
    if total <= maximum_error and len(results) < max_return_size:
        results.append(result)
    return maximum_error


def candidates_from_stats(
    stats: BranchStats,
    symtab: np.ndarray,
    wildcard: Optional[int],
    weights: Optional[Sequence[float]] = None,
) -> Dict[int, float]:
    """Fold per-read integer tip votes into fractional per-symbol votes.

    Each read splits one unit of vote across its tip symbols
    (``occ/split``), optionally scaled by a per-read weight; reads are
    accumulated in index order in float64 so the sum is identical across
    backends.  The wildcard is dropped whenever any other candidate
    exists."""
    votes: Dict[int, float] = {}
    occ = stats.occ.tolist()
    split = stats.split.tolist()
    syms = symtab.tolist()
    for r, total in enumerate(split):
        if total == 0:
            continue
        w = 1.0 if weights is None else weights[r]
        if w <= 0.0:
            continue
        for s, c in enumerate(occ[r]):
            if c:
                sym = syms[s]
                add = c / total if weights is None else w * c / total
                votes[sym] = votes.get(sym, 0.0) + add
    if wildcard is not None and len(votes) > 1:
        votes.pop(wildcard, None)
    return votes


class _Node:
    """A search node: a partial consensus plus its scorer branch.

    ``prefetch`` holds this node's expanded children —
    ``(passing_symbols, {sym: [child_handle, child_stats]})`` — produced
    by a batched multi-node dispatch before the node was popped.  It is a
    pure cache: nomination is a deterministic function of ``stats``."""

    __slots__ = ("consensus", "handle", "active", "offsets", "stats", "prefetch")

    def __init__(self, consensus, handle, active, offsets, stats):
        self.consensus: bytes = consensus
        self.handle: int = handle
        self.active: List[bool] = active
        self.offsets: List[Optional[int]] = offsets
        self.stats: BranchStats = stats
        self.prefetch = None

    def key(self) -> Tuple:
        # Active wavefront state is a deterministic function of
        # (read, consensus, offset), so this tuple is full-state identity.
        return (self.consensus, tuple(self.offsets))

    def total_cost(self, cost: ConsensusCost) -> int:
        return sum(
            cost.apply(int(e)) for e, a in zip(self.stats.eds, self.active) if a
        )

    def priority(self, cost: ConsensusCost) -> Tuple[int, int]:
        # max-queue: smaller cost wins, then longer consensus
        return (-self.total_cost(cost), len(self.consensus))


def _replay_consensus(scorer, specs) -> None:
    """Advance freshly rooted branches to their nodes' consensuses by
    replaying every column through the ordinary ``push_many`` seam,
    batched across nodes per column (the checkpoint restore).

    The branch store keeps a branch-internal consensus buffer that
    ``activate`` replays when catching a late read's wavefront up — a
    fresh root's buffer is empty, so a restore must fill it *before*
    activating the node's reads.  No reads are tracked during the
    replay, so the pushes only extend the buffer; the ``activate``
    catch-up that follows (one column-replay launch a read on a CUDA
    device) then walks the same per-column step the live search used.
    ``specs`` is ``[(handle, consensus), ...]``."""
    longest = max((len(consensus) for _h, consensus in specs), default=0)
    for col in range(longest):
        scorer.push_many([
            (handle, consensus[: col + 1])
            for handle, consensus in specs if len(consensus) > col
        ])


class ConsensusDWFA:
    """Generates the single best consensus (or the tied set) for the added
    sequences."""

    def __init__(self, config: Optional[CdwfaConfig] = None) -> None:
        self.config = config if config is not None else CdwfaConfig()
        self.sequences: List[bytes] = []
        self.offsets: List[Optional[int]] = []
        self.alphabet: set = set()

    @classmethod
    def with_config(cls, config: CdwfaConfig) -> "ConsensusDWFA":
        return cls(config)

    def add_sequence(self, sequence: bytes) -> None:
        self.add_sequence_offset(sequence, None)

    def add_sequence_offset(
        self, sequence: bytes, last_offset: Optional[int]
    ) -> None:
        sequence = bytes(sequence)
        self.alphabet.update(sequence)
        if self.config.wildcard is not None:
            self.alphabet.discard(self.config.wildcard)
        self.sequences.append(sequence)
        self.offsets.append(last_offset)

    @property
    def consensus_cost(self) -> ConsensusCost:
        return self.config.consensus_cost

    # ------------------------------------------------------------------

    def consensus(self) -> List[Consensus]:
        """Run the least-cost-first search and return every tied-best
        consensus, lexicographically sorted.  Search-shape counters land
        in ``self.last_search_stats``, the structured
        :class:`~waffle_con_tpu_torch.obs.report.SearchReport` in
        ``self.last_search_report``."""
        return _reported_search(self, "single", self._consensus_impl)

    def _consensus_impl(self) -> List[Consensus]:
        cfg = self.config
        cost = cfg.consensus_cost
        restore = getattr(self, "_restore_state", None)
        self._restore_state = None
        maximum_error = math.inf
        nodes_explored = 0
        nodes_ignored = 0
        peak_queue_size = 0
        farthest_consensus = 0
        last_constraint = 0

        offsets = shift_offsets(self.offsets, cfg.auto_shift_offsets)
        logger.debug("Offsets: %s", offsets)

        # lengths at which late reads activate
        activate_points: Dict[int, List[int]] = {}
        max_activate = 0
        initially_active = 0
        for seq_index, offset in enumerate(offsets):
            if offset is not None:
                activate_length = offset + cfg.offset_compare_length
                activate_points.setdefault(activate_length, []).append(seq_index)
                max_activate = max(max_activate, activate_length)
            else:
                initially_active += 1
        if initially_active == 0:
            raise EngineError(
                "Must have at least one initial offset of None to see the consensus."
            )

        scorer = make_scorer(self.sequences, cfg)
        self._max_sequence_len = max(len(s) for s in self.sequences)
        tracker = PQueueTracker(
            self._max_sequence_len, cfg.max_capacity_per_size
        )
        pqueue = SetPriorityQueue()

        results: List[Consensus] = []
        pops = 0
        if restore is None:
            active = [o is None for o in offsets]
            root_handle = scorer.root(np.array(active, dtype=bool))
            root = _Node(
                b"",
                root_handle,
                active,
                [0 if a else None for a in active],
                scorer.stats(root_handle, b""),
            )
            tracker.insert(0)
            pqueue.push(root.key(), root, root.priority(cost))
        else:
            (maximum_error, nodes_explored, nodes_ignored, peak_queue_size,
             farthest_consensus, last_constraint, pops, results) = (
                self._restore_search(restore, scorer, pqueue, tracker, cost)
            )
        fp = fast_paths(scorer)
        frontier = FrontierSampler("single")
        speculator = FrontierSpeculator(scorer, cfg)
        #: decision audit sink (``None`` when no capture is installed —
        #: the zero-overhead decision, made once per search)
        audit = obs_audit.search_sink("single")

        ctrl = ckpt_mod.current_controller()

        def _ckpt_body() -> Dict:
            # a closure over the loop locals: reads their values at
            # snapshot time, always at the top-of-pop-loop boundary
            return self._checkpoint_body(
                pqueue, tracker,
                maximum_error=maximum_error,
                nodes_explored=nodes_explored,
                nodes_ignored=nodes_ignored,
                peak_queue_size=peak_queue_size,
                farthest_consensus=farthest_consensus,
                last_constraint=last_constraint,
                pops=pops,
                results=results,
            )

        while not pqueue.is_empty():
            if ctrl is not None:
                try:
                    ctrl.poll(pops, _ckpt_body)
                finally:
                    self._last_checkpoint = ctrl.last_checkpoint
            peak_queue_size = max(peak_queue_size, len(pqueue))

            while (
                len(tracker) > cfg.max_queue_size
                or last_constraint >= cfg.max_nodes_wo_constraint
            ) and tracker.threshold() < farthest_consensus:
                tracker.increment_threshold()
                last_constraint = 0

            node, priority = pqueue.pop()
            pops += 1
            if pops % PROGRESS_LOG_INTERVAL == 0:
                logger.debug(
                    "search progress: %d pops, queue=%d, farthest=%d, "
                    "best_cost=%d", pops, len(pqueue), farthest_consensus,
                    -priority[0],
                )
                if obs_metrics.metrics_enabled():
                    obs_metrics.registry().gauge(
                        "waffle_search_queue_depth", engine="single"
                    ).set(len(pqueue))
            next_prio = pqueue.peek_priority()
            # the gang width of this pop: the policy sees every pop's
            # frontier (depth, best-vs-next gap), so cooldowns run in real
            # pops; gangs only launch on the run path below
            gang_w = speculator.width(
                len(pqueue),
                (-next_prio[0]) - (-priority[0])
                if next_prio is not None else None,
            )
            if frontier.due(pops):
                frontier.sample(
                    pops, len(pqueue), len(tracker), -priority[0],
                    -next_prio[0] if next_prio is not None else None,
                    len(node.consensus), farthest_consensus,
                    counters=scorer.counters, gang_width=gang_w,
                )
            top_cost = -priority[0]
            top_len = len(node.consensus)
            tracker.remove(top_len)
            if audit is not None:
                # node identity digests: host bytes/flags the engine
                # already holds (nothing is read from the device)
                a_dig = obs_audit.crc_bytes(node.consensus)
                a_act = obs_audit.active_digest(
                    i for i, a in enumerate(node.active) if a
                )

            if (
                top_cost > maximum_error
                or top_len < tracker.threshold()
                or tracker.at_capacity(top_len)
            ):
                nodes_ignored += 1
                if audit is not None:
                    audit.emit({
                        "kind": "ignored", "pop": pops, "len": top_len,
                        "dig": a_dig, "act": a_act, "prio": top_cost,
                    })
                self._drop_prefetch(scorer, node)
                scorer.free(node.handle)
                continue

            # -- device fast path: extend the popped node through
            # unambiguous stretches on device (one host round-trip per
            # event instead of per base), then replay the per-length
            # bookkeeping exactly.  The run continues while the node keeps
            # winning pops ((-cost, len) priority vs the best other queued
            # entry; full ties lose to the earlier insert) and only
            # engages when this pop's own nomination is a single candidate
            # — otherwise step 0 would stop immediately.  max_steps is
            # bounded by an exact host simulation of the threshold /
            # capacity bookkeeping, so the run may start behind the
            # farthest frontier without replaying a step the real search
            # would have pruned.
            run_extend = fp.run_extend
            reached_now = self._reached_end(node, cfg.allow_early_termination)
            force_sym = -1
            engage = False
            if run_extend is not None:
                passing_now = (
                    node.prefetch[0]
                    if node.prefetch is not None
                    else self._nominate(scorer, node)
                )
                # -- arena fast path: resolve the pop competition among
                # the in-hand node and the next-best queue entries on the
                # device (see DualConsensusDWFA._arena_attempt).  The
                # arena absorbs no records, so reached nodes skip it.
                if (
                    not reached_now
                    and (
                        len(passing_now) == 1
                        or 2 <= len(passing_now) <= fp.arena_cre_per_event
                    )
                    and fp.run_arena is not None
                    # under the lockstep shadow the arena's opaque subtree
                    # absorption would hide per-pop decisions from the
                    # comparator; strict alignment skips it (the arena is
                    # a pure fast path)
                    and not (audit is not None and audit.strict_align)
                    # a pending gang deposit is this pop's run already
                    # paid for; the arena would drop it unspent
                    and not speculator.pending(node.handle)
                ):
                    arena = self._arena_attempt(
                        scorer, pqueue, node, maximum_error,
                        activate_points, cost, tracker,
                        farthest_consensus, last_constraint,
                    )
                    if arena is not None:
                        (farthest_consensus, last_constraint,
                         arena_explored, arena_ignored) = arena
                        nodes_explored += arena_explored
                        nodes_ignored += arena_ignored
                        if audit is not None:
                            audit.emit({
                                "kind": "arena", "pop": pops,
                                "len": top_len, "dig": a_dig,
                                "act": a_act, "prio": top_cost,
                                "explored": arena_explored,
                                "ignored": arena_ignored,
                            })
                        continue
                best_other = pqueue.peek_priority()
                other_cost = 2**31 - 1
                other_len = 0
                if best_other is not None:
                    other_cost = -best_other[0]
                    other_len = best_other[1]
                if (
                    len(passing_now) == 1
                    and not reached_now
                    and len(scorer.symtab) > 1
                    and faults_mod.maybe_flip_vote(cfg.backend, top_len)
                ):
                    # injected wrong *decision* (the ``flip_vote`` fault):
                    # silently commit a different alphabet symbol than
                    # the nomination voted for — invisible to every
                    # result check, catchable only by the audit plane
                    self._drop_prefetch(scorer, node)
                    wrong = (
                        scorer.sym_id[passing_now[0]] + 1
                    ) % len(scorer.symtab)
                    passing_now = [int(scorer.symtab[wrong])]
                # -- forced-child fold: with exactly one passing symbol
                # and no prefetched children, the expand path's outcome
                # is fully known host-side (one child = consensus + sym),
                # so the run call pushes it as its forced step 0 and
                # simply stops there if the child would lose the next
                # pop.  A reached pop must evaluate its record through
                # the kernel's loop checks, so it is never forced.
                if (
                    len(passing_now) == 1
                    and node.prefetch is None
                    and not reached_now
                ):
                    force_sym = int(scorer.sym_id[passing_now[0]])
                engage = len(passing_now) == 1 and (
                    force_sym >= 0
                    or top_cost < other_cost
                    or (top_cost == other_cost and top_len > other_len)
                )
            if engage:
                next_act = min(
                    (l for l in activate_points if l > top_len), default=None
                )
                max_steps = min(self._max_sequence_len * 2 + 256, RUN_SIM_CAP)
                if next_act is not None:
                    max_steps = min(max_steps, next_act - top_len - 1)
                if max_steps >= 1:
                    max_steps = tracker.simulate_run_bound(
                        top_len,
                        farthest_consensus,
                        last_constraint,
                        cfg.max_queue_size,
                        cfg.max_nodes_wo_constraint,
                        max_steps,
                    )
                # a shape the run kernel's planner refuses takes the
                # expand path below, the same exact search
                if max_steps >= 1 and fp.run_takes():
                    me_budget = (
                        int(maximum_error)
                        if maximum_error != math.inf
                        else 2**31 - 1
                    )
                    # frontier-parallel speculation: alongside this run,
                    # advance the next-best queued branches in one gang
                    # launch; their results wait as consume-once deposits
                    # for their own pops
                    if gang_w > 1:
                        self._gang_attempt(
                            speculator, scorer, pqueue, node, gang_w,
                            me_budget, other_cost, other_len, max_steps,
                            force_sym, maximum_error,
                            cost is ConsensusCost.L2_DISTANCE,
                        )
                    steps, _code, appended, run_stats, records = run_extend(
                        node.handle,
                        node.consensus,
                        me_budget,
                        other_cost,
                        other_len,
                        cfg.min_count,
                        cost is ConsensusCost.L2_DISTANCE,
                        max_steps,
                        first_sym=force_sym,
                        # under early termination the host's require-all
                        # record condition can never hold while a read
                        # is not yet activated, but the kernel's
                        # conservative fold would buffer bogus records
                        allow_records=(
                            not cfg.allow_early_termination
                            or all(node.active)
                        ),
                    )
                    # replay absorbed reached-state records in commit
                    # order, exactly as the completion path would have at
                    # each pop (the stopped state is NOT in the buffer —
                    # its own pop records it below)
                    for rec_j, rec_fin in records:
                        if not all(node.active):
                            scorer.free(node.handle)
                            raise EngineError(
                                "Finalize called on DWFA that was never initialized."
                            )
                        rec_scores = [cost.apply(int(v)) for v in rec_fin]
                        maximum_error = accept_record(
                            maximum_error,
                            results,
                            sum(rec_scores),
                            Consensus(
                                node.consensus + appended[:rec_j],
                                cost,
                                rec_scores,
                            ),
                            cfg.max_return_size,
                        )
                    # the snapshot matches the stopped position whether
                    # or not steps committed, so adopt it either way — its
                    # fin field saves the finalize call at a reached pop
                    node.stats = run_stats
                    if audit is not None and steps > 0:
                        audit.emit({
                            "kind": "run", "pop": pops, "len": top_len,
                            "dig": a_dig, "act": a_act, "prio": top_cost,
                            "via": "run",
                            "code": int(_code),
                            "forced": force_sym >= 0,
                            "syms": obs_audit.b64(appended),
                            "finals": [int(rj) for rj, _ in records],
                            "tail": obs_audit.tail(
                                node.consensus + appended
                            ),
                        })
                    if steps > 0:
                        # the branch advanced past the prefetched children
                        self._drop_prefetch(scorer, node)
                        farthest_consensus, last_constraint = (
                            replay_run_bookkeeping(
                                tracker,
                                cfg,
                                top_len,
                                steps,
                                farthest_consensus,
                                last_constraint,
                            )
                        )
                        nodes_explored += steps
                        node.consensus = node.consensus + appended
                        if not pqueue.push(
                            node.key(), node, node.priority(cost)
                        ):  # pragma: no cover - chain nodes are unique
                            tracker.remove(len(node.consensus))
                            scorer.free(node.handle)
                        continue

            farthest_consensus = max(farthest_consensus, top_len)
            nodes_explored += 1
            last_constraint += 1
            tracker.process(top_len)

            # -- result check: any (or, with early termination, all) read
            # touching its baseline end means this consensus may be complete
            if reached_now:
                if not all(node.active):
                    scorer.free(node.handle)
                    raise EngineError(
                        "Finalize called on DWFA that was never initialized."
                    )
                fin_eds = (
                    node.stats.fin
                    if node.stats.fin is not None
                    else scorer.finalized_eds(node.handle, node.consensus)
                )
                fin_scores = [cost.apply(int(e)) for e in fin_eds]
                maximum_error = accept_record(
                    maximum_error,
                    results,
                    sum(fin_scores),
                    Consensus(node.consensus, cost, fin_scores),
                    cfg.max_return_size,
                )
                if audit is not None:
                    audit.emit({
                        "kind": "final", "pop": pops, "len": top_len,
                        "dig": a_dig, "act": a_act,
                        "score": sum(fin_scores),
                    })

            # -- nominate + expand: the popped node's children and the
            # next best queued nodes' children go through ONE batched
            # clone+push dispatch, consumed when those nodes are popped
            if node.prefetch is None:
                peers = [
                    n
                    for n, _p in pqueue.peek_top(cfg.prefetch_width - 1)
                    # a pending gang deposit is consumed by a forced pop;
                    # prefetching the peer would unforce it
                    if n.prefetch is None
                    and not speculator.pending(n.handle)
                ]
                self._prefetch_expansions(
                    scorer, [node] + peers, in_place_first=True
                )
            passing, expansion = node.prefetch
            node.prefetch = None
            if audit is not None:
                audit.emit({
                    "kind": "branch", "pop": pops, "len": top_len,
                    "dig": a_dig, "act": a_act, "prio": top_cost,
                    "syms": obs_audit.b64(bytes(sorted(passing))),
                    "tail": obs_audit.tail(node.consensus),
                })

            new_nodes: List[_Node] = []
            if not passing:
                if top_len < max_activate:
                    scorer.free(node.handle)
                    raise EngineError(
                        f"Encountered coverage gap: consensus is length {top_len} "
                        f"with no candidates, but sequences activate at {max_activate}"
                    )
                scorer.free(node.handle)
                # otherwise: dead end past all activations, drop the branch
            else:
                for sym in passing:
                    handle, stats = expansion[sym]
                    new_nodes.append(
                        _Node(
                            node.consensus + bytes([sym]),
                            handle,
                            list(node.active),
                            list(node.offsets),
                            stats,
                        )
                    )
                if all(c.handle != node.handle for c in new_nodes):
                    scorer.free(node.handle)

            for child in new_nodes:
                activate_list = activate_points.get(len(child.consensus))
                if activate_list:
                    for seq_index in activate_list:
                        self._activate(scorer, child, seq_index)
                    child.stats = scorer.stats(child.handle, child.consensus)
                tracker.insert(len(child.consensus))
                if not pqueue.push(child.key(), child, child.priority(cost)):
                    # identical node already queued (cannot normally happen:
                    # a consensus string uniquely identifies its path)
                    logger.warning("duplicate search node %r", child.consensus)
                    tracker.remove(len(child.consensus))
                    scorer.free(child.handle)

        check_invariant(len(tracker) == 0, "tracker drained at search end")

        results.sort(key=lambda c: c.sequence)
        self.last_search_stats = {
            "nodes_explored": nodes_explored,
            "nodes_ignored": nodes_ignored,
            "peak_queue_size": peak_queue_size,
            "scorer_counters": dict(scorer.counters),
            # a supervised scorer names the backend it ended on
            "backend": getattr(scorer, "backend", None) or cfg.backend,
        }
        enforce_dispatch_budget(
            cfg, self.last_search_stats["scorer_counters"], "single"
        )
        return results

    # -- checkpoint / resume -------------------------------------------

    def snapshot(self) -> Optional["ckpt_mod.SearchCheckpoint"]:
        """The most recent :class:`SearchCheckpoint` built for this
        engine's search (by the installed
        :class:`~waffle_con_tpu_torch.models.checkpoint.CheckpointController`),
        or ``None`` — survives a preempted/expired search."""
        return getattr(self, "_last_checkpoint", None)

    def _checkpoint_body(
        self, pqueue, tracker, *, maximum_error, nodes_explored,
        nodes_ignored, peak_queue_size, farthest_consensus,
        last_constraint, pops, results,
    ) -> Dict:
        """JSON checkpoint body at a pop boundary.  Only host-level node
        identity travels (consensus bytes, active sets, offsets) — never
        scorer handles or device tensors; prefetch caches, frontier-gang
        deposits and the arena's scratch slots are deliberately absent
        (dropping them is byte-safe: they are pure caches / consume-once
        speculation)."""
        entries = []
        for _key, nd, pri, seq in pqueue.export_entries():
            entries.append({
                "consensus": ckpt_mod.b64(nd.consensus),
                "active": [1 if a else 0 for a in nd.active],
                "offsets": [o if o is None else int(o)
                            for o in nd.offsets],
                "priority": [int(p) for p in pri],
                "seq": int(seq),
            })
        return {
            "kind": "single",
            "config": ckpt_mod.encode_config_dict(self.config),
            "reads": [ckpt_mod.b64(s) for s in self.sequences],
            "offsets": [o if o is None else int(o) for o in self.offsets],
            "state": {
                "entries": entries,
                "queue_seq": pqueue.export_seq(),
                "tracker": tracker.export_state(),
                "maximum_error": (None if maximum_error == math.inf
                                  else int(maximum_error)),
                "nodes_explored": int(nodes_explored),
                "nodes_ignored": int(nodes_ignored),
                "peak_queue_size": int(peak_queue_size),
                "farthest_consensus": int(farthest_consensus),
                "last_constraint": int(last_constraint),
                "pops": int(pops),
                "results": [
                    {"sequence": ckpt_mod.b64(c.sequence),
                     "scores": [int(s) for s in c.scores]}
                    for c in results
                ],
            },
        }

    def _restore_search(self, restore, scorer, pqueue, tracker, cost):
        """Rebuild the mid-search state captured by
        :meth:`_checkpoint_body` and return the loop-local tuple.

        Each branch is rebuilt through the ordinary scorer seam — fresh
        ``root``, the node's consensus replayed column by column through
        ``push_many`` (see :func:`_replay_consensus`), then one
        ``activate`` per active read (a column-replay launch on a CUDA
        device) — which is bit-identical on any backend because active wavefront state is a deterministic
        function of ``(read, consensus, offset)`` and ``activate``'s
        catch-up walks the same per-column step the live search used
        (late activation behind the frontier is an ordinary mid-search
        event).  The stored priorities double as an integrity check: a
        rebuilt node whose priority disagrees with the checkpoint means
        the checkpoint does not belong to these reads/config, and the
        restore is rejected rather than silently corrupting the
        search."""
        st = restore["state"]
        cost_local = cost
        extra = int(restore.get("extra", 0))
        n_total = len(self.sequences)
        n_base = n_total - extra
        try:
            if not extra:
                tracker.restore_state(st["tracker"])
            results = [
                Consensus(ckpt_mod.unb64(r["sequence"]), cost_local,
                          [int(s) for s in r["scores"]])
                for r in st["results"]
            ]
            maximum_error = (math.inf if st["maximum_error"] is None
                             else int(st["maximum_error"]))
            staged = []
            for entry in st["entries"]:
                consensus = ckpt_mod.unb64(entry["consensus"])
                active = [bool(a) for a in entry["active"]]
                offs = [o if o is None else int(o)
                        for o in entry["offsets"]]
                if len(active) != n_base or len(offs) != n_base:
                    raise ckpt_mod.CheckpointRejected(
                        "node read-count mismatch vs checkpoint reads"
                    )
                # incremental reads join every live branch at offset 0
                active += [True] * extra
                offs += [0] * extra
                handle = scorer.root(np.zeros(n_total, dtype=bool))
                staged.append((entry, consensus, active, offs, handle))
            _replay_consensus(
                scorer, [(handle, consensus)
                         for _e, consensus, _a, _o, handle in staged]
            )
            for entry, consensus, active, offs, handle in staged:
                for read_index, is_active in enumerate(active):
                    if is_active:
                        scorer.activate(
                            handle, read_index, offs[read_index], consensus
                        )
                node = _Node(
                    consensus, handle, active, offs,
                    scorer.stats(handle, consensus),
                )
                prio = node.priority(cost_local)
                if not extra and tuple(int(p) for p in prio) != tuple(
                    int(p) for p in entry["priority"]
                ):
                    raise ckpt_mod.CheckpointRejected(
                        "restored node priority mismatch — checkpoint "
                        "does not match its reads/config"
                    )
                if extra:
                    tracker.insert(len(consensus))
                pqueue.push_restored(
                    node.key(), node, prio, int(entry["seq"])
                )
            pqueue.restore_seq(int(st["queue_seq"]))
            if extra:
                # the wider read set invalidates the accepted results
                # and the cost bound; the search re-derives both
                results = []
                maximum_error = math.inf
            return (
                maximum_error,
                int(st["nodes_explored"]),
                int(st["nodes_ignored"]),
                int(st["peak_queue_size"]),
                int(st["farthest_consensus"]),
                int(st["last_constraint"]),
                int(st["pops"]),
                results,
            )
        except ckpt_mod.CheckpointError:
            raise
        except (KeyError, TypeError, ValueError, IndexError) as exc:
            raise ckpt_mod.CheckpointRejected(
                f"malformed single-engine checkpoint state: {exc}"
            ) from None

    @classmethod
    def resume(
        cls, checkpoint, extra_reads: Sequence[bytes] = ()
    ) -> "ConsensusDWFA":
        """An engine primed to continue ``checkpoint`` (a
        :class:`SearchCheckpoint` or its wire-dict form); run
        :meth:`consensus` on it to finish the search.  ``extra_reads``
        join every live branch initially-active at offset 0 —
        incremental (streaming) resume; with no extras the resumed
        search is byte-identical to the uninterrupted one."""
        body = ckpt_mod.resume_body(checkpoint, "single")
        try:
            config = ckpt_mod.decode_config_dict(body["config"])
            reads = [ckpt_mod.unb64(r) for r in body["reads"]]
            offsets = [o if o is None else int(o)
                       for o in body["offsets"]]
            state = body["state"]
            if not isinstance(state, dict) or len(reads) != len(offsets):
                raise ckpt_mod.CheckpointRejected(
                    "malformed single-engine checkpoint body"
                )
        except ckpt_mod.CheckpointError:
            raise
        except (KeyError, TypeError, ValueError) as exc:
            raise ckpt_mod.CheckpointRejected(
                f"malformed single-engine checkpoint body: {exc}"
            ) from None
        engine = cls(config)
        for read, offset in zip(reads, offsets):
            engine.add_sequence_offset(read, offset)
        extras = [bytes(r) for r in extra_reads]
        for read in extras:
            engine.add_sequence(read)
        engine._restore_state = {"state": state, "extra": len(extras)}
        return engine

    # ------------------------------------------------------------------

    def _arena_attempt(
        self, scorer, pqueue, node, maximum_error, activate_points, cost,
        tracker, farthest_consensus, last_constraint,
    ):
        """The device pop arena for the single engine (dual twin:
        ``DualConsensusDWFA._arena_attempt``): the in-hand node plus up to
        ``ARENA_TAKE_MAX`` next-best queue entries extend on the device
        under the exact pop and tracker semantics, and clean vote splits
        become children there (``create_mode=1``: one single child per
        passing symbol).  Returns ``None`` when not engaged (competitors
        restored with their original insertion order), else
        ``(farthest_consensus, last_constraint, explored, ignored)``."""
        cfg = self.config
        if pqueue.is_empty():
            return None  # no competitor: the plain run path is better
        fp = fast_paths(scorer)
        taken = []
        while len(taken) < fp.arena_take_max and not pqueue.is_empty():
            taken.append(pqueue.pop_with_seq())
        nodes = [node] + [t[0] for t in taken]

        def restore_all():
            for cand, pri, seq in taken:
                pqueue.push_restored(cand.key(), cand, pri, seq)

        step_limit = fp.arena_cap
        for nd in nodes:
            nl = len(nd.consensus)
            next_act = min((l for l in activate_points if l > nl), default=None)
            if next_act is not None:
                step_limit = min(step_limit, next_act - nl - 1)
        if step_limit < 1:
            restore_all()
            return None

        rest = pqueue.peek_priority()
        rest_cost, rest_len = 2**31 - 1, 0
        if rest is not None:
            rest_cost, rest_len = -rest[0], rest[1]
        needed = max(
            max(len(nd.consensus) for nd in nodes), farthest_consensus
        ) + fp.arena_cap + 4
        win_len = 1 << (needed - 1).bit_length()
        lc, pc = tracker.export_windows(win_len)
        zeros = np.zeros(win_len, dtype=np.int32)
        tr_scalars = [
            [tracker.threshold(), len(tracker), farthest_consensus,
             last_constraint],
            [0, 0, 0, 0],  # the single engine has no dual node kind
        ]
        if not fp.arena_takes(win_len):
            restore_all()
            return None  # the arena kernel's planner refuses the shape
        me_budget = (
            int(maximum_error) if maximum_error != math.inf else 2**31 - 1
        )
        (events, nsteps, _code, _stop_node, node_steps, appended,
         sides_stats, _sides_act, alive, creations) = fp.run_arena(
            [(nd.handle, None, len(nd.consensus), 0) for nd in nodes],
            me_budget,
            cfg.min_count,
            0,
            0,
            cost is ConsensusCost.L2_DISTANCE,
            False,
            rest_cost,
            rest_len,
            cfg.max_queue_size,
            cfg.max_capacity_per_size,
            step_limit,
            cfg.max_nodes_wo_constraint,
            np.stack([lc, zeros]),
            np.stack([pc, zeros]),
            np.asarray(tr_scalars, dtype=np.int32),
            create_mode=1,
        )
        if nsteps == 0:
            restore_all()
            return None

        n_live = len(nodes)
        for i, nd in enumerate(nodes):
            if node_steps[i] > 0 or not alive[i]:
                self._drop_prefetch(scorer, nd)
        lens = [len(nd.consensus) for nd in nodes]
        far = [farthest_consensus]
        lcon = [last_constraint]
        replay_arena_history(
            events, lens, [0] * len(nodes), [tracker], far, lcon, cfg,
            creations=creations,
        )
        # extensions of the original nodes first (a split-consumed parent
        # keeps its committed prefix, which its children build on)
        for i, nd in enumerate(nodes):
            if node_steps[i]:
                nd.consensus = nd.consensus + appended[2 * i]
                nd.stats = sides_stats[2 * i]
        all_nodes = list(nodes)
        for j, cre in enumerate(creations):
            idx = n_live + j
            parent = all_nodes[cre["parent"]]
            all_nodes.append(_Node(
                parent.consensus[: cre["created_len"] - 1]
                + bytes([cre["sym1"]]) + appended[2 * idx],
                cre["h1"],
                list(parent.active),
                list(parent.offsets),
                sides_stats[2 * idx],
            ))

        def on_duplicate(_idx, nd):
            # converged to an existing key: drop the newcomer and undo its
            # replayed tracker insert (as the expansion path does)
            logger.warning("duplicate search node (arena re-queue)")
            tracker.remove(len(nd.consensus))
            scorer.free(nd.handle)

        requeue_arena_nodes(
            pqueue, all_nodes, taken, node_steps, events, cost,
            on_duplicate, alive=alive, n_live=n_live,
        )
        for i, nd in enumerate(all_nodes):
            if not alive[i]:
                scorer.free(nd.handle)
        explored = sum(1 for k, _ in events if k in ("commit", "split"))
        ignored = sum(1 for k, _ in events if k == "discard")
        return far[0], lcon[0], explored, ignored

    def _gang_attempt(
        self,
        speculator: FrontierSpeculator,
        scorer: WavefrontScorer,
        pqueue: SetPriorityQueue,
        node: _Node,
        gang_w: int,
        me_budget: int,
        other_cost: int,
        other_len: int,
        max_steps: int,
        force_sym: int,
        maximum_error: float,
        l2: bool,
    ) -> None:
        """Frontier-parallel speculation: gang the in-hand node's run with
        the next-best queued branches in one launch.

        The in-hand member carries its real call arguments (its deposit is
        consumed by the ``run_extend`` right after).  Peers are chosen so
        that their own pop will make the forced call the speculation
        assumes: not prefetched, not reached, exactly one passing symbol
        (the same ``_nominate`` the pop evaluates, so the forced symbol
        matches).  Their competitor (cost, length) is predicted from the
        entry peeked behind them; a misprediction is caught when the
        deposit is validated, so peer choice only tunes how often deposits
        are used."""
        cfg = self.config
        members: List[GangMember] = []
        if not speculator.pending(node.handle):
            members.append(GangMember(
                node.handle, node.consensus, me_budget, other_cost,
                other_len, max_steps, force_sym,
            ))
        peeked = pqueue.peek_top(gang_w)
        for i, (pn, pprio) in enumerate(peeked):
            if len(members) >= gang_w:
                break
            if -pprio[0] > maximum_error:
                continue  # its pop will be ignored, not run
            if pn.prefetch is not None or speculator.pending(pn.handle):
                continue
            if self._reached_end(pn, cfg.allow_early_termination):
                continue  # a reached pop is never forced
            passing = self._nominate(scorer, pn)
            if len(passing) != 1:
                continue
            if i + 1 < len(peeked):
                nxt = peeked[i + 1][1]
                poc, pol = -nxt[0], nxt[1]
            else:
                poc, pol = 2**31 - 1, 0
            members.append(GangMember(
                pn.handle, pn.consensus, me_budget, poc, pol,
                max_steps, int(scorer.sym_id[passing[0]]),
            ))
        if len(members) >= 2:
            speculator.gang(members, cfg.min_count, l2)

    def _nominate(self, scorer: WavefrontScorer, node: _Node) -> List[int]:
        """Passing extension symbols for a node — a pure function of its
        stats (so it can run at prefetch time with an identical result)."""
        cfg = self.config
        candidates = candidates_from_stats(
            node.stats, scorer.symtab, cfg.wildcard
        )
        max_observed = max(candidates.values(), default=float(cfg.min_count))
        active_threshold = min(float(cfg.min_count), max_observed)
        return sorted(
            sym for sym, count in candidates.items() if count >= active_threshold
        )

    def _prefetch_expansions(
        self,
        scorer: WavefrontScorer,
        nodes: List[_Node],
        in_place_first: bool = False,
    ) -> None:
        """Expand every listed node's children in one batched clone+push
        dispatch (or one clone plus one push dispatch), storing the
        results on the nodes.

        ``in_place_first``: when the FIRST node has exactly one passing
        symbol, push its sole child onto the parent's own branch slot
        instead of a clone — exact because the parent is the in-hand pop,
        consumed and freed in this same iteration (never valid for peers,
        whose pristine state is still needed at their own pop)."""
        per_node_passing = [self._nominate(scorer, n) for n in nodes]
        clone_push = fast_paths(scorer).clone_push_many
        if clone_push is not None:
            specs: List[Tuple[int, bytes, bool]] = []
            slots: List[List] = []
            for i, (node, passing) in enumerate(
                zip(nodes, per_node_passing)
            ):
                expansion = {}
                reuse = in_place_first and i == 0 and len(passing) == 1
                for sym in passing:
                    entry = [None, None]
                    expansion[sym] = entry
                    specs.append(
                        (node.handle, node.consensus + bytes([sym]), reuse)
                    )
                    slots.append(entry)
                node.prefetch = (passing, expansion)
            for entry, (handle, stats) in zip(slots, clone_push(specs)):
                entry[0] = handle
                entry[1] = stats
            return
        clone_srcs: List[int] = []
        for i, (node, passing) in enumerate(zip(nodes, per_node_passing)):
            if not (in_place_first and i == 0 and len(passing) == 1):
                clone_srcs.extend([node.handle] * len(passing))
        handles = scorer.clone_many(clone_srcs)
        push_specs: List[Tuple[int, bytes]] = []
        slots = []
        hi = 0
        for i, (node, passing) in enumerate(zip(nodes, per_node_passing)):
            expansion = {}
            reuse = in_place_first and i == 0 and len(passing) == 1
            for sym in passing:
                if reuse:
                    handle = node.handle
                else:
                    handle = handles[hi]
                    hi += 1
                entry = [handle, None]
                expansion[sym] = entry
                push_specs.append((handle, node.consensus + bytes([sym])))
                slots.append(entry)
            node.prefetch = (passing, expansion)
        for entry, stats in zip(slots, scorer.push_many(push_specs)):
            entry[1] = stats

    def _drop_prefetch(self, scorer: WavefrontScorer, node: _Node) -> None:
        if node.prefetch is not None:
            for handle, _stats in node.prefetch[1].values():
                scorer.free(handle)
            node.prefetch = None

    def _reached_end(self, node: _Node, require_all: bool) -> bool:
        flags = [
            bool(r) if a else False
            for r, a in zip(node.stats.reached, node.active)
        ]
        return all(flags) if require_all else any(flags)

    def _activate(
        self, scorer: WavefrontScorer, node: _Node, seq_index: int
    ) -> None:
        check_invariant(not node.active[seq_index], "activating an already-active read")
        cfg = self.config
        offset = scorer.best_activation_offset(
            node.consensus,
            seq_index,
            cfg.offset_window,
            cfg.offset_compare_length,
            cfg.wildcard,
        )
        scorer.activate(node.handle, seq_index, offset, node.consensus)
        node.active[seq_index] = True
        node.offsets[seq_index] = offset

