"""Dual-consensus engine: finds the one *or two* best consensuses for a
set of reads (e.g. the two haplotypes of a diplotype).

The port of ``waffle_con_tpu``'s ``models/dual_consensus.py``: the same
search, byte for byte, over the
:class:`~waffle_con_tpu_torch.ops.scorer.WavefrontScorer` seam.  A search
node carries one or two consensus branches; non-dual nodes may *split*
into dual nodes whenever two extension symbols both gather enough votes,
and each read's pair of wavefronts is pruned to one side once their edit
distances diverge beyond ``dual_max_ed_delta`` — that emergent pruning is
what assigns reads to haplotypes.  On the ``"torch"`` backend a popped
node whose expansion is a single child extends through unambiguous
stretches inside one device run call: ``run_extend`` for a non-dual node
and ``run_extend_dual`` for a dual one — on a CUDA device one launch of
the matching hand-written kernel per engagement.

Example::

    from waffle_con_tpu_torch import CdwfaConfigBuilder, DualConsensusDWFA

    engine = DualConsensusDWFA(CdwfaConfigBuilder().backend("torch").build())
    for s in reads:
        engine.add_sequence(s)
    results = engine.consensus()
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.models.consensus import (
    PROGRESS_LOG_INTERVAL,
    RUN_SIM_CAP,
    Consensus,
    EngineError,
    _replay_consensus,
    accept_record,
    candidates_from_stats,
    check_invariant,
    replay_arena_history,
    replay_run_bookkeeping,
    requeue_arena_nodes,
    shift_offsets,
)
from waffle_con_tpu_torch.models.frontier import FrontierSpeculator, GangMember
from waffle_con_tpu_torch.obs import audit as obs_audit
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs.instrument import FrontierSampler
from waffle_con_tpu_torch.obs.report import run_reported_search as _reported_search
from waffle_con_tpu_torch.ops.scorer import (
    WavefrontScorer,
    fast_paths,
    make_scorer,
)
from waffle_con_tpu_torch.runtime.watchdog import enforce_dispatch_budget
from waffle_con_tpu_torch.utils.pqueue import PQueueTracker, SetPriorityQueue

logger = logging.getLogger(__name__)


class DualConsensus:
    """A dual (or degenerate single) consensus result.

    ``is_consensus1[i]`` says whether input read ``i`` is assigned to
    ``consensus1``; ``scores1``/``scores2`` hold the per-read costs against
    each consensus, ``None`` where tracking was pruned.  Equality ignores
    the score vectors.
    """

    __slots__ = ("consensus1", "consensus2", "is_consensus1", "scores1", "scores2")

    def __init__(
        self,
        consensus1: Consensus,
        consensus2: Optional[Consensus],
        is_consensus1: List[bool],
        scores1: List[Optional[int]],
        scores2: List[Optional[int]],
    ) -> None:
        if len(is_consensus1) != len(scores1) or len(is_consensus1) != len(scores2):
            raise EngineError(
                "is_consensus1, scores1, and scores2 must all be the same length"
            )
        self.consensus1 = consensus1
        self.consensus2 = consensus2
        self.is_consensus1 = is_consensus1
        self.scores1 = scores1
        self.scores2 = scores2

    def is_dual(self) -> bool:
        return self.consensus2 is not None

    def __eq__(self, rhs) -> bool:
        return (
            isinstance(rhs, DualConsensus)
            and self.consensus1 == rhs.consensus1
            and self.consensus2 == rhs.consensus2
            and self.is_consensus1 == rhs.is_consensus1
        )

    def __repr__(self) -> str:
        return (
            f"DualConsensus(consensus1={self.consensus1!r}, "
            f"consensus2={self.consensus2!r}, is_consensus1={self.is_consensus1})"
        )


def _extend_active_tables(
    cfg, activate_points, total_active_count, active_min_count, length
) -> None:
    """Grow the per-length active-read-count / dynamic-min-count tables by
    one entry when ``length`` is their current frontier.  The one copy of
    this arithmetic: the pop loop and the run-replay path must stay
    bit-identical for the fast path to match the per-symbol flow."""
    if len(active_min_count) == length + 1:
        new_total = total_active_count[length] + len(
            activate_points.get(length, [])
        )
        total_active_count.append(new_total)
        active_min_count.append(
            max(cfg.min_count, math.ceil(cfg.min_af * new_total))
        )


def build_dual_record(
    cost, n, fin1, fin2, act1, act2, cons1, cons2, is_dual
):
    """The one copy of the finalized-result arithmetic: per read the
    better finalized side (ties side 1), lexicographic swap, grouped +
    full score vectors.  Shared by ``_finalize`` (live scorer fins) and
    the run-record replay (kernel-buffered fins) so the two can never
    drift.  Returns ``(result, total, counts1, counts2)``; raises for a
    read inactive on every tracked side."""
    indices = []
    best_scores = []
    for r in range(n):
        s1 = cost.apply(int(fin1[r])) if act1[r] else None
        s2 = cost.apply(int(fin2[r])) if is_dual and act2[r] else None
        if s1 is None and s2 is None:
            raise EngineError(
                "Finalize called on DWFA that was never initialized."
            )
        if s1 is not None and (s2 is None or s1 <= s2):
            indices.append(0)
            best_scores.append(s1)
        else:
            indices.append(1)
            best_scores.append(s2)
    swap = is_dual and cons2 < cons1
    is_consensus1 = [(idx == 0) ^ swap for idx in indices]
    grouped: List[List[int]] = [[], []]
    for idx, score in zip(indices, best_scores):
        grouped[idx].append(score)
    c1 = Consensus(cons1, cost, grouped[0])
    c2 = Consensus(cons2, cost, grouped[1])
    full1 = [cost.apply(int(fin1[r])) if act1[r] else None for r in range(n)]
    full2 = [
        cost.apply(int(fin2[r])) if is_dual and act2[r] else None
        for r in range(n)
    ]
    if swap:
        result = DualConsensus(c2, c1, is_consensus1, full2, full1)
    else:
        result = DualConsensus(
            c1, c2 if is_dual else None, is_consensus1, full1, full2
        )
    counts1 = sum(is_consensus1)
    return result, sum(best_scores), counts1, n - counts1


class _DualNode:
    """Search node holding one (non-dual) or two consensus branches."""

    __slots__ = (
        "is_dual",
        "lock1",
        "lock2",
        "consensus1",
        "consensus2",
        "h1",
        "h2",
        "active1",
        "active2",
        "offsets1",
        "offsets2",
        "stats1",
        "stats2",
        "prefetch",
    )

    def __init__(self):
        self.is_dual = False
        self.lock1 = False
        self.lock2 = False
        self.consensus1 = b""
        self.consensus2 = b""
        self.h1 = None
        self.h2 = None
        self.active1: List[bool] = []
        self.active2: List[bool] = []
        self.offsets1: List[Optional[int]] = []
        self.offsets2: List[Optional[int]] = []
        self.stats1 = None
        self.stats2 = None
        #: expansion cache: ``(specs, children)`` built by a batched
        #: multi-node dispatch before this node was popped (pure cache —
        #: specs are a deterministic function of the stats)
        self.prefetch = None

    # -- identity ------------------------------------------------------
    def key(self) -> Tuple:
        return (
            self.is_dual,
            self.lock1,
            self.lock2,
            self.consensus1,
            self.consensus2,
            tuple(o if a else None for a, o in zip(self.active1, self.offsets1)),
            tuple(o if a else None for a, o in zip(self.active2, self.offsets2)),
        )

    def max_consensus_length(self) -> int:
        return max(len(self.consensus1), len(self.consensus2))

    # -- scoring -------------------------------------------------------
    def best_costs(self, cost: ConsensusCost) -> Tuple[List[int], List[int]]:
        """Per read, the best (index, score) over the tracked sides; ties
        go to side 0; untracked reads report index ``-1`` / score 0."""
        n = len(self.active1)
        indices = [-1] * n
        scores = [0] * n
        for r in range(n):
            best_score = None
            best_index = -1
            if self.active1[r]:
                best_score = cost.apply(int(self.stats1.eds[r]))
                best_index = 0
            if self.is_dual and self.active2[r]:
                s2 = cost.apply(int(self.stats2.eds[r]))
                if best_score is None or s2 < best_score:
                    best_score = s2
                    best_index = 1
            if best_score is not None:
                indices[r] = best_index
                scores[r] = best_score
        return indices, scores

    def total_cost(self, cost: ConsensusCost) -> int:
        _, scores = self.best_costs(cost)
        return sum(scores)

    def priority(self, cost: ConsensusCost) -> Tuple[int, int]:
        return (-self.total_cost(cost), self.max_consensus_length())

    # -- predicates ------------------------------------------------------
    def is_dual_imbalanced(self, min_count: int) -> bool:
        if not self.is_dual:
            return False
        return sum(self.active1) < min_count or sum(self.active2) < min_count

    def reached_all_end(self, require_all: bool) -> bool:
        flags = []
        for r in range(len(self.active1)):
            p1 = self.active1[r] and bool(self.stats1.reached[r])
            p2 = (
                self.is_dual
                and self.active2[r]
                and bool(self.stats2.reached[r])
            )
            flags.append(p1 or p2)
        return all(flags) if require_all else any(flags)

    def reached_consensus_end(self, side1: bool, require_all: bool) -> bool:
        if not side1 and not self.is_dual:
            return False
        active = self.active1 if side1 else self.active2
        stats = self.stats1 if side1 else self.stats2
        flags = [
            bool(stats.reached[r]) if active[r] else require_all
            for r in range(len(active))
        ]
        return all(flags) if require_all else any(flags)

    # -- votes -----------------------------------------------------------
    def ed_weights(self, side1: bool, weight_by_ed: bool) -> List[float]:
        """Per-read vote weights from the relative edit distances of the
        two tracked sides."""
        n = len(self.active1)
        if not self.is_dual:
            return [1.0] * n
        min_ed = 0.5
        equality_score = 0.5
        out = []
        for r in range(n):
            c1 = max(float(self.stats1.eds[r]), min_ed) if self.active1[r] else None
            c2 = max(float(self.stats2.eds[r]), min_ed) if self.active2[r] else None
            if c1 is not None and c2 is not None:
                if weight_by_ed:
                    numer = c2 if side1 else c1
                    out.append(numer / (c1 + c2))
                elif c1 == c2:
                    out.append(equality_score)
                elif (side1 and c1 < c2) or (not side1 and c2 < c1):
                    out.append(1.0)
                else:
                    out.append(0.0)
            elif (c1 is not None and side1) or (c2 is not None and not side1):
                out.append(1.0)
            else:
                out.append(0.0)
        return out

    def candidates(
        self, side1: bool, symtab, wildcard, weighted_by_ed: bool
    ) -> Dict[int, float]:
        active = self.active1 if side1 else self.active2
        stats = self.stats1 if side1 else self.stats2
        if weighted_by_ed:
            weights = self.ed_weights(side1, True)
        else:
            weights = [1.0] * len(active)
        # mask untracked reads: their stats rows may be stale
        weights = [w if a else 0.0 for w, a in zip(weights, active)]
        return candidates_from_stats(stats, symtab, wildcard, weights)


class DualConsensusDWFA:
    """Generates the best single- or dual-consensus for the added reads."""

    def __init__(
        self,
        config: Optional[CdwfaConfig] = None,
        scorer: Optional[WavefrontScorer] = None,
    ) -> None:
        self.config = config if config is not None else CdwfaConfig()
        self.sequences: List[bytes] = []
        self.offsets: List[Optional[int]] = []
        self.alphabet: set = set()
        #: optional injected scorer (the priority engine's SubsetScorer
        #: view of a scorer shared across worklist groups); its reads
        #: must equal the added sequences
        self._injected_scorer = scorer

    @classmethod
    def with_config(cls, config: CdwfaConfig) -> "DualConsensusDWFA":
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

    # ==================================================================

    def consensus(self) -> List[DualConsensus]:
        """Run the search; returns every tied-best result (sorted), or a
        single empty-consensus fallback when no candidate survives.
        Search-shape counters land in ``self.last_search_stats``, the
        structured :class:`~waffle_con_tpu_torch.obs.report.SearchReport`
        in ``self.last_search_report``."""
        return _reported_search(self, "dual", self._consensus_impl)

    def _consensus_impl(self) -> List[DualConsensus]:
        cfg = self.config
        cost = cfg.consensus_cost
        restore = getattr(self, "_restore_state", None)
        self._restore_state = None
        n_seqs = len(self.sequences)
        maximum_error = math.inf
        farthest_single = 0
        farthest_dual = 0
        single_last_constraint = 0
        dual_last_constraint = 0
        nodes_explored = 0
        nodes_ignored = 0
        peak_queue_size = 0

        offsets = shift_offsets(self.offsets, cfg.auto_shift_offsets)
        logger.debug("Offsets: %s", offsets)

        activate_points: Dict[int, List[int]] = {}
        initially_active = 0
        for seq_index, offset in enumerate(offsets):
            if offset is not None:
                activate_length = offset + cfg.offset_compare_length
                activate_points.setdefault(activate_length, []).append(seq_index)
            else:
                initially_active += 1
        if initially_active == 0:
            raise EngineError(
                "Must have at least one initial offset of None to see the consensus."
            )

        if self._injected_scorer is not None:
            scorer = self._injected_scorer
            check_invariant(
                scorer.reads == self.sequences,
                "injected scorer reads match added sequences",
            )
        else:
            scorer = make_scorer(self.sequences, cfg)
        # a shared (injected) scorer carries cumulative counters across
        # searches: report this search's delta, not the running total
        counters_before = dict(scorer.counters)
        initial_size = max(len(s) for s in self.sequences)
        single_tracker = PQueueTracker(initial_size, cfg.max_capacity_per_size)
        dual_tracker = PQueueTracker(initial_size, cfg.max_capacity_per_size)
        pqueue = SetPriorityQueue()

        if restore is None:
            root = _DualNode()
            root.active1 = [o is None for o in offsets]
            root.active2 = [False] * n_seqs
            root.offsets1 = [0 if a else None for a in root.active1]
            root.offsets2 = [None] * n_seqs
            root.h1 = scorer.root(np.array(root.active1, dtype=bool))
            root.stats1 = scorer.stats(root.h1, b"")
            single_tracker.insert(root.max_consensus_length())
            pqueue.push(root.key(), root, root.priority(cost))

        results: List[DualConsensus] = []

        # dynamic minimum counts driven by how many reads are active
        full_min_count = max(
            cfg.min_count, math.ceil(cfg.min_af * n_seqs)
        )
        total_active_count = [initially_active]
        active_min_count = [
            max(cfg.min_count, math.ceil(cfg.min_af * initially_active))
        ]
        # device-table forms of the dynamic-min-count arithmetic: the
        # activation schedule is known up front, so the whole per-length
        # active_min_count table is precomputable in exact host integer
        # arithmetic and uploaded to the run kernel — min_af != 0 keeps
        # the device fast path
        mc_tab = np.array(
            [
                max(cfg.min_count, math.ceil(cfg.min_af * n))
                for n in range(n_seqs + 1)
            ],
            dtype=np.int32,
        )
        last_act = max(activate_points, default=0)
        imb_tab = np.empty(last_act + 2, dtype=np.int32)
        _tot = initially_active
        imb_tab[0] = max(cfg.min_count, math.ceil(cfg.min_af * _tot))
        for _L in range(last_act + 1):
            _tot += len(activate_points.get(_L, []))
            imb_tab[_L + 1] = max(
                cfg.min_count, math.ceil(cfg.min_af * _tot)
            )

        pops = 0
        if restore is not None:
            (maximum_error, farthest_single, farthest_dual,
             single_last_constraint, dual_last_constraint,
             nodes_explored, nodes_ignored, peak_queue_size, pops,
             results, total_active_count, active_min_count) = (
                self._restore_search(
                    restore, scorer, pqueue, single_tracker, dual_tracker,
                    cost, total_active_count, active_min_count,
                )
            )
        fp = fast_paths(scorer)
        frontier = FrontierSampler("dual")
        speculator = FrontierSpeculator(scorer, cfg)
        #: decision audit sink (``None`` when no capture is installed —
        #: the zero-overhead decision, made once per search)
        audit = obs_audit.search_sink("dual")

        ctrl = ckpt_mod.current_controller()

        def _ckpt_body() -> Dict:
            # a closure over the loop locals: reads their values at
            # snapshot time, always at the top-of-pop-loop boundary
            return self._checkpoint_body(
                pqueue, single_tracker, dual_tracker,
                maximum_error=maximum_error,
                farthest_single=farthest_single,
                farthest_dual=farthest_dual,
                single_last_constraint=single_last_constraint,
                dual_last_constraint=dual_last_constraint,
                nodes_explored=nodes_explored,
                nodes_ignored=nodes_ignored,
                peak_queue_size=peak_queue_size,
                pops=pops,
                results=results,
                total_active_count=total_active_count,
                active_min_count=active_min_count,
            )

        while not pqueue.is_empty():
            if ctrl is not None:
                try:
                    ctrl.poll(pops, _ckpt_body)
                finally:
                    self._last_checkpoint = ctrl.last_checkpoint
            peak_queue_size = max(peak_queue_size, len(pqueue))
            while (
                len(single_tracker) > cfg.max_queue_size
                or single_last_constraint >= cfg.max_nodes_wo_constraint
            ) and single_tracker.threshold() < farthest_single:
                single_tracker.increment_threshold()
                single_last_constraint = 0
            while (
                len(dual_tracker) > cfg.max_queue_size
                or dual_last_constraint >= cfg.max_nodes_wo_constraint
            ) and dual_tracker.threshold() < farthest_dual:
                dual_tracker.increment_threshold()
                dual_last_constraint = 0

            node, priority = pqueue.pop()
            pops += 1
            if pops % PROGRESS_LOG_INTERVAL == 0:
                logger.debug(
                    "search progress: %d pops, queue=%d, farthest=%d/%d, "
                    "best_cost=%d", pops, len(pqueue), farthest_single,
                    farthest_dual, -priority[0],
                )
                if obs_metrics.metrics_enabled():
                    obs_metrics.registry().gauge(
                        "waffle_search_queue_depth", engine="dual"
                    ).set(len(pqueue))
            next_prio = pqueue.peek_priority()
            # the gang width of this pop (pure policy, byte-safe): see the
            # single engine
            gang_w = speculator.width(
                len(pqueue),
                (-next_prio[0]) - (-priority[0])
                if next_prio is not None else None,
            )
            if frontier.due(pops):
                frontier.sample(
                    pops, len(pqueue),
                    len(single_tracker) + len(dual_tracker),
                    -priority[0],
                    -next_prio[0] if next_prio is not None else None,
                    node.max_consensus_length(),
                    max(farthest_single, farthest_dual),
                    counters=scorer.counters, gang_width=gang_w,
                )
            top_cost = -priority[0]
            top_len = node.max_consensus_length()

            if node.is_dual:
                dual_tracker.remove(top_len)
                threshold_cutoff = dual_tracker.threshold()
                at_capacity = dual_tracker.at_capacity(top_len)
            else:
                single_tracker.remove(top_len)
                threshold_cutoff = single_tracker.threshold()
                at_capacity = single_tracker.at_capacity(top_len)

            if audit is not None:
                # node identity digests: host bytes/flags the engine
                # already holds (nothing is read from the device)
                a_cls = "d" if node.is_dual else "p"
                a_l1 = len(node.consensus1)
                a_l2 = len(node.consensus2) if node.is_dual else None
                a_d1 = obs_audit.crc_bytes(node.consensus1)
                a_d2 = (
                    obs_audit.crc_bytes(node.consensus2)
                    if node.is_dual else None
                )
                _acts = [[i for i, a in enumerate(node.active1) if a]]
                if node.is_dual:
                    _acts.append(
                        [i for i, a in enumerate(node.active2) if a]
                    )
                a_act = obs_audit.active_digest(*_acts)

            check_invariant(top_len < len(active_min_count), "active_min_count covers popped length")
            if (
                top_cost > maximum_error
                or top_len < threshold_cutoff
                or at_capacity
                or node.is_dual_imbalanced(active_min_count[top_len])
            ):
                nodes_ignored += 1
                if audit is not None:
                    audit.emit({
                        "kind": "ignored", "pop": pops, "cls": a_cls,
                        "l1": a_l1, "l2": a_l2, "d1": a_d1, "d2": a_d2,
                        "act": a_act, "prio": top_cost,
                    })
                self._free_node(scorer, node)
                continue

            # -- device fast path: extend the popped node through
            # unambiguous stretches on device (dual nodes step BOTH
            # branches per iteration with on-device divergence pruning).
            # Engages only when this pop's own child spec is the single
            # both-sides-extend (or single-symbol) case, while the node
            # keeps winning pops, with max_steps bounded by the exact
            # tracker simulation.  min_af != 0 rides the precomputed
            # mc/imb device tables; weighted_by_ed with min_af != 0 makes
            # vote totals fractional (the table index would be
            # meaningless), so only that combination takes the per-symbol
            # flow.
            farthest_kind = farthest_dual if node.is_dual else farthest_single
            kind_tracker = dual_tracker if node.is_dual else single_tracker
            #: one-side-locked dual runs engage only while the unlocked
            #: side is at least as long as the locked one — the node's
            #: max length then advances one per committed step, so the
            #: tracker replay / run-bound simulation stay valid (in the
            #: opposite regime the per-symbol flow handles it)
            lockable = (
                not (node.lock1 and node.lock2)
                and (
                    not node.lock1
                    or len(node.consensus2) >= len(node.consensus1)
                )
                and (
                    not node.lock2
                    or len(node.consensus1) >= len(node.consensus2)
                )
            )
            kernels_ok = (
                cfg.min_af == 0.0 or not cfg.weighted_by_ed
            ) and (
                (
                    node.is_dual
                    and lockable
                    and fp.run_extend_dual is not None
                )
                or (
                    not node.is_dual
                    and fp.run_extend is not None
                )
            )
            runnable = False
            arena_shape = False
            cre_cap = fp.arena_cre_per_event
            if kernels_ok:
                specs_now = (
                    node.prefetch[0]
                    if node.prefetch is not None
                    else self._build_specs(scorer, node)
                )
                if node.is_dual:
                    # the single-child spec: both sides extend, or the
                    # locked side contributes its forced None
                    runnable = (
                        len(specs_now) == 1
                        and specs_now[0][0] == "dual"
                        and (specs_now[0][1] is not None or node.lock1)
                        and (specs_now[0][2] is not None or node.lock2)
                        and (specs_now[0][1] is not None or specs_now[0][2] is not None)
                    )
                    # split-shaped: an all-extend cross product the arena
                    # can absorb as children created on the device
                    arena_shape = runnable or (
                        2 <= len(specs_now) <= cre_cap
                        and all(
                            kind == "dual" and a is not None and b is not None
                            for kind, a, b in specs_now
                        )
                        and self._kernel_exact(scorer, node)
                    )
                else:
                    runnable = len(specs_now) == 1 and specs_now[0][0] == "single"
                    arena_shape = runnable or (
                        2 <= len(specs_now) <= cre_cap
                        and self._kernel_exact(scorer, node)
                    )
            # -- arena fast path: resolve the pop competition between this
            # node and the next-best queue entries on the device (most
            # plain-run stops are "would lose the next pop"); split-shaped
            # expansions engage too, the arena absorbing clean splits as
            # children and stopping for host arbitration otherwise.  Falls
            # back to the single-node run below when not engaged.  The
            # arena absorbs no records, so reached nodes skip it.
            if (
                arena_shape
                and not node.reached_all_end(cfg.allow_early_termination)
                and not (node.is_dual and (node.lock1 or node.lock2))
                and fp.run_arena is not None
                # under the lockstep shadow the arena's opaque subtree
                # absorption would hide per-pop decisions from the
                # comparator; strict alignment skips it (the arena is a
                # pure fast path)
                and not (audit is not None and audit.strict_align)
                # a pending gang deposit is this pop's run already paid
                # for; the arena would drop it unspent
                and not speculator.pending(node.h1)
            ):
                arena = self._arena_attempt(
                    scorer, pqueue, node, maximum_error, activate_points,
                    cost, single_tracker, dual_tracker, farthest_single,
                    farthest_dual, single_last_constraint,
                    dual_last_constraint, total_active_count,
                    active_min_count, mc_tab, imb_tab,
                )
                if arena is not None:
                    (farthest_single, farthest_dual, single_last_constraint,
                     dual_last_constraint, arena_explored,
                     arena_ignored) = arena
                    nodes_explored += arena_explored
                    nodes_ignored += arena_ignored
                    if audit is not None:
                        audit.emit({
                            "kind": "arena", "pop": pops, "cls": a_cls,
                            "l1": a_l1, "l2": a_l2, "d1": a_d1,
                            "d2": a_d2, "act": a_act, "prio": top_cost,
                            "explored": arena_explored,
                            "ignored": arena_ignored,
                        })
                    continue
            if runnable:
                best_other = pqueue.peek_priority()
                other_cost = 2**31 - 1
                other_len = 0
                if best_other is not None:
                    other_cost = -best_other[0]
                    other_len = best_other[1]
                if top_cost < other_cost or (
                    top_cost == other_cost and top_len > other_len
                ):
                    next_act = min(
                        (l for l in activate_points if l > top_len), default=None
                    )
                    max_steps = min(initial_size * 2 + 256, RUN_SIM_CAP)
                    if next_act is not None:
                        max_steps = min(max_steps, next_act - top_len - 1)
                    if max_steps >= 1:
                        max_steps = kind_tracker.simulate_run_bound(
                            top_len,
                            farthest_kind,
                            dual_last_constraint
                            if node.is_dual
                            else single_last_constraint,
                            cfg.max_queue_size,
                            cfg.max_nodes_wo_constraint,
                            max_steps,
                        )
                    # a shape the kernel's planner refuses takes the host
                    # path below, the same exact search
                    if max_steps >= 1 and (
                        fp.run_dual_takes() if node.is_dual
                        else fp.run_takes()
                    ):
                        me_budget = (
                            int(maximum_error)
                            if maximum_error != math.inf
                            else 2**31 - 1
                        )
                        l2 = cost is ConsensusCost.L2_DISTANCE
                        # records are only valid under early termination
                        # when every read is already active on some
                        # tracked side
                        allow_recs = not cfg.allow_early_termination or all(
                            a1 or (node.is_dual and a2)
                            for a1, a2 in zip(node.active1, node.active2)
                        )
                        if node.is_dual:
                            (
                                steps,
                                _code,
                                app1,
                                app2,
                                stats1,
                                stats2,
                                act1,
                                act2,
                                dual_records,
                            ) = fp.run_extend_dual(
                                node.h1,
                                node.h2,
                                node.consensus1,
                                node.consensus2,
                                me_budget,
                                other_cost,
                                other_len,
                                cfg.min_count,
                                cfg.dual_max_ed_delta,
                                active_min_count[top_len],
                                l2,
                                cfg.weighted_by_ed,
                                max_steps,
                                lock1=node.lock1,
                                lock2=node.lock2,
                                allow_records=allow_recs,
                                rec_min=full_min_count,
                                mc_tab=mc_tab,
                                imb_tab=imb_tab,
                                mc_dyn=(cfg.min_af != 0.0),
                            )
                            # replay absorbed reached-state records in
                            # commit order — the exact _finalize +
                            # completion-path arithmetic, fed from the
                            # kernel's buffered snapshots
                            for rec_j, rf1, rf2, ra1, ra2 in dual_records:
                                try:
                                    (rec_result, rec_total, counts1,
                                     counts2) = build_dual_record(
                                        cost, n_seqs, rf1, rf2, ra1, ra2,
                                        node.consensus1 + app1[:rec_j],
                                        node.consensus2 + app2[:rec_j],
                                        True,
                                    )
                                except EngineError:
                                    self._free_node(scorer, node)
                                    raise
                                if (
                                    counts1 >= full_min_count
                                    and counts2 >= full_min_count
                                ):
                                    maximum_error = accept_record(
                                        maximum_error, results, rec_total,
                                        rec_result, cfg.max_return_size,
                                    )
                        else:
                            # frontier-parallel speculation over the
                            # non-dual branches of the frontier (dual
                            # nodes need the paired kernel, so only
                            # single-side members gang)
                            if gang_w > 1:
                                self._gang_attempt(
                                    speculator, scorer, pqueue, node,
                                    gang_w, me_budget, other_cost,
                                    other_len, max_steps, maximum_error,
                                    l2,
                                )
                            (steps, _code, app1, stats1,
                             run_records) = fp.run_extend(
                                node.h1,
                                node.consensus1,
                                me_budget,
                                other_cost,
                                other_len,
                                cfg.min_count,
                                l2,
                                max_steps,
                                allow_records=allow_recs,
                            )
                            # replay absorbed reached-state records (the
                            # non-dual form of the completion path: no
                            # imbalance check, side 2 empty)
                            for rec_j, rec_fin in run_records:
                                try:
                                    (rec_result, rec_total, _c1,
                                     _c2) = build_dual_record(
                                        cost, n_seqs, rec_fin,
                                        np.zeros(n_seqs, dtype=np.int64),
                                        node.active1, node.active2,
                                        node.consensus1 + app1[:rec_j],
                                        node.consensus2, False,
                                    )
                                except EngineError:
                                    self._free_node(scorer, node)
                                    raise
                                maximum_error = accept_record(
                                    maximum_error, results, rec_total,
                                    rec_result, cfg.max_return_size,
                                )
                        if audit is not None and steps > 0:
                            audit.emit({
                                "kind": "run", "pop": pops, "cls": a_cls,
                                "l1": a_l1, "l2": a_l2, "d1": a_d1,
                                "d2": a_d2, "act": a_act,
                                "prio": top_cost, "code": int(_code),
                                "s1": obs_audit.b64(app1),
                                "s2": (
                                    obs_audit.b64(app2)
                                    if node.is_dual else None
                                ),
                                "tail": obs_audit.tail(
                                    node.consensus1 + app1
                                ),
                            })
                        if steps > 0:
                            # the branches advanced past the prefetched children
                            self._drop_prefetch(scorer, node)

                            def extend_tables(length):
                                _extend_active_tables(
                                    cfg,
                                    activate_points,
                                    total_active_count,
                                    active_min_count,
                                    length,
                                )

                            kind_constraint = (
                                dual_last_constraint
                                if node.is_dual
                                else single_last_constraint
                            )
                            farthest_kind, kind_constraint = (
                                replay_run_bookkeeping(
                                    kind_tracker,
                                    cfg,
                                    top_len,
                                    steps,
                                    farthest_kind,
                                    kind_constraint,
                                    on_length=extend_tables,
                                )
                            )
                            nodes_explored += steps
                            if node.is_dual:
                                farthest_dual = farthest_kind
                                dual_last_constraint = kind_constraint
                            else:
                                farthest_single = farthest_kind
                                single_last_constraint = kind_constraint
                            node.consensus1 = node.consensus1 + app1
                            node.stats1 = stats1
                            if node.is_dual:
                                node.consensus2 = node.consensus2 + app2
                                node.stats2 = stats2
                                for r in range(n_seqs):
                                    if node.active1[r] and not bool(act1[r]):
                                        node.active1[r] = False
                                        node.offsets1[r] = None
                                    if node.active2[r] and not bool(act2[r]):
                                        node.active2[r] = False
                                        node.offsets2[r] = None
                            if not pqueue.push(
                                node.key(), node, node.priority(cost)
                            ):  # pragma: no cover - chain nodes are unique
                                kind_tracker.remove(node.max_consensus_length())
                                self._free_node(scorer, node)
                            continue

            if node.is_dual:
                farthest_dual = max(farthest_dual, top_len)
                dual_last_constraint += 1
                dual_tracker.process(top_len)
            else:
                farthest_single = max(farthest_single, top_len)
                single_last_constraint += 1
                single_tracker.process(top_len)
            nodes_explored += 1

            # -- completion check -------------------------------------
            if node.reached_all_end(cfg.allow_early_termination):
                fin_result, fin_total = self._finalize(scorer, node)
                imbalanced = False
                if node.is_dual:
                    counts1 = sum(fin_result.is_consensus1)
                    counts2 = len(fin_result.is_consensus1) - counts1
                    # note is_consensus1 already reflects any swap; the
                    # imbalance test is symmetric so that is irrelevant
                    imbalanced = (
                        counts1 < full_min_count or counts2 < full_min_count
                    )
                if not imbalanced:
                    maximum_error = accept_record(
                        maximum_error, results, fin_total, fin_result,
                        cfg.max_return_size,
                    )
                else:
                    logger.debug("Finalized node is imbalanced, ignoring.")
                if audit is not None:
                    audit.emit({
                        "kind": "final", "pop": pops, "cls": a_cls,
                        "l1": a_l1, "l2": a_l2, "d1": a_d1, "d2": a_d2,
                        "act": a_act, "score": int(fin_total),
                        "imbalanced": imbalanced,
                    })

            # -- maintain the dynamic active-count tables -------------
            _extend_active_tables(
                cfg, activate_points, total_active_count, active_min_count,
                top_len,
            )

            # -- extension ---------------------------------------------
            self._expand(
                scorer,
                node,
                activate_points,
                pqueue,
                single_tracker,
                dual_tracker,
                cost,
                audit=audit,
                audit_ctx=(
                    {
                        "kind": "branch", "pop": pops, "cls": a_cls,
                        "l1": a_l1, "l2": a_l2, "d1": a_d1, "d2": a_d2,
                        "act": a_act, "prio": top_cost,
                        "tail": obs_audit.tail(node.consensus1),
                    }
                    if audit is not None
                    else None
                ),
            )
            self._free_node(scorer, node)

            check_invariant(
                len(pqueue)
                == single_tracker.unfiltered_len() + dual_tracker.unfiltered_len(),
                "queue and trackers in sync",
            )

        check_invariant(len(single_tracker) == 0, "single tracker drained")
        check_invariant(len(dual_tracker) == 0, "dual tracker drained")

        if len(results) > 1:
            results.sort(
                key=lambda dc: (
                    dc.consensus1.sequence,
                    dc.consensus2.sequence if dc.consensus2 is not None else b"",
                )
            )

        if not results:
            logger.warning(
                "No consensus found that reached end, is there a gap between "
                "input sequences?"
            )
            results.append(
                DualConsensus(
                    Consensus(b"", cost, [0] * n_seqs),
                    None,
                    [True] * n_seqs,
                    [0] * n_seqs,
                    [None] * n_seqs,
                )
            )

        self.last_search_stats = {
            "nodes_explored": nodes_explored,
            "nodes_ignored": nodes_ignored,
            "peak_queue_size": peak_queue_size,
            "scorer_counters": {
                k: v - counters_before.get(k, 0)
                for k, v in scorer.counters.items()
            },
            "backend": getattr(scorer, "backend", None) or cfg.backend,
        }
        enforce_dispatch_budget(
            cfg, self.last_search_stats["scorer_counters"], "dual"
        )
        return results

    # ==================================================================
    # checkpoint / resume

    def snapshot(self) -> Optional["ckpt_mod.SearchCheckpoint"]:
        """The most recent :class:`SearchCheckpoint` built for this
        engine's search (by the installed
        :class:`~waffle_con_tpu_torch.models.checkpoint.CheckpointController`),
        or ``None`` — survives a preempted/expired search."""
        return getattr(self, "_last_checkpoint", None)

    @staticmethod
    def _encode_dual_result(d: DualConsensus) -> Dict:
        def enc(c):
            return None if c is None else {
                "sequence": ckpt_mod.b64(c.sequence),
                "scores": [int(s) for s in c.scores],
            }

        return {
            "consensus1": enc(d.consensus1),
            "consensus2": enc(d.consensus2),
            "is_consensus1": [1 if b else 0 for b in d.is_consensus1],
            "scores1": [None if s is None else int(s) for s in d.scores1],
            "scores2": [None if s is None else int(s) for s in d.scores2],
        }

    @staticmethod
    def _decode_dual_result(obj: Dict, cost: ConsensusCost) -> DualConsensus:
        def dec(c):
            return None if c is None else Consensus(
                ckpt_mod.unb64(c["sequence"]), cost,
                [int(s) for s in c["scores"]],
            )

        return DualConsensus(
            dec(obj["consensus1"]),
            dec(obj["consensus2"]),
            [bool(b) for b in obj["is_consensus1"]],
            [None if s is None else int(s) for s in obj["scores1"]],
            [None if s is None else int(s) for s in obj["scores2"]],
        )

    def _checkpoint_body(
        self, pqueue, single_tracker, dual_tracker, *, maximum_error,
        farthest_single, farthest_dual, single_last_constraint,
        dual_last_constraint, nodes_explored, nodes_ignored,
        peak_queue_size, pops, results, total_active_count,
        active_min_count,
    ) -> Dict:
        """JSON checkpoint body at a pop boundary (single-engine twin:
        :meth:`ConsensusDWFA._checkpoint_body`).  Node identity is the
        host-level tuple per side — consensus bytes, active sets,
        offsets, split locks; wavefronts rebuild through the dispatch
        seam on resume.  The ``mc_tab``/``imb_tab`` device tables are
        pure functions of config + activation schedule and are never
        serialized."""
        entries = []
        for _key, nd, pri, seq in pqueue.export_entries():
            entries.append({
                "is_dual": 1 if nd.is_dual else 0,
                "lock1": 1 if nd.lock1 else 0,
                "lock2": 1 if nd.lock2 else 0,
                "consensus1": ckpt_mod.b64(nd.consensus1),
                "consensus2": ckpt_mod.b64(nd.consensus2),
                "active1": [1 if a else 0 for a in nd.active1],
                "active2": [1 if a else 0 for a in nd.active2],
                "offsets1": [o if o is None else int(o)
                             for o in nd.offsets1],
                "offsets2": [o if o is None else int(o)
                             for o in nd.offsets2],
                "priority": [int(p) for p in pri],
                "seq": int(seq),
            })
        return {
            "kind": "dual",
            "config": ckpt_mod.encode_config_dict(self.config),
            "reads": [ckpt_mod.b64(s) for s in self.sequences],
            "offsets": [o if o is None else int(o) for o in self.offsets],
            "state": {
                "entries": entries,
                "queue_seq": pqueue.export_seq(),
                "single_tracker": single_tracker.export_state(),
                "dual_tracker": dual_tracker.export_state(),
                "maximum_error": (None if maximum_error == math.inf
                                  else int(maximum_error)),
                "farthest_single": int(farthest_single),
                "farthest_dual": int(farthest_dual),
                "single_last_constraint": int(single_last_constraint),
                "dual_last_constraint": int(dual_last_constraint),
                "nodes_explored": int(nodes_explored),
                "nodes_ignored": int(nodes_ignored),
                "peak_queue_size": int(peak_queue_size),
                "pops": int(pops),
                "total_active_count": [int(n) for n in total_active_count],
                "active_min_count": [int(n) for n in active_min_count],
                "results": [self._encode_dual_result(d) for d in results],
            },
        }

    def _restore_search(
        self, restore, scorer, pqueue, single_tracker, dual_tracker,
        cost, total_active_count, active_min_count,
    ):
        """Rebuild the mid-search state captured by
        :meth:`_checkpoint_body`; returns the loop-local tuple.  Each
        side of each node rebuilds through the scorer seam — fresh
        root, the side's consensus replayed through ``push_many`` (see
        :func:`~waffle_con_tpu_torch.models.consensus._replay_consensus`:
        the branch store needs its consensus buffer filled before
        ``activate`` can catch a wavefront up), then one activate per
        tracked read — bit-identical on any backend; stored priorities
        double as the integrity check."""
        st = restore["state"]
        extra = int(restore.get("extra", 0))
        n_total = len(self.sequences)
        n_base = n_total - extra
        try:
            if not extra:
                single_tracker.restore_state(st["single_tracker"])
                dual_tracker.restore_state(st["dual_tracker"])
                total_active_count = [
                    int(n) for n in st["total_active_count"]
                ]
                active_min_count = [
                    int(n) for n in st["active_min_count"]
                ]
            results = [
                self._decode_dual_result(r, cost) for r in st["results"]
            ]
            maximum_error = (math.inf if st["maximum_error"] is None
                             else int(st["maximum_error"]))
            staged = []
            replay_specs = []
            for entry in st["entries"]:
                node = _DualNode()
                node.is_dual = bool(entry["is_dual"])
                node.lock1 = bool(entry["lock1"])
                node.lock2 = bool(entry["lock2"])
                node.consensus1 = ckpt_mod.unb64(entry["consensus1"])
                node.consensus2 = ckpt_mod.unb64(entry["consensus2"])
                node.active1 = [bool(a) for a in entry["active1"]]
                node.active2 = [bool(a) for a in entry["active2"]]
                node.offsets1 = [o if o is None else int(o)
                                 for o in entry["offsets1"]]
                node.offsets2 = [o if o is None else int(o)
                                 for o in entry["offsets2"]]
                if (len(node.active1) != n_base
                        or len(node.active2) != n_base
                        or len(node.offsets1) != n_base
                        or len(node.offsets2) != n_base):
                    raise ckpt_mod.CheckpointRejected(
                        "node read-count mismatch vs checkpoint reads"
                    )
                # incremental reads join side 1 at offset 0 (pop-0 only)
                node.active1 += [True] * extra
                node.active2 += [False] * extra
                node.offsets1 += [0] * extra
                node.offsets2 += [None] * extra
                node.h1 = scorer.root(np.zeros(n_total, dtype=bool))
                replay_specs.append((node.h1, node.consensus1))
                if node.is_dual:
                    node.h2 = scorer.root(np.zeros(n_total, dtype=bool))
                    replay_specs.append((node.h2, node.consensus2))
                staged.append((entry, node))
            _replay_consensus(scorer, replay_specs)
            for entry, node in staged:
                for r, is_active in enumerate(node.active1):
                    if is_active:
                        scorer.activate(
                            node.h1, r, node.offsets1[r], node.consensus1
                        )
                node.stats1 = scorer.stats(node.h1, node.consensus1)
                if node.is_dual:
                    for r, is_active in enumerate(node.active2):
                        if is_active:
                            scorer.activate(
                                node.h2, r, node.offsets2[r],
                                node.consensus2,
                            )
                    node.stats2 = scorer.stats(node.h2, node.consensus2)
                prio = node.priority(cost)
                if not extra and tuple(int(p) for p in prio) != tuple(
                    int(p) for p in entry["priority"]
                ):
                    raise ckpt_mod.CheckpointRejected(
                        "restored node priority mismatch — checkpoint "
                        "does not match its reads/config"
                    )
                if extra:
                    tracker = (dual_tracker if node.is_dual
                               else single_tracker)
                    tracker.insert(node.max_consensus_length())
                pqueue.push_restored(
                    node.key(), node, prio, int(entry["seq"])
                )
            pqueue.restore_seq(int(st["queue_seq"]))
            if extra:
                # the wider read set invalidates accepted results and
                # the cost bound; the search re-derives both
                results = []
                maximum_error = math.inf
            return (
                maximum_error,
                int(st["farthest_single"]),
                int(st["farthest_dual"]),
                int(st["single_last_constraint"]),
                int(st["dual_last_constraint"]),
                int(st["nodes_explored"]),
                int(st["nodes_ignored"]),
                int(st["peak_queue_size"]),
                int(st["pops"]),
                results,
                total_active_count,
                active_min_count,
            )
        except ckpt_mod.CheckpointError:
            raise
        except (KeyError, TypeError, ValueError, IndexError) as exc:
            raise ckpt_mod.CheckpointRejected(
                f"malformed dual-engine checkpoint state: {exc}"
            ) from None

    @classmethod
    def resume(
        cls, checkpoint, extra_reads=()
    ) -> "DualConsensusDWFA":
        """An engine primed to continue ``checkpoint`` (a
        :class:`SearchCheckpoint` or its wire-dict form); run
        :meth:`consensus` on it to finish the search byte-identically.
        ``extra_reads`` are only accepted on a pop-0 checkpoint (before
        any split decisions the new reads never voted on)."""
        body = ckpt_mod.resume_body(checkpoint, "dual")
        try:
            config = ckpt_mod.decode_config_dict(body["config"])
            reads = [ckpt_mod.unb64(r) for r in body["reads"]]
            offsets = [o if o is None else int(o)
                       for o in body["offsets"]]
            state = body["state"]
            if not isinstance(state, dict) or len(reads) != len(offsets):
                raise ckpt_mod.CheckpointRejected(
                    "malformed dual-engine checkpoint body"
                )
        except ckpt_mod.CheckpointError:
            raise
        except (KeyError, TypeError, ValueError) as exc:
            raise ckpt_mod.CheckpointRejected(
                f"malformed dual-engine checkpoint body: {exc}"
            ) from None
        extras = [bytes(r) for r in extra_reads]
        if extras and int(state.get("pops", -1)) != 0:
            raise ckpt_mod.CheckpointRejected(
                "extra_reads require a pop-0 dual checkpoint (later "
                "snapshots hold split decisions the new reads never "
                "voted on)"
            )
        engine = cls(config)
        for read, offset in zip(reads, offsets):
            engine.add_sequence_offset(read, offset)
        for read in extras:
            engine.add_sequence(read)
        engine._restore_state = {"state": state, "extra": len(extras)}
        return engine

    # ==================================================================
    # arena fast path

    def _arena_attempt(
        self, scorer, pqueue, node, maximum_error, activate_points, cost,
        single_tracker, dual_tracker, farthest_single, farthest_dual,
        single_last_constraint, dual_last_constraint, total_active_count,
        active_min_count, mc_tab, imb_tab,
    ):
        """Engage the device pop arena for the in-hand node plus up to
        ``ARENA_TAKE_MAX`` of the next-best queue entries.  Returns
        ``None`` when not engaged (no competitor, an activation point next,
        or nothing committed: every popped competitor is restored with its
        original insertion order), else applies the nodes' extensions,
        materialises the children the device created at vote splits
        (``create_mode=2``: singles, split pairs, dual cross products),
        replays the exact per-pop tracker bookkeeping, re-queues the
        survivors and returns ``(farthest_single, farthest_dual,
        single_last_constraint, dual_last_constraint, explored,
        ignored)``."""
        cfg = self.config
        if pqueue.is_empty():
            return None  # no competitor: the plain run path is better

        # the next-best competitors in pop order; the first locked one
        # becomes the rest-of-queue bound
        fp = fast_paths(scorer)
        taken = []
        while len(taken) < fp.arena_take_max and not pqueue.is_empty():
            cand, pri, seq = pqueue.pop_with_seq()
            if cand.is_dual and (cand.lock1 or cand.lock2):
                pqueue.push_restored(cand.key(), cand, pri, seq)
                break
            taken.append((cand, pri, seq))
        if not taken:
            return None

        def restore_all():
            for cand, pri, seq in taken:
                pqueue.push_restored(cand.key(), cand, pri, seq)

        nodes = [node] + [t[0] for t in taken]
        step_limit = fp.arena_cap
        for nd in nodes:
            nl = nd.max_consensus_length()
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
            max(nd.max_consensus_length() for nd in nodes),
            farthest_single,
            farthest_dual,
        ) + fp.arena_cap + 4
        win_len = 1 << (needed - 1).bit_length()
        lc_s, pc_s = single_tracker.export_windows(win_len)
        lc_d, pc_d = dual_tracker.export_windows(win_len)
        tr_scalars = [
            [single_tracker.threshold(), len(single_tracker),
             farthest_single, single_last_constraint],
            [dual_tracker.threshold(), len(dual_tracker), farthest_dual,
             dual_last_constraint],
        ]
        if not fp.arena_takes(win_len):
            restore_all()
            return None  # the arena kernel's planner refuses the shape
        me_budget = (
            int(maximum_error) if maximum_error != math.inf else 2**31 - 1
        )
        (events, nsteps, _code, _stop_node, node_steps, appended,
         sides_stats, sides_act, alive, creations) = fp.run_arena(
            [
                (nd.h1, nd.h2 if nd.is_dual else None, len(nd.consensus1),
                 len(nd.consensus2))
                for nd in nodes
            ],
            me_budget,
            cfg.min_count,
            cfg.dual_max_ed_delta,
            cfg.min_count,  # imb_min fallback (imb_tab is the truth)
            cost is ConsensusCost.L2_DISTANCE,
            cfg.weighted_by_ed,
            rest_cost,
            rest_len,
            cfg.max_queue_size,
            cfg.max_capacity_per_size,
            step_limit,
            cfg.max_nodes_wo_constraint,
            np.stack([lc_s, lc_d]),
            np.stack([pc_s, pc_d]),
            np.asarray(tr_scalars, dtype=np.int32),
            create_mode=2,
            mc_tab=mc_tab,
            imb_tab=imb_tab,
            split_relax=(cfg.min_af == 0.0),
            mc_dyn=(cfg.min_af != 0.0),
        )
        if nsteps == 0:
            restore_all()
            return None

        n_live = len(nodes)
        for i, nd in enumerate(nodes):
            if node_steps[i] > 0 or not alive[i]:
                self._drop_prefetch(scorer, nd)
        # exact tracker replay of the committed pop sequence (lens/kinds
        # grow as the children created on the device are registered)
        kinds = [1 if nd.is_dual else 0 for nd in nodes]
        lens = [nd.max_consensus_length() for nd in nodes]
        far = [farthest_single, farthest_dual]
        lcon = [single_last_constraint, dual_last_constraint]
        trackers = (single_tracker, dual_tracker)
        replay_arena_history(
            events, lens, kinds, trackers, far, lcon, cfg,
            creations=creations,
            on_length=lambda length: _extend_active_tables(
                cfg, activate_points, total_active_count, active_min_count,
                length,
            ),
        )
        committed = sum(1 for k, _ in events if k == "commit")
        arena_dual = sum(
            1 for k, a in events if k == "commit" and kinds[a] == 1
        )
        c = scorer.counters
        c["arena_dual_steps"] = c.get("arena_dual_steps", 0) + arena_dual
        c["arena_single_steps"] = (
            c.get("arena_single_steps", 0) + committed - arena_dual
        )

        # extensions of the original nodes first (a split-consumed parent
        # keeps its committed prefix, which its children build on)
        for i, nd in enumerate(nodes):
            if node_steps[i] == 0:
                continue
            s1, s2 = 2 * i, 2 * i + 1
            nd.consensus1 = nd.consensus1 + appended[s1]
            nd.stats1 = sides_stats[s1]
            if nd.is_dual:
                nd.consensus2 = nd.consensus2 + appended[s2]
                nd.stats2 = sides_stats[s2]
            a1 = sides_act[s1]
            a2 = sides_act[s2] if nd.is_dual else None
            for r in range(len(nd.active1)):
                if nd.active1[r] and not bool(a1[r]):
                    nd.active1[r] = False
                    nd.offsets1[r] = None
                if a2 is not None and nd.active2[r] and not bool(a2[r]):
                    nd.active2[r] = False
                    nd.offsets2[r] = None

        # the children created on the device as search nodes, in creation
        # order (a child's parent, possibly itself a child, exists first):
        # the parent side's committed prefix + the pushed symbol + the
        # child's own arena commits; activity from the device rows, which
        # include the divergence pruning at creation
        all_nodes = list(nodes)
        for j, cre in enumerate(creations):
            idx = n_live + j
            parent = all_nodes[cre["parent"]]
            s1, s2 = 2 * idx, 2 * idx + 1
            n = len(parent.active1)
            child = _DualNode()
            child.is_dual = cre["kind"] == 1
            child.h1 = cre["h1"]
            child.consensus1 = (
                parent.consensus1[: cre["created_len"] - 1]
                + bytes([cre["sym1"]]) + appended[s1]
            )
            child.active1 = [bool(a) for a in sides_act[s1][:n]]
            child.offsets1 = [
                parent.offsets1[r] if child.active1[r] else None
                for r in range(n)
            ]
            child.stats1 = sides_stats[s1]
            if child.is_dual:
                from_side1 = not parent.is_dual
                src_off2 = parent.offsets1 if from_side1 else parent.offsets2
                pre2 = (
                    parent.consensus1 if from_side1 else parent.consensus2
                )[: cre["created_len"] - 1]
                child.h2 = cre["h2"]
                child.consensus2 = pre2 + bytes([cre["sym2"]]) + appended[s2]
                child.active2 = [bool(a) for a in sides_act[s2][:n]]
                child.offsets2 = [
                    src_off2[r] if child.active2[r] else None
                    for r in range(n)
                ]
                child.stats2 = sides_stats[s2]
            else:
                child.consensus2 = parent.consensus2
                child.active2 = list(parent.active2)
                child.offsets2 = list(parent.offsets2)
            all_nodes.append(child)

        def on_duplicate(idx, nd):
            # two nodes converged to one key: as every insertion path
            # (_queue_child), drop the newcomer and undo its tracker insert
            logger.warning("duplicate dual search node (arena re-queue)")
            trackers[kinds[idx]].remove(nd.max_consensus_length())
            self._free_node(scorer, nd)

        requeue_arena_nodes(
            pqueue, all_nodes, taken, node_steps, events, cost,
            on_duplicate, alive=alive, n_live=n_live,
        )
        # dead nodes: discards, split-consumed parents and children that
        # died after creation
        for i, nd in enumerate(all_nodes):
            if not alive[i]:
                self._free_node(scorer, nd)
        explored = committed + sum(1 for k, _ in events if k == "split")
        ignored = sum(1 for k, _ in events if k == "discard")
        return far[0], far[1], lcon[0], lcon[1], explored, ignored

    # ==================================================================
    # node life-cycle

    def _free_node(self, scorer: WavefrontScorer, node: _DualNode) -> None:
        if node.h1 is not None:
            scorer.free(node.h1)
        if node.h2 is not None:
            scorer.free(node.h2)
        node.h1 = node.h2 = None
        self._drop_prefetch(scorer, node)

    def _drop_prefetch(self, scorer: WavefrontScorer, node: _DualNode) -> None:
        if node.prefetch is not None:
            _specs, children = node.prefetch
            node.prefetch = None
            for child in children:
                self._free_node(scorer, child)

    def _activate_sequence(self, scorer, node: _DualNode, seq_index: int) -> None:
        cfg = self.config
        sides = [(True, node.consensus1)]
        if node.is_dual:
            sides.append((False, node.consensus2))
        for side1, consensus in sides:
            active = node.active1 if side1 else node.active2
            check_invariant(not active[seq_index], "activating an already-active read")
            offset = scorer.best_activation_offset(
                consensus,
                seq_index,
                cfg.offset_window,
                cfg.offset_compare_length,
                cfg.wildcard,
            )
            handle = node.h1 if side1 else node.h2
            scorer.activate(handle, seq_index, offset, consensus)
            active[seq_index] = True
            if side1:
                node.offsets1[seq_index] = offset
            else:
                node.offsets2[seq_index] = offset
        node.stats1 = scorer.stats(node.h1, node.consensus1)
        if node.is_dual:
            node.stats2 = scorer.stats(node.h2, node.consensus2)

    def _maybe_activate(
        self, scorer, node: _DualNode, activate_points: Dict[int, List[int]]
    ) -> None:
        activate_list = activate_points.get(node.max_consensus_length())
        if activate_list:
            for seq_index in activate_list:
                self._activate_sequence(scorer, node, seq_index)

    def _collect_prune(
        self, node: _DualNode, ed_delta: int, deactivations: List[Tuple[int, int]]
    ) -> None:
        """Drop the clearly-worse wavefront of a read tracked on both sides;
        the scorer deactivations are collected for one batched call."""
        if not node.is_dual:
            return
        for r in range(len(node.active1)):
            if node.active1[r] and node.active2[r]:
                e1 = int(node.stats1.eds[r])
                e2 = int(node.stats2.eds[r])
                if e1 + ed_delta < e2:
                    deactivations.append((node.h2, r))
                    node.active2[r] = False
                    node.offsets2[r] = None
                elif e2 + ed_delta < e1:
                    deactivations.append((node.h1, r))
                    node.active1[r] = False
                    node.offsets1[r] = None

    def _finalize(
        self, scorer, node: _DualNode
    ) -> Tuple[DualConsensus, int]:
        """Finalize a scratch copy of the node, returning the result and its
        total cost; raises when some read was never tracked anywhere."""
        cost = self.config.consensus_cost
        n = len(self.sequences)
        for r in range(n):
            if not node.active1[r] and not (node.is_dual and node.active2[r]):
                raise EngineError(
                    "Finalize called on DWFA that was never initialized."
                )
        fin1 = scorer.finalized_eds(node.h1, node.consensus1)
        fin2 = (
            scorer.finalized_eds(node.h2, node.consensus2)
            if node.is_dual
            else np.zeros(n, dtype=np.int64)
        )
        result, total, _c1, _c2 = build_dual_record(
            cost, n, fin1, fin2, node.active1, node.active2,
            node.consensus1, node.consensus2, node.is_dual,
        )
        return result, total

    def _kernel_exact(self, scorer, nd: _DualNode) -> bool:
        """Host mirror of the arena's split-absorption vote safety (its
        gate in the pop loop): with ``min_af == 0`` only
        the weighted fold is categorically out; otherwise every active
        voting read must be single-tip (the kernels' ``exactable``) and
        no voting read may mix wildcard and non-wildcard tips (that
        leaves a fractional surviving-vote total, which the integer
        mc-table index refuses)."""
        cfg = self.config
        if cfg.weighted_by_ed:
            return False
        if cfg.min_af == 0.0:
            return True
        wc_id = (
            scorer.sym_id.get(cfg.wildcard)
            if cfg.wildcard is not None
            else None
        )
        for active, stats in (
            (nd.active1, nd.stats1),
            (nd.active2, nd.stats2) if nd.is_dual else (None, None),
        ):
            if stats is None:
                continue
            split = stats.split
            nondyadic = (split & (split - 1)) != 0
            voting = np.asarray(active, dtype=bool) & (split > 0)
            if (nondyadic & voting).any():
                return False
            if wc_id is not None:
                mixed = (
                    (stats.occ[:, wc_id] > 0)
                    & (stats.occ.sum(axis=1) > stats.occ[:, wc_id])
                )
                if (mixed & voting).any():
                    return False
        return True

    # ==================================================================
    # expansion

    def _queue_child(
        self, pqueue, tracker, scorer, child: _DualNode, cost
    ) -> None:
        tracker.insert(child.max_consensus_length())
        if not pqueue.push(child.key(), child, child.priority(cost)):
            logger.warning("duplicate dual search node")
            tracker.remove(child.max_consensus_length())
            self._free_node(scorer, child)

    def _gang_attempt(
        self,
        speculator: FrontierSpeculator,
        scorer: WavefrontScorer,
        pqueue: SetPriorityQueue,
        node: _DualNode,
        gang_w: int,
        me_budget: int,
        other_cost: int,
        other_len: int,
        max_steps: int,
        maximum_error: float,
        l2: bool,
    ) -> None:
        """Frontier-parallel speculation for the dual engine: gang the
        in-hand non-dual node's run with the next-best queued non-dual
        branches in one launch (dual nodes step two linked branches,
        which the single-branch gang cannot express; they keep their
        paired kernel).

        The dual engine never forces a first symbol, so peers speculate
        unforced: their deposit commits steps only while the state wins
        the (predicted) pop, the engage rule their own pop applies (see
        ``ConsensusDWFA._gang_attempt`` for how deposits are validated)."""
        cfg = self.config
        members: List[GangMember] = []
        if not speculator.pending(node.h1):
            members.append(GangMember(
                node.h1, node.consensus1, me_budget, other_cost,
                other_len, max_steps, -1,
            ))
        peeked = pqueue.peek_top(gang_w)
        for i, (pn, pprio) in enumerate(peeked):
            if len(members) >= gang_w:
                break
            if pn.is_dual or -pprio[0] > maximum_error:
                continue
            if speculator.pending(pn.h1):
                continue
            specs = (
                pn.prefetch[0] if pn.prefetch is not None
                else self._build_specs(scorer, pn)
            )
            if not (len(specs) == 1 and specs[0][0] == "single"):
                continue
            if i + 1 < len(peeked):
                nxt = peeked[i + 1][1]
                poc, pol = -nxt[0], nxt[1]
            else:
                poc, pol = 2**31 - 1, 0
            members.append(GangMember(
                pn.h1, pn.consensus1, me_budget, poc, pol, max_steps, -1,
            ))
        if len(members) >= 2:
            speculator.gang(members, cfg.min_count, l2)

    def _build_specs(
        self, scorer, node: _DualNode
    ) -> List[Tuple[str, Optional[int], Optional[int]]]:
        """Decide every child of a node as a (kind, sym1, sym2) spec — a
        pure function of the node's stats (so it can run at prefetch time
        with an identical result)."""
        cfg = self.config
        wildcard = cfg.wildcard
        weighted = cfg.weighted_by_ed

        ec1 = node.candidates(True, scorer.symtab, wildcard, weighted)
        min_count1 = max(
            cfg.min_count, math.ceil(cfg.min_af * sum(ec1.values()))
        )
        max_observed1 = max(ec1.values(), default=float(min_count1))
        active_threshold1 = min(float(min_count1), max_observed1)

        specs: List[Tuple[str, Optional[int], Optional[int]]] = []
        if node.is_dual:
            ec2 = node.candidates(False, scorer.symtab, wildcard, weighted)
            min_count2 = max(
                cfg.min_count, math.ceil(cfg.min_af * sum(ec2.values()))
            )
            max_observed2 = max(ec2.values(), default=float(min_count2))
            active_threshold2 = min(float(min_count2), max_observed2)

            is_con1_finalized = node.reached_consensus_end(
                True, cfg.allow_early_termination
            )
            is_con2_finalized = node.reached_consensus_end(
                False, cfg.allow_early_termination
            )

            opt_ec1: List[Optional[int]] = []
            if is_con1_finalized or not ec1 or node.lock1:
                opt_ec1.append(None)
            if not node.lock1:
                opt_ec1.extend(
                    sym
                    for sym in sorted(ec1)
                    if ec1[sym] >= active_threshold1
                )

            opt_ec2: List[Optional[int]] = []
            if is_con2_finalized or not ec2 or node.lock2:
                opt_ec2.append(None)
            if not node.lock2:
                opt_ec2.extend(
                    sym
                    for sym in sorted(ec2)
                    if ec2[sym] >= active_threshold2
                )

            check_invariant(bool(opt_ec1 and opt_ec2), "dual extension option sets non-empty")

            specs.extend(
                ("dual", can1, can2)
                for can1 in opt_ec1
                for can2 in opt_ec2
                # extending neither would duplicate the node
                if not (can1 is None and can2 is None)
            )
        else:
            specs.extend(
                ("single", sym, None)
                for sym in sorted(ec1)
                if ec1[sym] >= active_threshold1
            )
            # dual-split generation: every unordered pair of distinct
            # non-wildcard candidates, when at least two meet min_count1
            sorted_candidates = sorted(
                ((-count, sym) for sym, count in ec1.items() if sym != wildcard)
            )
            num_passing = sum(
                1 for negc, _sym in sorted_candidates if -negc >= min_count1
            )
            if num_passing > 1:
                specs.extend(
                    ("split", c1, c2)
                    for i, (_nc1, c1) in enumerate(sorted_candidates)
                    for _nc2, c2 in sorted_candidates[i + 1 :]
                )
        return specs

    def _materialize_expansions(
        self, scorer, nodes: List[_DualNode]
    ) -> None:
        """Build every listed node's children with one batched clone+push
        dispatch across all of them (or one clone plus one push dispatch),
        storing ``(specs, children)`` on each node's ``prefetch``."""
        per_node_specs = [self._build_specs(scorer, node) for node in nodes]
        clone_push = fast_paths(scorer).clone_push_many

        #: batched-path bookkeeping: (src_handle, consensus|None) per
        #: cloned side, plus where to deliver the resulting (handle, stats)
        fused_specs: List[Tuple[int, Optional[bytes], bool]] = []
        fused_targets: List[Tuple[_DualNode, bool]] = []
        #: clone-then-push bookkeeping
        clone_srcs: List[int] = []
        push_specs: List[Tuple[int, bytes]] = []
        push_targets: List[Tuple[_DualNode, bool]] = []

        def check_lock(child: _DualNode, side1: bool) -> None:
            if side1 and child.lock1:
                raise EngineError("Consensus 1 is locked, cannot modify")
            if not side1 and child.lock2:
                raise EngineError("Consensus 2 is locked, cannot modify")

        def fused_side(child, src_handle, sym, side1) -> None:
            """Register one cloned side: push ``sym`` onto it (None =
            clone only); handle+stats assigned after the batched call."""
            if sym is not None:
                check_lock(child, side1)
                if side1:
                    child.consensus1 = child.consensus1 + bytes([sym])
                else:
                    child.consensus2 = child.consensus2 + bytes([sym])
            fused_specs.append(
                (
                    src_handle,
                    (child.consensus1 if side1 else child.consensus2)
                    if sym is not None
                    else None,
                    False,
                )
            )
            fused_targets.append((child, side1))

        if clone_push is None:
            for node, specs in zip(nodes, per_node_specs):
                for kind, _a, _b in specs:
                    if kind == "dual":
                        clone_srcs += [node.h1, node.h2]
                    elif kind == "single":
                        clone_srcs += [node.h1]
                    else:  # split: both sides start from consensus1
                        clone_srcs += [node.h1, node.h1]
            handles = scorer.clone_many(clone_srcs)
        hi = 0

        def queue_push(child: _DualNode, sym: int, side1: bool) -> None:
            check_lock(child, side1)
            if side1:
                child.consensus1 = child.consensus1 + bytes([sym])
                push_specs.append((child.h1, child.consensus1))
            else:
                child.consensus2 = child.consensus2 + bytes([sym])
                push_specs.append((child.h2, child.consensus2))
            push_targets.append((child, side1))

        for node, specs in zip(nodes, per_node_specs):
            children: List[_DualNode] = []
            for kind, a, b in specs:
                child = _DualNode()
                child.consensus1 = node.consensus1
                child.active1 = list(node.active1)
                child.offsets1 = list(node.offsets1)
                child.stats1 = node.stats1
                if kind == "dual":
                    child.is_dual = True
                    child.lock1 = node.lock1
                    child.lock2 = node.lock2
                    child.consensus2 = node.consensus2
                    child.active2 = list(node.active2)
                    child.offsets2 = list(node.offsets2)
                    child.stats2 = node.stats2
                    if clone_push is not None:
                        fused_side(child, node.h1, a, True)
                        fused_side(child, node.h2, b, False)
                        if a is None:
                            child.lock1 = True
                        if b is None:
                            child.lock2 = True
                    else:
                        child.h1, child.h2 = handles[hi], handles[hi + 1]
                        hi += 2
                        if a is not None:
                            queue_push(child, a, True)
                        else:
                            child.lock1 = True
                        if b is not None:
                            queue_push(child, b, False)
                        else:
                            child.lock2 = True
                elif kind == "single":
                    child.consensus2 = node.consensus2
                    child.active2 = list(node.active2)
                    child.offsets2 = list(node.offsets2)
                    if clone_push is not None:
                        fused_side(child, node.h1, a, True)
                    else:
                        child.h1 = handles[hi]
                        hi += 1
                        queue_push(child, a, True)
                else:  # split
                    check_invariant(a != b, "dual split needs distinct symbols")
                    child.is_dual = True
                    child.consensus2 = node.consensus1
                    child.active2 = list(node.active1)
                    child.offsets2 = list(node.offsets1)
                    child.stats2 = node.stats1
                    if clone_push is not None:
                        fused_side(child, node.h1, a, True)
                        fused_side(child, node.h1, b, False)
                    else:
                        child.h1, child.h2 = handles[hi], handles[hi + 1]
                        hi += 2
                        queue_push(child, a, True)
                        queue_push(child, b, False)
                children.append(child)
            node.prefetch = (specs, children)

        if clone_push is not None:
            for (child, side1), (handle, stats) in zip(
                fused_targets, clone_push(fused_specs)
            ):
                if side1:
                    child.h1 = handle
                    if stats is not None:
                        child.stats1 = stats
                else:
                    child.h2 = handle
                    if stats is not None:
                        child.stats2 = stats
        else:
            for (child, side1), stats in zip(
                push_targets, scorer.push_many(push_specs)
            ):
                if side1:
                    child.stats1 = stats
                else:
                    child.stats2 = stats

    def _expand(
        self,
        scorer,
        node: _DualNode,
        activate_points,
        pqueue,
        single_tracker,
        dual_tracker,
        cost,
        audit=None,
        audit_ctx=None,
    ) -> None:
        cfg = self.config

        if node.prefetch is None:
            peers = [
                n
                for n, _p in pqueue.peek_top(cfg.prefetch_width - 1)
                if n.prefetch is None
            ]
            self._materialize_expansions(scorer, [node] + peers)
        specs, children = node.prefetch
        node.prefetch = None
        if audit is not None and audit_ctx is not None:
            record = dict(audit_ctx)
            record["specs"] = [
                [
                    kind,
                    None if a is None else int(a),
                    None if b is None else int(b),
                ]
                for kind, a, b in specs
            ]
            audit.emit(record)

        # -- finishing (pop time): activations, batched pruning, queueing
        deactivations: List[Tuple[int, int]] = []
        for child in children:
            self._maybe_activate(scorer, child, activate_points)
            self._collect_prune(child, cfg.dual_max_ed_delta, deactivations)
        scorer.deactivate_many(deactivations)

        for (kind, _a, _b), child in zip(specs, children):
            if kind == "single":
                check_invariant(not child.is_dual, "single child stays single")
                self._queue_child(pqueue, single_tracker, scorer, child, cost)
            else:
                check_invariant(child.is_dual, "dual child stays dual")
                self._queue_child(pqueue, dual_tracker, scorer, child, cost)
