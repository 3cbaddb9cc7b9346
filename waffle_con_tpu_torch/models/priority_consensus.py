"""Priority / multi consensus via recursive dual splits.

Each input read is a *chain* of sequences (e.g. ``[hpc_compressed,
full_length]``).  A worklist of read groups is repeatedly solved with the
dual engine at the group's current chain level: a dual result partitions
the group (same level), a single result fixes that level's consensus and
advances the chain — a binary splitting tree whose leaves are the final
consensus chains.

The port of ``waffle_con_tpu``'s ``models/priority_consensus.py``: the
same worklist, byte for byte.  On the ``"torch"`` backend one
:class:`~waffle_con_tpu_torch.ops.torch_scorer.TorchScorer` is built per
chain level and shared by every group at that level through
:class:`~waffle_con_tpu_torch.ops.scorer.SubsetScorer` views, so the
reads are uploaded once per level and the run kernels of every group
launch over the same branch store.

Example::

    from waffle_con_tpu_torch import CdwfaConfigBuilder, PriorityConsensusDWFA

    engine = PriorityConsensusDWFA(CdwfaConfigBuilder().backend("torch").build())
    for chain in chains:            # chain: [seq_level0, seq_level1, ...]
        engine.add_sequence_chain(chain)
    result = engine.consensus()
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Set, Tuple

from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models import checkpoint as ckpt_mod
from waffle_con_tpu_torch.models.consensus import (
    PROGRESS_LOG_INTERVAL,
    Consensus,
    EngineError,
    check_invariant,
)
from waffle_con_tpu_torch.models.dual_consensus import DualConsensusDWFA
from waffle_con_tpu_torch.obs import audit as obs_audit
from waffle_con_tpu_torch.obs import metrics as obs_metrics
from waffle_con_tpu_torch.obs.report import run_reported_search as _reported_search
from waffle_con_tpu_torch.ops.scorer import (
    SubsetScorer,
    WavefrontScorer,
    make_scorer,
)
from waffle_con_tpu_torch.runtime.watchdog import enforce_dispatch_budget

logger = logging.getLogger(__name__)


class PriorityConsensus:
    """Final result: one consensus chain per discovered group, plus the
    group index each input read was assigned to."""

    __slots__ = ("consensuses", "sequence_indices")

    def __init__(
        self,
        consensuses: List[List[Consensus]],
        sequence_indices: List[int],
    ) -> None:
        self.consensuses = consensuses
        self.sequence_indices = sequence_indices

    def __eq__(self, rhs) -> bool:
        return (
            isinstance(rhs, PriorityConsensus)
            and self.consensuses == rhs.consensuses
            and self.sequence_indices == rhs.sequence_indices
        )

    def __repr__(self) -> str:
        return (
            f"PriorityConsensus(consensuses={self.consensuses!r}, "
            f"sequence_indices={self.sequence_indices})"
        )


class PriorityConsensusDWFA:
    """Multi-consensus generation by iterated dual splitting over sequence
    chains."""

    def __init__(self, config: Optional[CdwfaConfig] = None) -> None:
        self.config = config if config is not None else CdwfaConfig()
        self.sequences: List[List[bytes]] = []
        self.offsets: List[List[Optional[int]]] = []
        self.seed_groups: List[Optional[int]] = []
        self.alphabet: set = set()

    @classmethod
    def with_config(cls, config: CdwfaConfig) -> "PriorityConsensusDWFA":
        return cls(config)

    def add_sequence_chain(self, sequences: List[bytes]) -> None:
        self.add_seeded_sequence_chain(
            sequences, [None] * len(sequences), None
        )

    def add_seeded_sequence_chain(
        self,
        sequences: List[bytes],
        offsets: List[Optional[int]],
        seed_group: Optional[int],
    ) -> None:
        if not sequences:
            raise EngineError("Must provide a non-empty sequences Vec")
        if self.sequences and len(self.sequences[0]) != len(sequences):
            raise EngineError(
                f"Expected sequences Vec of length {len(self.sequences[0])}, "
                f"but got one of length {len(sequences)}"
            )
        sequences = [bytes(s) for s in sequences]
        for sequence in sequences:
            self.alphabet.update(sequence)
        if self.config.wildcard is not None:
            self.alphabet.discard(self.config.wildcard)
        self.sequences.append(sequences)
        self.offsets.append(list(offsets))
        self.seed_groups.append(seed_group)

    @property
    def consensus_cost(self) -> ConsensusCost:
        return self.config.consensus_cost

    # ------------------------------------------------------------------

    def consensus(self) -> PriorityConsensus:
        """Run the worklist; search-shape counters, summed over the inner
        dual-engine group solves, land in ``self.last_search_stats``, the
        aggregated :class:`~waffle_con_tpu_torch.obs.report.SearchReport`
        in ``self.last_search_report``."""
        return _reported_search(self, "priority", self._consensus_impl)

    def _consensus_impl(self) -> PriorityConsensus:
        restore = getattr(self, "_restore_state", None)
        self._restore_state = None
        max_split_level = len(self.sequences[0])
        to_split: List[List[bool]] = []
        split_levels: List[int] = []
        consensus_chains: List[List[Consensus]] = []

        if restore is None:
            # one initial group per distinct seed (deterministic order)
            initial_group_keys: Set[Optional[int]] = set(self.seed_groups)
            for igk in sorted(
                initial_group_keys, key=lambda k: (k is not None, k)
            ):
                to_split.append([sg == igk for sg in self.seed_groups])
                split_levels.append(0)
                consensus_chains.append([])

        consensuses: List[List[Consensus]] = []
        assignments: List[List[bool]] = []
        # one device scorer per chain level, shared by every worklist
        # group at that level through a SubsetScorer view (a group is its
        # root activation mask): the reads go to the device once per
        # level, not once per group
        level_scorers: Dict[int, WavefrontScorer] = {}
        merged_counters: Dict[str, int] = {}
        last_backend: Optional[str] = None
        groups: List[Dict] = []
        scorer_constructions = 0
        total_explored = 0
        total_ignored = 0
        peak_queue_size = 0
        share_scorer = self.config.backend == "torch"
        groups_solved = 0
        pending: Optional[Tuple] = None
        if restore is not None:
            (to_split, split_levels, consensus_chains, consensuses,
             assignments, merged_counters, scorer_constructions,
             total_explored, total_ignored, peak_queue_size,
             groups_solved, pending) = self._restore_worklist(restore)

        ctrl = ckpt_mod.current_controller()
        #: decision audit sink (``None`` when no capture is installed);
        #: the worklist emits one ``group`` marker per group solve — the
        #: inner dual searches record their own per-pop streams
        audit = obs_audit.search_sink("priority")
        include_set: List[bool] = []
        current_split_level = 0
        current_chain: List[Consensus] = []

        def _wrap_body(inner_body: Dict) -> Dict:
            # a closure over the worklist locals, called by the
            # controller while the inner dual solve is mid-search: the
            # popped (in-flight) group travels as ``current`` with the
            # inner dual state embedded, the rest of the worklist and
            # the accumulators as they are
            enc = self._encode_consensus
            return {
                "kind": "priority",
                "config": ckpt_mod.encode_config_dict(self.config),
                "chains": [[ckpt_mod.b64(s) for s in chain]
                           for chain in self.sequences],
                "offsets": [[o if o is None else int(o) for o in chain]
                            for chain in self.offsets],
                "seed_groups": [
                    sg if sg is None else int(sg)
                    for sg in self.seed_groups
                ],
                "state": {
                    "to_split": [[1 if x else 0 for x in row]
                                 for row in to_split],
                    "split_levels": [int(l) for l in split_levels],
                    "consensus_chains": [[enc(c) for c in chain]
                                         for chain in consensus_chains],
                    "consensuses": [[enc(c) for c in chain]
                                    for chain in consensuses],
                    "assignments": [[1 if x else 0 for x in row]
                                    for row in assignments],
                    "merged_counters": {str(k): int(v) for k, v
                                        in merged_counters.items()},
                    "scorer_constructions": int(scorer_constructions),
                    "total_explored": int(total_explored),
                    "total_ignored": int(total_ignored),
                    "peak_queue_size": int(peak_queue_size),
                    "groups_solved": int(groups_solved),
                    "current": {
                        "include_set": [1 if x else 0
                                        for x in include_set],
                        "split_level": int(current_split_level),
                        "chain": [enc(c) for c in current_chain],
                    },
                    "inner": inner_body["state"],
                },
            }

        while to_split or pending is not None:
            if pending is not None:
                # the group in flight when the checkpoint was taken;
                # groups_solved already counted it at the original pop
                (include_set, current_split_level, current_chain,
                 inner_state) = pending
                pending = None
            else:
                include_set = to_split.pop()
                current_split_level = split_levels.pop()
                current_chain = consensus_chains.pop()
                inner_state = None
                groups_solved += 1
            if groups_solved % PROGRESS_LOG_INTERVAL == 0:
                logger.debug(
                    "search progress: %d groups solved, worklist=%d, "
                    "level=%d", groups_solved, len(to_split),
                    current_split_level,
                )
                if obs_metrics.metrics_enabled():
                    obs_metrics.registry().gauge(
                        "waffle_search_queue_depth", engine="priority"
                    ).set(len(to_split))

            if audit is not None:
                # one marker per group solve: the worklist's decision
                # unit (the inner dual search emits its own per-pop
                # records through its own sink)
                audit.emit({
                    "kind": "group", "pop": groups_solved,
                    "level": current_split_level,
                    "include": obs_audit.active_digest(
                        i for i, inc in enumerate(include_set) if inc
                    ),
                    "size": sum(1 for inc in include_set if inc),
                })

            injected = None
            base = None
            if share_scorer:
                base = level_scorers.get(current_split_level)
                if base is None:
                    base = make_scorer(
                        [chain[current_split_level] for chain in self.sequences],
                        self.config,
                    )
                    level_scorers[current_split_level] = base
                    scorer_constructions += 1
                indices = [i for i, inc in enumerate(include_set) if inc]
                injected = SubsetScorer(base, indices)
            else:
                scorer_constructions += 1  # the dual engine builds its own
            dc_dwfa = DualConsensusDWFA(self.config, scorer=injected)
            logger.debug(
                "Calling Dual at level %d with: %s", current_split_level, include_set
            )
            for include, (seq_chain, offset_chain) in zip(
                include_set, zip(self.sequences, self.offsets)
            ):
                if include:
                    dc_dwfa.add_sequence_offset(
                        seq_chain[current_split_level],
                        offset_chain[current_split_level],
                    )

            if inner_state is not None:
                dc_dwfa._restore_state = {"state": inner_state, "extra": 0}
            if ctrl is not None:
                ctrl.push_wrapper(_wrap_body)
            try:
                dc_result = dc_dwfa.consensus()
            finally:
                if ctrl is not None:
                    ctrl.pop_wrapper()
                    self._last_checkpoint = ctrl.last_checkpoint
            inner_stats = dc_dwfa.last_search_stats
            last_backend = inner_stats["backend"]
            for k, v in inner_stats["scorer_counters"].items():
                merged_counters[k] = merged_counters.get(k, 0) + v
            total_explored += inner_stats["nodes_explored"]
            total_ignored += inner_stats["nodes_ignored"]
            peak_queue_size = max(peak_queue_size, inner_stats["peak_queue_size"])
            if len(dc_result) > 1:
                logger.debug(
                    "Multiple dual consensuses detected, arbitrarily selecting "
                    "first option."
                )
            chosen = dc_result[0]
            groups.append({
                "level": current_split_level,
                "size": sum(1 for inc in include_set if inc),
                "dual": chosen.is_dual(),
                "nodes_explored": inner_stats["nodes_explored"],
                "nodes_ignored": inner_stats["nodes_ignored"],
                "scorer_counters": inner_stats["scorer_counters"],
                # branch handles the shared scorer still holds after the
                # solve (None where each group has a scorer of its own)
                "live_handles": None if base is None else base.live_handles(),
            })
            # the view holds the level's scorer: drop it before eviction
            dc_dwfa = injected = base = None

            if chosen.is_dual():
                # partition the group by assignment; both halves re-split at
                # the same chain level
                is_c1 = chosen.is_consensus1
                assign1 = [False] * len(self.sequences)
                assign2 = [False] * len(self.sequences)
                ic_index = 0
                for i, included in enumerate(include_set):
                    if included:
                        if is_c1[ic_index]:
                            assign1[i] = True
                        else:
                            assign2[i] = True
                        ic_index += 1
                check_invariant(ic_index == len(is_c1), "assignment vector fully consumed")

                to_split.append(assign1)
                split_levels.append(current_split_level)
                consensus_chains.append(list(current_chain))
                to_split.append(assign2)
                split_levels.append(current_split_level)
                consensus_chains.append(current_chain)
            else:
                new_split_level = current_split_level + 1
                current_chain.append(chosen.consensus1)
                if new_split_level == max_split_level:
                    consensuses.append(current_chain)
                    assignments.append(include_set)
                else:
                    to_split.append(include_set)
                    split_levels.append(new_split_level)
                    consensus_chains.append(current_chain)

            # evict shared scorers no pending group can reach (a group's
            # level only increases), which frees their device tensors
            alive = set(split_levels)
            for lvl in [l for l in level_scorers if l not in alive]:
                del level_scorers[lvl]

        #: merged per-group scorer-counter deltas; scorer_constructions is
        #: the per-consensus() count the sharing keeps to one per level;
        #: search-shape numbers are summed (peak: max) over the group
        #: solves, and ``groups`` holds one record per solve of this call
        #: in order (a resumed search: the solves after the checkpoint)
        self.last_search_stats = {
            "scorer_counters": merged_counters,
            "scorer_constructions": scorer_constructions,
            "nodes_explored": total_explored,
            "nodes_ignored": total_ignored,
            "peak_queue_size": peak_queue_size,
            "backend": last_backend or self.config.backend,
            "groups": groups,
        }
        enforce_dispatch_budget(self.config, merged_counters, "priority")

        if len(consensuses) > 1:
            indices = [-1] * len(self.sequences)
            order = sorted(
                range(len(consensuses)),
                key=lambda i: [c.sequence for c in consensuses[i]],
            )
            sorted_cons = []
            for con_index, old_index in enumerate(order):
                for i, assigned in enumerate(assignments[old_index]):
                    if assigned:
                        check_invariant(indices[i] == -1, "sequence index remapped once")
                        indices[i] = con_index
                sorted_cons.append(consensuses[old_index])
            return PriorityConsensus(sorted_cons, indices)
        return PriorityConsensus(consensuses, [0] * len(self.sequences))

    # -- checkpoint / resume -------------------------------------------

    def snapshot(self) -> Optional["ckpt_mod.SearchCheckpoint"]:
        """The most recent :class:`SearchCheckpoint` built for this
        engine's search (by the installed
        :class:`~waffle_con_tpu_torch.models.checkpoint.CheckpointController`),
        or ``None`` — survives a preempted/expired search."""
        return getattr(self, "_last_checkpoint", None)

    @staticmethod
    def _encode_consensus(c: Consensus) -> Dict:
        return {
            "sequence": ckpt_mod.b64(c.sequence),
            "scores": [int(s) for s in c.scores],
        }

    def _decode_consensus(self, obj: Dict) -> Consensus:
        return Consensus(
            ckpt_mod.unb64(obj["sequence"]),
            self.config.consensus_cost,
            [int(s) for s in obj["scores"]],
        )

    def _restore_worklist(self, restore):
        """Rebuild the worklist state captured by the checkpoint
        wrapper in :meth:`_consensus_impl`; the in-flight group comes
        back as ``pending`` with its embedded inner dual state, which
        the loop re-enters through
        :meth:`DualConsensusDWFA._restore_search`."""
        st = restore["state"]
        dec = self._decode_consensus
        try:
            cur = st["current"]
            pending = (
                [bool(x) for x in cur["include_set"]],
                int(cur["split_level"]),
                [dec(c) for c in cur["chain"]],
                st["inner"],
            )
            if (len(pending[0]) != len(self.sequences)
                    or not isinstance(st["inner"], dict)):
                raise ckpt_mod.CheckpointRejected(
                    "worklist group size mismatch vs checkpoint chains"
                )
            return (
                [[bool(x) for x in row] for row in st["to_split"]],
                [int(l) for l in st["split_levels"]],
                [[dec(c) for c in chain]
                 for chain in st["consensus_chains"]],
                [[dec(c) for c in chain] for chain in st["consensuses"]],
                [[bool(x) for x in row] for row in st["assignments"]],
                {str(k): int(v)
                 for k, v in st["merged_counters"].items()},
                int(st["scorer_constructions"]),
                int(st["total_explored"]),
                int(st["total_ignored"]),
                int(st["peak_queue_size"]),
                int(st["groups_solved"]),
                pending,
            )
        except ckpt_mod.CheckpointError:
            raise
        except (KeyError, TypeError, ValueError, AttributeError) as exc:
            raise ckpt_mod.CheckpointRejected(
                f"malformed priority-engine checkpoint state: {exc}"
            ) from None

    @classmethod
    def resume(
        cls, checkpoint, extra_reads=()
    ) -> "PriorityConsensusDWFA":
        """An engine primed to continue ``checkpoint`` (a
        :class:`SearchCheckpoint` or its wire-dict form); run
        :meth:`consensus` on it to finish the search byte-identically.
        ``extra_reads`` must be empty: chain levels fix the read set
        (stream new reads through the single/dual engines instead)."""
        if tuple(extra_reads):
            raise ckpt_mod.CheckpointRejected(
                "extra_reads are not supported for the priority engine "
                "(sequence chains fix the read set at every level)"
            )
        body = ckpt_mod.resume_body(checkpoint, "priority")
        try:
            config = ckpt_mod.decode_config_dict(body["config"])
            chains = [[ckpt_mod.unb64(s) for s in chain]
                      for chain in body["chains"]]
            offsets = [[o if o is None else int(o) for o in chain]
                       for chain in body["offsets"]]
            seed_groups = [sg if sg is None else int(sg)
                           for sg in body["seed_groups"]]
            state = body["state"]
            if (not isinstance(state, dict)
                    or len(chains) != len(offsets)
                    or len(chains) != len(seed_groups)):
                raise ckpt_mod.CheckpointRejected(
                    "malformed priority-engine checkpoint body"
                )
        except ckpt_mod.CheckpointError:
            raise
        except (KeyError, TypeError, ValueError) as exc:
            raise ckpt_mod.CheckpointRejected(
                f"malformed priority-engine checkpoint body: {exc}"
            ) from None
        engine = cls(config)
        for chain, offset_chain, seed_group in zip(
            chains, offsets, seed_groups
        ):
            engine.add_seeded_sequence_chain(
                chain, offset_chain, seed_group
            )
        engine._restore_state = {"state": state}
        return engine
