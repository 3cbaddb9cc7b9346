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
from typing import Dict, List, Optional, Set

from waffle_con_tpu_torch.config import CdwfaConfig, ConsensusCost
from waffle_con_tpu_torch.models.consensus import (
    PROGRESS_LOG_INTERVAL,
    Consensus,
    EngineError,
    check_invariant,
)
from waffle_con_tpu_torch.models.dual_consensus import DualConsensusDWFA
from waffle_con_tpu_torch.ops.scorer import (
    SubsetScorer,
    WavefrontScorer,
    make_scorer,
)

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
        dual-engine group solves, land in ``self.last_search_stats``."""
        return self._consensus_impl()

    def _consensus_impl(self) -> PriorityConsensus:
        max_split_level = len(self.sequences[0])
        to_split: List[List[bool]] = []
        split_levels: List[int] = []
        consensus_chains: List[List[Consensus]] = []

        # one initial group per distinct seed (deterministic order)
        initial_group_keys: Set[Optional[int]] = set(self.seed_groups)
        for igk in sorted(initial_group_keys, key=lambda k: (k is not None, k)):
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
        groups: List[Dict] = []
        scorer_constructions = 0
        total_explored = 0
        total_ignored = 0
        peak_queue_size = 0
        share_scorer = self.config.backend == "torch"

        while to_split:
            include_set = to_split.pop()
            current_split_level = split_levels.pop()
            current_chain = consensus_chains.pop()
            if (len(groups) + 1) % PROGRESS_LOG_INTERVAL == 0:
                logger.debug(
                    "search progress: %d groups solved, worklist=%d, "
                    "level=%d", len(groups) + 1, len(to_split),
                    current_split_level,
                )

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

            dc_result = dc_dwfa.consensus()
            inner_stats = dc_dwfa.last_search_stats
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
        #: solves, and ``groups`` holds one record per solve in order
        self.last_search_stats = {
            "scorer_counters": merged_counters,
            "scorer_constructions": scorer_constructions,
            "nodes_explored": total_explored,
            "nodes_ignored": total_ignored,
            "peak_queue_size": peak_queue_size,
            "backend": self.config.backend,
            "groups": groups,
        }

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
