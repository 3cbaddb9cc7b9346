"""Multi-consensus result type: a set of consensuses and the one each read
was assigned to (the algorithm it once belonged to is superseded by the
priority engine).  The port of ``waffle_con_tpu``'s
``models/multi_consensus.py``."""

from __future__ import annotations

from typing import List

from waffle_con_tpu_torch.models.consensus import Consensus


class MultiConsensus:
    """A set of consensuses plus, per input read, the index of the
    consensus it was assigned to.  Construction sorts the consensuses
    lexicographically and remaps the indices to match."""

    __slots__ = ("consensuses", "sequence_indices")

    def __init__(
        self, consensuses: List[Consensus], sequence_indices: List[int]
    ) -> None:
        order = sorted(range(len(consensuses)), key=lambda i: consensuses[i].sequence)
        reverse_lookup = [0] * len(consensuses)
        for new_index, old_index in enumerate(order):
            reverse_lookup[old_index] = new_index
        self.consensuses = [consensuses[i] for i in order]
        self.sequence_indices = [reverse_lookup[i] for i in sequence_indices]

    def __eq__(self, rhs) -> bool:
        return (
            isinstance(rhs, MultiConsensus)
            and self.consensuses == rhs.consensuses
            and self.sequence_indices == rhs.sequence_indices
        )

    def __repr__(self) -> str:
        return (
            f"MultiConsensus(consensuses={self.consensuses!r}, "
            f"sequence_indices={self.sequence_indices})"
        )
