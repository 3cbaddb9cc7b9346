"""Loaders for the JSON scenario fixtures in ``tests/data``.

The first zero-edit record per consensus id is the ground-truth consensus
(optionally also fed back in as a read); the ``edits`` column gives the
expected per-read distances (squared under L2).  The port of
``waffle_con_tpu``'s ``utils/fixtures.py``: both packages read the same
files.
"""

from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional, Tuple

from waffle_con_tpu_torch.config import ConsensusCost
from waffle_con_tpu_torch.models.consensus import Consensus
from waffle_con_tpu_torch.models.dual_consensus import DualConsensus
from waffle_con_tpu_torch.models.priority_consensus import PriorityConsensus

DATA_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "tests" / "data"


#: every fixture as a priority-engine scenario: ``(name,
#: include_consensus, config fields)``, each with the wildcard ``*``.  Ten
#: are the priority engine's own scenarios; the two dual-only fixtures
#: take the settings of their dual-engine scenarios.
PRIORITY_SCENARIOS: List[Tuple[str, bool, Dict]] = [
    ("dual_001", True, {}),
    ("dual_early_termination_001", True, {"allow_early_termination": True}),
    ("length_gap_001", False, {
        "min_count": 2, "dual_max_ed_delta": 5, "max_queue_size": 1000,
        "consensus_cost": ConsensusCost.L2_DISTANCE,
    }),
    ("multi_err_001", False, {}),
    ("multi_err_002", False, {}),
    ("multi_exact_001", True, {}),
    ("multi_exact_002", True, {}),
    ("multi_postcon_001", True, {"min_count": 2}),
    ("multi_samesplit_001", True, {}),
    ("priority_001", True, {}),
    ("priority_002", True, {}),
    ("priority_003", True, {}),
]


def _load_records(name: str):
    with open(DATA_DIR / f"{name}.json") as fh:
        return json.load(fh)["records"]


def load_dual_fixture(
    name: str, include_consensus: bool, cost_mode: ConsensusCost
) -> Tuple[List[bytes], DualConsensus]:
    """Returns ``(sequences, expected DualConsensus)``; the expected score
    vectors are unset (equality ignores them)."""
    sequences: List[bytes] = []
    is_consensus1: List[bool] = []
    ed1: List[int] = []
    ed2: List[int] = []
    con1: Optional[bytes] = None
    con2: Optional[bytes] = None

    for record in _load_records(name):
        is_con1 = record["consensus"] == 1
        edits = cost_mode.apply(record["edits"])
        sequence = record["chain"][0].encode()

        if is_con1:
            if con1 is None and edits == 0:
                con1 = sequence
                if not include_consensus:
                    continue
            ed1.append(edits)
        else:
            if con2 is None and edits == 0:
                con2 = sequence
                if not include_consensus:
                    continue
            ed2.append(edits)
        is_consensus1.append(is_con1)
        sequences.append(sequence)

    if con1 is None or (con2 is not None and not con1 < con2):
        raise ValueError(f"fixture {name!r}: consensus 1 missing or not first")
    consensus1 = Consensus(con1, cost_mode, ed1)
    consensus2 = Consensus(con2, cost_mode, ed2) if con2 is not None else None
    expected = DualConsensus(
        consensus1,
        consensus2,
        is_consensus1,
        [None] * len(sequences),
        [None] * len(sequences),
    )
    return sequences, expected


def load_priority_fixture(
    name: str, include_consensus: bool, cost_mode: ConsensusCost
) -> Tuple[List[List[bytes]], PriorityConsensus]:
    """Returns ``(sequence_chains, expected PriorityConsensus)``; expected
    chain scores are unset (compare sequences and assignments)."""
    consensuses: List[List[bytes]] = []
    sequence_chains: List[List[bytes]] = []
    sequence_indices: List[int] = []

    for record in _load_records(name):
        if record["consensus"] < 1:
            raise ValueError(f"fixture {name!r}: consensus ids start at 1")
        con_index = record["consensus"] - 1
        edits = cost_mode.apply(record["edits"])
        chain = [s.encode() for s in record["chain"]]

        while con_index >= len(consensuses):
            consensuses.append([])
        if edits == 0 and not consensuses[con_index]:
            consensuses[con_index] = chain
            if not include_consensus:
                continue
        sequence_chains.append(chain)
        sequence_indices.append(con_index)

    if not all(consensuses) or not sequence_chains:
        raise ValueError(f"fixture {name!r}: a consensus without a zero-edit record")

    # remap consensus ids into lexicographic chain order
    order = sorted(range(len(consensuses)), key=lambda i: consensuses[i])
    lookup = [0] * len(consensuses)
    for new_index, old_index in enumerate(order):
        lookup[old_index] = new_index
    consensuses = [consensuses[i] for i in order]
    sequence_indices = [lookup[i] for i in sequence_indices]

    expected = PriorityConsensus(
        [
            [Consensus(c, cost_mode, []) for c in chain]
            for chain in consensuses
        ],
        sequence_indices,
    )
    return sequence_chains, expected
